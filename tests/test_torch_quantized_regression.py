"""Quantized-gradient training on ``examples/regression`` (the L2
objective, whose constant hessians become integer ones): the port's
three bodies, with ``quant_train_renew_leaf`` off and on, against the
JAX package, held split for split (test_torch_quantized_trees.py
``compare``).
"""

import pytest

from test_torch_quantized_trees import (BODIES, check, example, run_bodies,
                                        train_port)
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_boosters():
    return {}


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("renew", [False, True], ids=["plain", "renew"])
def test_regression_trees_match_jax(body, renew, jax_boosters):
    X, y = example("regression/regression.train")
    params, jb = run_bodies(X, y, "regression", renew, jax_boosters)
    tb, rec = train_port(X, y, dict(params, **BODIES[body]))
    assert tb._gbdt.learner.K == (4 if body == "mega_k4" else 1)
    check(X, jb, tb, rec, params)
