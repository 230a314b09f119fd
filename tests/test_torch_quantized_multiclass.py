"""Quantized-gradient training of multiclass (softmax here, one-vs-all
in test_torch_quantized_ova.py; 5 classes, 2 iterations) against the
JAX package, held split for split (test_torch_quantized_trees.py
``compare``).  The JAX package takes its eager iteration there, so the
port draws the ``quant_rng`` chain once a class tree, at each row's
original id, and bags as that iteration does.

In the first iteration the class priors give every row of a class one
gradient value, so after quantization candidates of equal integer sums
tie exactly: softmax from its defaults meets one at class tree 3 split
10 (``TIES``, ROADMAP section C).  With a seeded ``init_score`` the
gradients vary by row and every tree agrees.
"""

import numpy as np
import pytest

from test_torch_quantized_trees import (check, compare, example, train_jax,
                                        train_port)
from torch_one_thread import one_torch_thread  # noqa: F401

CASES = {"softmax": False, "softmax_init": True}
TIES = {"softmax": (3, 10)}


def train_both(params, seeded):
    """Both packages' boosters (2 iterations, the port's on the CPU) and
    the port's carriers; ``seeded``: a seeded ``init_score``."""
    X, y = example("multiclass_classification/multiclass.train")
    kw = {}
    if seeded:
        kw["init_score"] = np.random.RandomState(1).normal(
            scale=0.3, size=len(y) * 5)
    jb = train_jax(X, y, params, rounds=2, **kw)
    tb, rec = train_port(X, y, params, rounds=2, **kw)
    assert tb._gbdt._eager_quant and len(rec) == 10
    return X, jb, tb, rec


@pytest.mark.parametrize("case", sorted(CASES))
def test_multiclass_trees_match_jax(case):
    params = dict(objective="multiclass", num_class=5)
    X, jb, tb, rec = train_both(params, CASES[case])
    assert tb._gbdt.learner.K == 1
    if case in TIES:
        assert compare(X, jb, tb, rec, params) == TIES[case]
    else:
        check(X, jb, tb, rec, params)
