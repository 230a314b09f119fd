"""Monotone constraints with the port's training options, against the
JAX package on the CPU (``tests/test_torch_monotone_trees.py``'s
``check``: trees split for split, leaf values rtol 1e-4 / atol 1e-5, raw
predictions atol 1e-5, model text both ways, and the monotonicity sweep
of the port's model):

  * quantized gradients (``use_quantized_grad``), without and with
    ``quant_train_renew_leaf``: the renewal recomputes each leaf's value
    from the true gradients without the leaf's bounds, in the JAX
    package as in the port, so its model is not held to the sweep;
  * bagging with ``feature_fraction`` (the device feature mask, which
    the refresh's re-search reads too);
  (the L1-family renewal and 3-class multiclass are
  tests/test_torch_monotone_classes.py).
"""

import numpy as np
import pytest

from test_torch_monotone_trees import one_torch_thread  # noqa: F401
from test_torch_monotone_trees import MC, check, example, monotone_sweep, \
    train_both

ROUNDS = 3
# the first split where the packages part (test_torch_monotone_trees.py
# TIES, ROADMAP section C): each an exact f64 tie -- two splits of equal
# gain on one leaf -- that each package's f32 rounding breaks another
# way
TIES = {"quantized": (0, 22, 1e-9), "quantized_renew": (0, 22, 1e-9),
        "bagged": (1, 27, 1e-9)}
BASE = {"num_leaves": 31, "verbosity": -1, "monotone_constraints": MC,
        "min_data_in_leaf": 10, "monotone_constraints_method": "intermediate"}


@pytest.mark.parametrize("name,extra", [
    ("quantized", {"use_quantized_grad": True}),
    ("quantized_renew", {"use_quantized_grad": True,
                         "quant_train_renew_leaf": True}),
    ("bagged", {"bagging_fraction": 0.7, "bagging_freq": 1,
                "feature_fraction": 0.8, "monotone_penalty": 1.0}),
])
def test_binary_options(name, extra):
    X, y = example("binary_classification/binary.train")
    params = dict(BASE, objective="binary", **extra)
    jb, tb, rec = train_both(X, y, params, ROUNDS)
    lr = tb._gbdt.learner
    assert lr.use_mc and lr.mc_mode == "intermediate"
    assert (lr.qscale is not None) == ("use_quantized_grad" in extra)
    check(X, jb, tb, rec, params, TIES[name])
    if name != "quantized_renew":
        assert monotone_sweep(tb, X, MC) > 0
