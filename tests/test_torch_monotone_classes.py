"""Monotone constraints with the L1-family renewal and with multiclass,
against the JAX package on the CPU (tests/test_torch_monotone_trees.py's
``check``: trees split for split or a recorded exact tie, leaf values
rtol 1e-4 / atol 1e-5, raw predictions atol 1e-5, model text both ways):

  * ``regression_l1`` (``basic``): leaf values renewed after the tree
    from the residuals' quantile, without the bounds, as the JAX package
    renews them;
  * 3-class multiclass (``intermediate``; each class tree constrained),
    on the rows of ``examples/multiclass_classification`` of its first
    three classes, each class's raw score swept.
"""

import numpy as np

from test_torch_monotone_options import BASE
from test_torch_monotone_trees import one_torch_thread  # noqa: F401
from test_torch_monotone_trees import MC, check, example, monotone_sweep, \
    train_both

ROUNDS = 3
# the first split where the packages part (test_torch_monotone_trees.py
# TIES, ROADMAP section C): an exact f64 tie of two splits of zero gain
# that each package's f32 rounding breaks another way
TIES = {"l1": (0, 26, 1e-9), "three_classes": (0, 11, 1e-9)}


def test_l1_renewal():
    X, y = example("regression/regression.train")
    params = dict(BASE, objective="regression_l1",
                  monotone_constraints_method="basic")
    jb, tb, rec = train_both(X, y, params, ROUNDS)
    check(X, jb, tb, rec, params, TIES["l1"])


def test_three_classes():
    X, y = example("multiclass_classification/multiclass.train")
    keep = y < 3
    X, y = X[keep], y[keep]
    params = dict(BASE, objective="multiclass", num_class=3)
    jb, tb, rec = train_both(X, y, params, 2)
    assert len(tb._gbdt.models) == 6
    check(X, jb, tb, rec, params, TIES["three_classes"])
    raw = np.asarray(tb.predict(X, raw_score=True))
    assert raw.shape == (len(X), 3)
    for k in range(3):
        one = type("OneClass", (), {
            "_gbdt": tb._gbdt,
            "predict": lambda self, Z, raw_score=True, k=k: np.asarray(
                tb.predict(Z, raw_score=True))[:, k]})()
        assert monotone_sweep(one, X, MC, rows=60) > 0

