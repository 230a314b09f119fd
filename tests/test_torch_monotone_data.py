"""Monotone constraints with the port's other data paths, against the
JAX package on the CPU (``tests/test_torch_monotone_trees.py``'s
``check``: trees split for split, leaf values rtol 1e-4 / atol 1e-5, raw
predictions atol 1e-5, model text both ways, and the monotonicity sweep
of the port's model):

categorical columns (never monotone themselves; their searches clip to
the leaf's bounds) beside constrained numerical ones, by the
``intermediate`` method (the refresh re-searches the categorical
leaves) and by ``basic`` with a penalty.  Bundles and uint16 bins are
tests/test_torch_monotone_wide.py.
"""

import numpy as np
import pytest

from test_torch_categorical import CATS, cat_data
from test_torch_monotone_trees import one_torch_thread  # noqa: F401
from test_torch_monotone_trees import check, example, monotone_sweep, \
    train_both

ROUNDS = 3
# the first split where the packages part (test_torch_monotone_trees.py
# TIES, ROADMAP section C): an exact f64 tie of two splits of zero gain,
# on two leaves, each package's f32 rounding electing another
TIES = {"categorical-intermediate": (0, 20, 1e-9)}


@pytest.mark.parametrize("method,penalty", [("intermediate", 0.0),
                                            ("basic", 2.0)])
def test_categorical_with_monotone_numerical_features(method, penalty):
    X, y = cat_data(n=2000)
    mc = [0, 1, 0, -1]
    params = {"objective": "regression", "num_leaves": 31, "verbosity": -1,
              "min_data_in_leaf": 20, "min_data_per_group": 50,
              "monotone_constraints": mc,
              "monotone_constraints_method": method,
              "monotone_penalty": penalty}
    jb, tb, rec = train_both(X, y, params, ROUNDS,
                        categorical_feature=CATS[False])
    lr = tb._gbdt.learner
    assert lr.use_mc and lr.has_cat and lr.mc_mode == method
    np.testing.assert_array_equal(lr._fmeta[7], [0, 1, 0, -1])
    assert sum(t.num_cat for t in tb._gbdt.models) > 0
    check(X, jb, tb, rec, params, TIES.get(f"categorical-{method}"))
    assert monotone_sweep(tb, X, mc) > 0
