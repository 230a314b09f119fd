"""Monotone constraints with EFB bundles and uint16 bins, against the JAX
package on the CPU (tests/test_torch_monotone_trees.py's ``check``: trees
split for split or a recorded exact tie, leaf values rtol 1e-4 / atol
1e-5, raw predictions atol 1e-5, model text both ways, and the
monotonicity sweep of the port's model), by the ``intermediate`` method:

  * an EFB bundle holding a constrained feature (the refresh's planes
    through the per-feature view);
  * uint16 bins (``max_bin`` 1023: the pair search's arm past 256 bins).
"""

import numpy as np

from test_torch_categorical import CATS, cat_data
from test_torch_monotone_trees import one_torch_thread  # noqa: F401
from test_torch_monotone_trees import check, example, monotone_sweep, \
    train_both

ROUNDS = 3
# the first split where the packages part (test_torch_monotone_trees.py
# TIES, ROADMAP section C): an exact f64 tie of two splits of zero gain,
# on two leaves, each package's f32 rounding electing another
TIES = {"bundle": (0, 28, 1e-9)}


def test_bundle_holding_a_monotone_feature():
    X, y = cat_data(n=2000, bundle=True)
    mc = [0, 1, 0, 0, 0, 1]
    params = {"objective": "regression", "num_leaves": 31, "verbosity": -1,
              "min_data_in_leaf": 20, "min_data_per_group": 50,
              "monotone_constraints": mc,
              "monotone_constraints_method": "intermediate"}
    jb, tb, rec = train_both(X, y, params, ROUNDS,
                        categorical_feature=CATS[True])
    lr = tb._gbdt.learner
    assert lr.use_mc and lr.bundled and lr.mc_mode == "intermediate"
    feats = lr._fmeta[0].tolist()
    assert lr._fmeta[3, feats.index(5)] == 1        # column 5 is bundled
    assert any(5 in t.split_feature[:t.num_leaves - 1]
               for t in tb._gbdt.models)
    check(X, jb, tb, rec, params, TIES["bundle"])
    assert monotone_sweep(tb, X, mc) > 0


def test_uint16_bins():
    X, y = example("regression/regression.train")
    mc = [1, 1, -1, 0, 0, 0, 0, 0, 0, 0]
    params = {"objective": "regression", "num_leaves": 31, "verbosity": -1,
              "max_bin": 1023, "min_data_in_leaf": 10,
              "monotone_constraints": mc,
              "monotone_constraints_method": "intermediate"}
    jb, tb, rec = train_both(X, y, params, ROUNDS)
    lr = tb._gbdt.learner
    assert lr.use_mc and lr.bin_dtype == np.uint16 and lr.B > 256
    check(X, jb, tb, rec, params)
    assert monotone_sweep(tb, X, mc, rows=50) > 0
