"""Linear trees (``linear_tree_mode`` refit) with more than one class
or with query groups, the port (``device_type`` cpu) against the JAX
package, 15 leaves, 4 iterations: 3-class multiclass (a seeded
``init_score``, as the multiclass tests take it; each class tree's
linear outputs scatter into its class's scores) and ``rank_xendcg`` on
examples/xendcg.
"""

import os

import numpy as np

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_multiclass import mc_data
from torch_boost_cases import BODIES, ROOT, recording, train_both
from torch_linear_cases import check_linear, compare_linear
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 4
LINEAR = {"num_leaves": 15, "linear_tree": True}
# a tie of f32 resolution: the two f64 gains differ by less than one f32
# rounding of the leaf's gains' mass (ROADMAP section C)
F32_TIE = 2.0 ** -23


def _mc3():
    X, y = mc_data(3)
    init = np.random.RandomState(1).normal(0, 0.3, (len(y), 3))
    return X, y, init.T.reshape(-1)


def test_multiclass3_matches_jax():
    """3 classes on the mega body: the class trees and their linear
    leaves as JAX's up to a tie of f32 resolution at class tree 9 (the
    4th iteration's class 0), split 13."""
    X, y, init = _mc3()
    params = dict(LINEAR, objective="multiclass", num_class=3,
                  **BODIES["mega"])
    jb, tb, rec = train_both(params, (X, y, init), ROUNDS)
    assert tb._gbdt.num_tree_per_iteration == 3 and tb._gbdt.linear
    check_linear(X, jb, tb, rec, params, (9, 13, F32_TIE))


def test_rank_xendcg_matches_jax():
    """rank_xendcg with query groups (examples/xendcg): the same trees
    and linear leaves, raw predictions atol 1e-5."""
    d = np.loadtxt(os.path.join(ROOT, "examples", "xendcg", "rank.train"))
    q = np.loadtxt(os.path.join(ROOT, "examples", "xendcg",
                                "rank.train.query")).astype(int)
    X, y = d[:, 1:], d[:, 0]
    params = dict(LINEAR, objective="rank_xendcg", verbosity=-1)
    jb = lgb.train(params, lgb.Dataset(X, label=y, group=q), ROUNDS)
    with recording() as rec:
        tb = lgt.train(dict(params, device_type="cpu"),
                       lgt.Dataset(X, label=y, group=q), ROUNDS)
    assert compare_linear(X, jb, tb, rec, params) is None
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
