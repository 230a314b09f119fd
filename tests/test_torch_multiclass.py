"""Multiclass training, the port (``device_type=cpu``) against the JAX
package on examples/multiclass_classification (1,000 rows, 5 classes):
``multiclass`` (softmax) and ``multiclassova``, 3 iterations of 5 class
trees of 15 leaves.  The cases without a bag run JAX's eager iteration
(``tpu_fused_iteration=false``, its path on a TPU at 5 classes); those
with one its default path, whose fused multiclass program draws the bag
the port draws.  This file runs softmax, test_torch_multiclass_ova.py
one-vs-all and test_torch_multiclass_sampling.py the sampled cases.

The tie rule of test_torch_objectives_train.py (ROADMAP section C).  In
the first iteration every row of a class tree has one of two gradients
(the scores are the class priors), so candidates of equal row counts
tie exactly: the boost-from-average cases meet such a tie in the first
class tree (``TIES``).  With a seeded ``init_score`` (N * 5 values,
class-major) the gradients vary from the start: those cases hold all 15
trees -- leaf values rtol 1e-4 / atol 1e-5, raw and converted
predictions atol 1e-5 (GOSS: 2e-5, its x8 weights on the sampled rows
carry the packages' f32 sums further), and multi_logloss, multi_error
and auc_mu rtol 1e-6.  In the port alone, the frontier (``tpu_frontier_k``
4) grows the same trees as K=1, bit for bit.
"""

import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_objectives_train import grads64, walk_ties
from test_torch_train import _structure
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 5
ROUNDS = 3
METRICS = "multi_logloss,multi_error,auc_mu"


def mc_data(classes=K):
    d = np.loadtxt(os.path.join(ROOT, "examples", "multiclass_classification",
                                "multiclass.train"))
    keep = d[:, 0] < classes
    return d[keep, 1:], d[keep, 0]


def class_grads(objective, y, classes=K):
    """(K, N) f64 gradients of the (K, N) scores: the softmax's, or each
    class's binary logloss."""
    Y = (np.arange(classes)[:, None] == y[None]).astype(np.float64)

    def grads(score):
        if objective == "multiclass":
            e = np.exp(score - score.max(0))
            p = e / e.sum(0)
            return p - Y, classes / (classes - 1.0) * p * (1.0 - p)
        gh = [grads64("binary", {}, Y[k], None, score[k])
              for k in range(classes)]
        return np.array([g for g, _ in gh]), np.array([h for _, h in gh])
    return grads


# name: (objective, extra params, init_score, JAX's eager iteration,
# classes)
CASES = {
    "softmax": ("multiclass", {}, False, True, K),
    "ova": ("multiclassova", {}, False, True, K),
    "softmax_init": ("multiclass", {}, True, True, K),
    "ova_init": ("multiclassova", {}, True, True, K),
    "bagging_3_classes": ("multiclass", {"bagging_fraction": 0.7,
                                         "bagging_freq": 2}, True, False, 3),
    "feature_fraction": ("multiclassova", {"feature_fraction": 0.8}, True,
                         True, K),
    "goss": ("multiclass", {"data_sample_strategy": "goss"}, True, False, K),
    "balanced_bagging": ("multiclass", {"pos_bagging_fraction": 0.6,
                                        "neg_bagging_fraction": 0.9,
                                        "bagging_freq": 1}, True, False, K),
}
TIES = {"softmax": (0, 10), "ova": (0, 12)}
# the cases of each file: this one, test_torch_multiclass_ova.py and
# test_torch_multiclass_sampling.py
FILES = {"softmax": ["softmax", "softmax_init"],
         "ova": ["ova", "ova_init", "feature_fraction"],
         "sampling": ["bagging_3_classes", "goss", "balanced_bagging"]}


def train_both(case):
    objective, extra, with_init, eager, classes = CASES[case]
    X, y = mc_data(classes)
    init = (np.random.RandomState(4).randn(classes * len(y)) * 0.5
            if with_init else None)
    params = dict({"objective": objective, "num_class": classes,
                   "num_leaves": 15, "min_data_in_leaf": 20,
                   "verbosity": -1, "metric": METRICS}, **extra)
    jb = lgb.train(dict(params, tpu_megakernel="xla", tpu_frontier_k=1,
                        tpu_fused_iteration=not eager),
                   lgb.Dataset(X, label=y, init_score=init),
                   num_boost_round=ROUNDS)
    jb.num_trees()
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, label=y, init_score=init),
                   num_boost_round=ROUNDS)
    return X, y, init, params, jb, tb


def check_case(case):
    X, y, init, params, jb, tb = train_both(case)
    classes = params["num_class"]
    assert tb._gbdt.num_tree_per_iteration == classes
    assert tb.num_trees() == jb.num_trees() == ROUNDS * classes
    found = walk_ties(X, y, None, jb, tb, params,
                      class_grads(params["objective"], y, classes), init)
    assert found == TIES.get(case)
    if found is not None:
        return
    atol = 2e-5 if case == "goss" else 1e-5
    for raw in (True, False):
        got, want = (b.predict(X, raw_score=raw) for b in (tb, jb))
        assert got.shape == want.shape == (len(y), classes)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    je, te = jb.eval_train(), tb.eval_train()
    assert [e[1] for e in te] == [e[1] for e in je] == METRICS.split(",")
    for (_, _, tv, tmax), (_, _, jv, jmax) in zip(te, je):
        assert tmax == jmax
        np.testing.assert_allclose(tv, jv, rtol=1e-6)


@pytest.mark.parametrize("case", FILES["softmax"])
def test_multiclass_trains_as_jax(case):
    check_case(case)


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_frontier_grows_the_k1_trees(objective):
    X, y = mc_data()
    params = {"objective": objective, "num_class": K, "num_leaves": 15,
              "min_data_in_leaf": 20, "verbosity": -1, "device_type": "cpu",
              "bagging_fraction": 0.8, "bagging_freq": 1}
    out = []
    for fk in (1, 4):
        b = lgt.train(dict(params, tpu_frontier_k=fk), lgt.Dataset(X, label=y),
                      num_boost_round=2)
        assert b._gbdt.learner.K == fk
        out.append(b)
    for a, b in zip(out[0]._gbdt.models, out[1]._gbdt.models):
        assert _structure(a) == _structure(b)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    np.testing.assert_array_equal(out[0]._gbdt.scores.numpy(),
                                  out[1]._gbdt.scores.numpy())
