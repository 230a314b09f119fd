"""Every pointwise objective the port adds, trained end to end: 5 trees of
the port (``device_type=cpu``, the mega path) against the JAX package
(``tpu_megakernel=xla``, ``tpu_frontier_k=1``) on examples/regression
(poisson, gamma and tweedie on |label|, gamma's shifted off 0) and on
examples/binary_classification (cross_entropy, cross_entropy_lambda);
this file runs regression_l1, quantile, Huber and Fair,
test_torch_objectives_train_exp.py the others.
The L1 family (regression_l1, quantile, mape) renews its leaves after
each tree.

The tie rule of ROADMAP section C: both packages' trees are walked split
by split in the order made, on the training rows; every split must
partition the rows the same way until the first one that does not,
whose two choices must have equal gains recounted in f64 from that
tree's gradients (the objective's formula in float64 on the port's
scores), to 1e-9 of the split's leaf gains; every tree before it has its
leaf values within rtol 1e-4 / atol 1e-5.  ``TIES`` records, per case,
the (tree, split) of the first tie; with none, the raw predictions agree
to atol 1e-5 and every metric of the objective to rtol 1e-6.

Quantile and Huber gradients take few values (quantile: 1 - alpha or
-alpha; Huber: +-alpha past it).  Where every row of a leaf has the same
gradient over hessian, every split of it has a gain of 0 in exact
arithmetic and f32 residues pick one; and candidates of equal row counts
tie.  Their default cases meet such a tie in the first tree; the same
objectives with ``min_gain_to_split`` 0.01, which makes no split of
residue gain, hold all 5 trees.
"""

import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_train import _first_tie
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 5


def _load(rel):
    d = np.loadtxt(os.path.join(ROOT, "examples", rel))
    return d[:, 1:], d[:, 0]


def _sigmoid(s):
    return 1.0 / (1.0 + np.exp(-s))


def grads64(objective, params, y, w, score):
    """(grad, hess) of one class's f64 ``score`` by the objective's
    formula in float64 (JAX models/objective.py get_gradients)."""
    a = params.get("alpha", 0.9)
    d = score - y
    one = np.ones_like(score)
    if objective == "regression":
        g, h = d, one
    elif objective == "regression_l1":
        g, h = np.sign(d), one
    elif objective == "huber":
        g, h = np.where(np.abs(d) <= a, d, np.sign(d) * a), one
    elif objective == "fair":
        c = params.get("fair_c", 1.0)
        g, h = c * d / (np.abs(d) + c), c * c / (np.abs(d) + c) ** 2
    elif objective == "poisson":
        e = np.exp(score)
        g, h = e - y, e * np.exp(params.get("poisson_max_delta_step", 0.7))
    elif objective == "quantile":
        g, h = np.where(d >= 0, 1.0 - a, -a), one
    elif objective == "mape":
        g = np.sign(d) / np.maximum(1.0, np.abs(y))
        return (g * w, w) if w is not None else (g, one)
    elif objective == "gamma":
        e = np.exp(-score)
        g, h = 1.0 - y * e, y * e
    elif objective == "tweedie":
        rho = params.get("tweedie_variance_power", 1.5)
        e1, e2 = np.exp((1 - rho) * score), np.exp((2 - rho) * score)
        g, h = -y * e1 + e2, -y * (1 - rho) * e1 + (2 - rho) * e2
    elif objective in ("binary", "cross_entropy"):
        z = _sigmoid(score)
        g, h = z - y, z * (1.0 - z)
    elif objective == "cross_entropy_lambda":
        ww = w if w is not None else one
        epf = np.exp(score)
        z = 1.0 - np.exp(-ww * np.log1p(epf))
        g = (1.0 - y / np.maximum(z, 1e-15)) * ww / (1.0 + 1.0 / epf)
        c = 1.0 / np.maximum(1.0 - z, 1e-15)
        dd = 1.0 + epf
        b = (c / np.maximum((c - 1.0) ** 2, 1e-15)) * (1.0 + ww * epf - c)
        return g, ww * epf / (dd * dd) * (1.0 + y * b)
    else:
        raise ValueError(objective)
    if w is not None:
        return g * w, h * w
    return g, h


def walk_ties(X, y, w, jb, tb, params, grads, base=None):
    """The first (tree, split) where the packages partition the rows
    differently, after checking it is an exact tie in f64; None when
    every tree agrees.  ``grads(score)`` gives the (K, N) f64 gradients
    and hessians of the (K, N) scores; trees are class-major.  ``base``:
    the (K, N) init_score of the rows, else the booster's init scores
    (folded into its first trees)."""
    reg = (params.get("lambda_l1", 0.0), params.get("lambda_l2", 0.0),
           params.get("max_delta_step", 0.0))
    K = tb._gbdt.num_tree_per_iteration
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    leaves_j = np.asarray(jb.predict(X, pred_leaf=True))
    leaves_t = np.asarray(port_in_jax.predict(X, pred_leaf=True))
    np.testing.assert_array_equal(leaves_t, tb.predict(X, pred_leaf=True))
    init = np.asarray(tb._gbdt.init_scores, np.float64)
    if base is not None:
        init = np.zeros(K)
    score = (np.repeat(init[:, None], len(y), 1) if base is None
             else np.array(base, np.float64).reshape(K, len(y)))
    models = list(zip(jb._gbdt.models, tb._gbdt.models))
    for it in range(len(models) // K):
        g, h = grads(score)
        for k in range(K):
            t = it * K + k
            a, b = models[t]
            s = _first_tie(a, b, leaves_j[:, t], leaves_t[:, t], g[k], h[k],
                           reg, t)
            if s is not None:
                return t, s
            np.testing.assert_allclose(b.leaf_value, a.leaf_value,
                                       rtol=1e-4, atol=1e-5)
            score[k] += np.asarray(b.leaf_value, np.float64)[leaves_t[:, t]]
            if it == 0:
                score[k] -= init[k]
    return None


REG = "regression/regression.train"
BIN = "binary_classification/binary.train"
# name: (data, objective, extra params, row weights)
CASES = {
    "regression_l1": (REG, "regression_l1", {}, False),
    "huber": (REG, "huber", {}, False),
    "huber_min_gain": (REG, "huber", {"min_gain_to_split": 0.01}, False),
    "fair": (REG, "fair", {}, False),
    "poisson": (REG, "poisson", {}, False),
    "quantile": (REG, "quantile", {}, False),
    "quantile_min_gain": (REG, "quantile", {"alpha": 0.7,
                                            "min_gain_to_split": 0.01}, True),
    "mape": (REG, "mape", {}, False),
    "gamma": (REG, "gamma", {"metric": "gamma,gamma_deviance,mae"}, False),
    "tweedie": (REG, "tweedie", {}, False),
    "cross_entropy": (BIN, "cross_entropy",
                      {"num_leaves": 15, "metric": "xentropy,kldiv"}, False),
    "cross_entropy_lambda": (BIN, "cross_entropy_lambda",
                             {"num_leaves": 15}, True),
}
# (tree, split) of the first exact tie of each case (None: none)
TIES = {"quantile": (0, 7), "huber": (0, 26)}
# the cases of this file; test_torch_objectives_train_exp.py runs the rest
HERE = ["regression_l1", "huber", "huber_min_gain", "fair", "quantile",
        "quantile_min_gain"]


def _data(rel, objective, weighted):
    X, y = _load(rel)
    if objective in ("poisson", "gamma", "tweedie"):
        y = np.abs(y) + (0.1 if objective == "gamma" else 0.0)
    w = (np.random.RandomState(11).uniform(0.5, 1.5, len(y))
         if weighted else None)
    return X, y, w


def train_both(case):
    rel, objective, extra, weighted = CASES[case]
    X, y, w = _data(rel, objective, weighted)
    params = dict({"objective": objective, "num_leaves": 31,
                   "verbosity": -1, "min_data_in_leaf": 20}, **extra)
    jb = lgb.train(dict(params, tpu_megakernel="xla", tpu_frontier_k=1),
                   lgb.Dataset(X, label=y, weight=w), num_boost_round=ROUNDS)
    jb.num_trees()
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, label=y, weight=w), num_boost_round=ROUNDS)
    return X, y, w, params, jb, tb


@pytest.mark.parametrize("case", HERE)
def test_objective_trains_as_jax(case):
    check_case(case)


def check_case(case):
    X, y, w, params, jb, tb = train_both(case)
    objective = params["objective"]
    assert tb._gbdt.objective.name == objective
    assert len(tb._gbdt.models) == ROUNDS

    def grads(score):
        g, h = grads64(objective, params, y, w, score[0])
        return g[None], h[None]

    found = walk_ties(X, y, w, jb, tb, params, grads)
    assert found == TIES.get(case)
    if found is not None:
        return
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-5,
                               atol=1e-5)
    je, te = jb.eval_train(), tb.eval_train()
    assert [e[1] for e in te] == [e[1] for e in je] != []
    for (_, _, tv, tmax), (_, _, jv, jmax) in zip(te, je):
        assert tmax == jmax
        np.testing.assert_allclose(tv, jv, rtol=1e-6)
