"""Trees under monotone constraints: ``lightgbm_tpu_torch.train``
(``device_type`` cpu) against the JAX package on
``examples/regression`` and ``examples/binary_classification`` (1,000
rows, 10 features), 31 leaves, 4 trees, with ``monotone_constraints`` on
five features (the directions the labels follow on the first three, the
opposite on two), by the ``basic`` and ``intermediate`` methods, with and
without ``monotone_penalty`` 2.  Both packages grow them on the
histogram-subtraction body at K=1.

``compare`` walks both packages' trees split by split in the order made
(tests/test_torch_categorical_trees.py): every split partitions the
training rows as JAX's does and every tree has its leaf values within
rtol 1e-4 / atol 1e-5; a split that parts must be a recorded tie
(``TIES``, ROADMAP section C): its two choices' gains, recounted in f64
from the gradients the port's tree summed and under the split leaf's
bounds (both recorded as the port grows it), agree to 1e-9 of the
gains' scale, an exact tie.  With no tie the raw predictions agree to atol
1e-5.  ``monotone_sweep`` holds the
port's model to its constraints: for seeded base rows, each constrained
feature swept over its bin thresholds never moves the raw prediction
against its direction.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models.boosting import scores_from_phys
from lightgbm_tpu_torch.models.learner import SerialTreeLearner
from lightgbm_tpu_torch.ops.partition import SB_LEAF
from lightgbm_tpu_torch.ops.tree_step import LM_CMAX, LM_CMIN

from test_torch_categorical_trees import _l2_of
from test_torch_train import _leaf_sets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 4
MC = [1, 1, -1, 1, 0, -1, 0, 0, 0, 0]
BASE = {"num_leaves": 31, "verbosity": -1, "monotone_constraints": MC,
        "min_data_in_leaf": 10}
CASES = {
    "regression-basic": ("regression/regression.train", "regression",
                         "basic", 0.0),
    "regression-intermediate": ("regression/regression.train", "regression",
                                "intermediate", 0.0),
    "binary-basic-penalty": ("binary_classification/binary.train",
                             "binary", "basic", 2.0),
    "binary-intermediate": ("binary_classification/binary.train", "binary",
                            "intermediate", 0.0),
    "regression-intermediate-penalty": ("regression/regression.train",
                                        "regression", "intermediate", 2.0),
}


# (tree, split, rtol) of the first split where the packages part, per
# case (ROADMAP section C).  Clipped outputs make candidates of exactly
# equal gain common (both children clipped to one bound, or a split of
# zero gain), and JAX's f32 cumulative sums and the port's f64 prefix sums
# break such ties by their own rounding.  binary-intermediate: tree 0
# split 17 on one leaf, feature 0 (JAX) or 4 (port), f64 gains both
# 0.6061598086539881 (f32: 0.6061611 and 0.6061592).
TIES = {"binary-intermediate": (0, 17, 1e-9)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's plain loop on one torch thread for these modules: the
    intermediate refresh runs many mid-sized searches a tree, whose
    OpenMP regions stall when several test processes share the cores
    (100x slower under pytest-xdist on a loaded host).  The results do
    not depend on the thread count (elementwise operations, and
    reductions of maxima, minima and exact prefix sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def example(name):
    d = np.loadtxt(os.path.join(ROOT, "examples", name))
    return d[:, 1:], d[:, 0]


@contextlib.contextmanager
def recording():
    """Per tree the port grows: the (N,) f64 grad and hess its histograms
    sum (payload rows 0 and 1 as the tree starts, in original row order:
    bagged out rows zero, quantized carriers times their scale, a class's
    gradients) and, per split in the order made, every leaf slot's bounds
    at its election (those its best split was searched under)."""
    rec = []
    build, body = SerialTreeLearner.build_tree, SerialTreeLearner._body

    def rec_build(self, pb, pg, before_read=None):
        sc = (self.qscale.double() if self.qscale is not None
              else torch.ones(2, dtype=torch.float64))
        rec.append({k: (scores_from_phys(pg, self.N, r).double()
                        * sc[r]).numpy() for k, r in (("g", 0), ("h", 1))})
        rec[-1]["bounds"] = []
        return build(self, pb, pg, before_read)

    def rec_body(self, pb, pg, step):
        if step is self.step:
            rec[-1]["bounds"].append(
                self.leafmat[[LM_CMIN, LM_CMAX], :self.L].numpy().copy())
        return body(self, pb, pg, step)

    with mock.patch.object(SerialTreeLearner, "build_tree", rec_build), \
            mock.patch.object(SerialTreeLearner, "_body", rec_body):
        yield rec


def slot_bounds(tree, lv, s, rows, bounds):
    """The bounds, at split ``s`` of the port's ``tree`` (rows' leaves
    ``lv``), of the leaf whose rows are ``rows``: the leaf that node (or
    final leaf) held the slot of then -- a split leaf keeps its slot for
    the left child, the right child takes slot ``split + 1``."""
    ns = tree.num_leaves - 1
    slot, leaf_slot = {0: 0}, {}
    for n in range(ns):
        for side, c in enumerate((int(tree.left_child[n]),
                                  int(tree.right_child[n]))):
            cs = slot[n] if side == 0 else n + 1
            if c >= 0:
                slot[c] = cs
            else:
                leaf_slot[~c] = cs
    sets = _leaf_sets(tree)
    for n in range(s, ns):
        if np.array_equal(np.isin(lv, list(sets[n][0])), rows):
            return bounds[:, slot[n]]
    for leaf, sl in leaf_slot.items():
        if np.array_equal(lv == leaf, rows):
            return bounds[:, sl]
    raise AssertionError(f"no leaf of the port's tree at split {s} has "
                         f"the rows")


def train_both(X, y, params, rounds=ROUNDS, **ds_kw):
    """The JAX booster, the port's (cpu) on the same data, and the port's
    ``recording``."""
    jb = lgb.train(dict(params), lgb.Dataset(X, label=y, **ds_kw), rounds)
    jb.num_trees()
    with recording() as rec:
        tb = lgt.train(dict(params, device_type="cpu"),
                       lgt.Dataset(X, label=y, **ds_kw), rounds)
    return jb, tb, rec


def split_gain64(rows, left, g, h, bounds, l2c, params):
    """f64 gain of a split of the leaf of ``rows`` (its left child's
    ``left``) under the leaf's ``bounds``, as the monotone search scores
    it: each side's output clipped to the bounds and its gain taken there
    (``l2c`` the children's l2: a categorical sorted arm's adds cat_l2),
    less the leaf's own; and the sum of the three |gains|, the scale of
    f32 resolution."""
    l1 = params.get("lambda_l1", 0.0)
    l2 = params.get("lambda_l2", 0.0)
    mds = params.get("max_delta_step", 0.0)

    def part(m, reg):
        gg, hh = g[m].sum(), h[m].sum()
        s = np.sign(gg) * max(abs(gg) - l1, 0.0)
        out = -s / (hh + reg)
        if mds > 0:
            out = min(max(out, -mds), mds)
        out = min(max(out, bounds[0]), bounds[1])
        return -(2.0 * s * out + (hh + reg) * out * out)

    parts = [part(left, l2c), part(rows & ~left, l2c), part(rows, l2)]
    return parts[0] + parts[1] - parts[2], sum(abs(v) for v in parts)


def compare(X, jb, tb, rec, params, ties=None):
    """The first (tree, split) where the packages partition the training
    rows differently, None when every split agrees; leaf values of every
    tree before it within rtol 1e-4 / atol 1e-5.  The parting split must
    be the recorded tie ``ties`` = (tree, split, rtol): its two choices'
    f64 gains (``split_gain64``, from the tree's recorded gradients and
    each split leaf's recorded bounds) agree to ``rtol`` of the gains'
    scale: two choices of equal gain, on one leaf or on two."""
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    leaves_j = np.asarray(jb.predict(X, pred_leaf=True)).reshape(len(X), -1)
    leaves_t = np.asarray(port_in_jax.predict(X, pred_leaf=True)).reshape(
        len(X), -1)
    np.testing.assert_array_equal(
        leaves_t, np.asarray(tb.predict(X, pred_leaf=True)).reshape(
            len(X), -1))
    models = list(zip(jb._gbdt.models, tb._gbdt.models))
    assert len(jb._gbdt.models) == len(tb._gbdt.models) == len(rec)
    mappers = tb._gbdt.train_data.bin_mappers
    for t, (a, b) in enumerate(models):
        sets = [[(np.isin(lv, list(u)), np.isin(lv, list(v)))
                 for u, v in _leaf_sets(tree)]
                for tree, lv in ((a, leaves_j[:, t]), (b, leaves_t[:, t]))]
        for s in range(max(len(sets[0]), len(sets[1]))):
            (rj, lj), (rt, lt) = (x[s] if s < len(x) else (None, None)
                                  for x in sets)
            if (rj is not None and rt is not None
                    and np.array_equal(rj, rt) and np.array_equal(lj, lt)):
                continue
            assert ties is not None and (t, s) == ties[:2], (
                f"tree {t} split {s}: the packages split differently")
            g, h, bd = rec[t]["g"], rec[t]["h"], rec[t]["bounds"][s]
            vj, mj = split_gain64(
                rj, lj, g, h, slot_bounds(b, leaves_t[:, t], s, rj, bd),
                _l2_of(a, s, mappers, params), params)
            vt, mt = split_gain64(
                rt, lt, g, h, slot_bounds(b, leaves_t[:, t], s, rt, bd),
                _l2_of(b, s, mappers, params), params)
            assert abs(vj - vt) <= ties[2] * max(1.0, mj, mt), (
                f"tree {t} split {s}: f64 gains {vj!r} (JAX) and {vt!r} "
                f"(port)")
            return t, s
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    return None


def check(X, jb, tb, rec, params, ties=None):
    """``compare``, then with no tie the raw predictions and the model
    text both ways."""
    found = compare(X, jb, tb, rec, params, ties)
    assert found == (ties and ties[:2])
    if found is not None:
        return
    pj, pt = (b.predict(X, raw_score=True) for b in (jb, tb))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    jax_in_port = lgt.Booster(model_str=jb.model_to_string(),
                              params={"device_type": "cpu"})
    np.testing.assert_allclose(jax_in_port.predict(X, raw_score=True), pj,
                               rtol=0, atol=1e-5)


def monotone_sweep(booster, X, mc, rows=200, seed=0):
    """For ``rows`` seeded base rows of ``X``, each constrained feature set
    to every one of its bin thresholds (and past the last): the raw
    predictions never fall along a +1 feature, never rise along a -1 one.
    Returns the number of constrained steps checked."""
    rng = np.random.RandomState(seed)
    base = X[rng.choice(len(X), rows, replace=False)]
    mappers = booster._gbdt.train_data.bin_mappers
    checked = 0
    for f, sign in enumerate(mc):
        if sign == 0:
            continue
        ub = np.asarray(mappers[f].bin_upper_bound, np.float64)
        grid = np.concatenate([ub[np.isfinite(ub)], [ub[np.isfinite(ub)][-1]
                                                     + 1.0]])
        Xs = np.repeat(base, len(grid), axis=0)
        Xs[:, f] = np.tile(grid, rows)
        p = np.asarray(booster.predict(Xs, raw_score=True)).reshape(
            rows, len(grid), -1)
        d = np.diff(p, axis=1) * sign
        assert d.min() >= -1e-6 * max(1.0, np.abs(p).max()), (f, d.min())
        checked += d.size
    return checked


def run_case(case):
    """One case of CASES: trained in both packages, ``check``ed, and the
    port's model swept."""
    path, objective, method, penalty = CASES[case]
    X, y = example(path)
    params = dict(BASE, objective=objective,
                  monotone_constraints_method=method,
                  monotone_penalty=penalty)
    jb, tb, rec = train_both(X, y, params)
    lr = tb._gbdt.learner
    assert lr.use_mc and lr.mc_mode == method and lr.subtract and lr.K == 1
    assert (lr.mc_pen is not None) == (penalty > 0)
    assert sum(t.num_leaves for t in tb._gbdt.models) > ROUNDS * 8
    check(X, jb, tb, rec, params, TIES.get(case))
    assert monotone_sweep(tb, X, MC) > 0


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c.startswith("regression")))
def test_monotone_trees_match_jax(case):
    run_case(case)
