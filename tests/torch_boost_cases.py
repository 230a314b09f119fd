"""Shared helpers of the boosting-engine tests (test_torch_dart.py,
test_torch_rf.py, test_torch_eager.py, test_torch_rollback.py): the same
seeded params through the JAX package and the port (``device_type``
cpu), the gradients each of the port's trees summed, the iterations
DART dropped in each package, and ``compare``, the repo's tie rule
(ROADMAP section C).

``compare`` walks both packages' trees in the order made, split by
split: every split partitions the training rows as JAX's does and every
tree has its leaf values within rtol 1e-4 / atol 1e-5.  The first split
that parts must tie exactly: its two choices' gains, recounted in f64
from the gradients the port's tree summed (recorded as the tree starts:
payload rows 0 and 1 in original row order, bagged-out rows zero, GOSS's
rows scaled, quantized carriers times their scale), agree to 1e-9 of the
gains' mass.  ``check`` then holds the recorded tie, or with none the raw
predictions (atol 1e-5) and the model text both ways.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.models import boosting as jboosting
from lightgbm_tpu_torch.models import boosting as tboosting
from lightgbm_tpu_torch.models.boosting import scores_from_phys
from lightgbm_tpu_torch.models.learner import SerialTreeLearner

from test_torch_categorical_trees import _gain64
from test_torch_train import _leaf_sets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG = "regression/regression.train"
REG_TEST = "regression/regression.test"
BIN = "binary_classification/binary.train"
BIN_TEST = "binary_classification/binary.test"
MULTI = "multiclass_classification/multiclass.train"
BAG = {"bagging_fraction": 0.7, "bagging_freq": 1}
MEGA, K4, SUB = {}, {"tpu_frontier_k": 4}, {"tpu_megakernel": "off"}
BODIES = {"mega": MEGA, "k4": K4, "sub": SUB}


def example(name):
    d = np.loadtxt(os.path.join(ROOT, "examples", name))
    return d[:, 1:], d[:, 0]


@contextlib.contextmanager
def recording():
    """Per tree the port grows, the (N,) f64 grad and hess its
    histograms sum (see module doc)."""
    rec = []
    build = SerialTreeLearner.build_tree

    def rec_build(self, pb, pg, before_read=None):
        sc = (self.qscale.double() if self.qscale is not None
              else torch.ones(2, dtype=torch.float64))
        rec.append(tuple((scores_from_phys(pg, self.N, r).double()
                          * sc[r]).numpy() for r in (0, 1)))
        return build(self, pb, pg, before_read)

    with mock.patch.object(SerialTreeLearner, "build_tree", rec_build):
        yield rec


@contextlib.contextmanager
def drops():
    """The trees each package's DART drops, per iteration, in the order
    dropped: {"jax": [[t, ...], ...], "port": [...]}."""
    out = {"jax": [], "port": []}
    jtrain, ttrain = jboosting.DART.train_one_iter, \
        tboosting.DART.train_one_iter
    jadd, tadd = jboosting.DART._add_tree_to_scores, \
        tboosting.DART._tree_to_scores

    def wrap_train(key, fn):
        def run(self, *a, **k):
            out[key].append([])
            return fn(self, *a, **k)
        return run

    def wrap_add(key, fn):
        def run(self, t, factor, train=True, valid=True):
            if factor == -1.0 and not valid:
                out[key][-1].append(t)
            return fn(self, t, factor, train, valid)
        return run

    with mock.patch.object(jboosting.DART, "train_one_iter",
                           wrap_train("jax", jtrain)), \
            mock.patch.object(tboosting.DART, "train_one_iter",
                              wrap_train("port", ttrain)), \
            mock.patch.object(jboosting.DART, "_add_tree_to_scores",
                              wrap_add("jax", jadd)), \
            mock.patch.object(tboosting.DART, "_tree_to_scores",
                              wrap_add("port", tadd)):
        yield out


def train_both(params, data, rounds, valid=None, jax_extra=None,
               **train_kw):
    """The JAX booster, the port's (cpu) on the same rows, and the port's
    ``recording``; ``data`` an example file, (X, y) or (X, y,
    init_score), ``valid`` an example file for one validation set."""
    X, y, *init = example(data) if isinstance(data, str) else data
    boosters = {}
    for name, mod, extra in (("jax", lgb, jax_extra or {}),
                             ("port", lgt, {"device_type": "cpu"})):
        dt = mod.Dataset(X, label=y, init_score=init[0] if init else None)
        kw = dict(train_kw)
        if valid is not None:
            Xv, yv = example(valid)
            kw["valid_sets"] = [mod.Dataset(Xv, label=yv, reference=dt)]
        with (recording() if name == "port"
              else contextlib.nullcontext()) as rec:
            b = mod.train(dict(params, verbosity=-1, **extra), dt, rounds,
                          **kw)
        b.num_trees()
        boosters[name] = b
    return boosters["jax"], boosters["port"], rec


def compare(X, jb, tb, rec, params):
    """The first (tree, split) where the packages part, after checking it
    is an exact tie; None when every tree agrees (see module doc)."""
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    leaves_j = np.asarray(jb.predict(X, pred_leaf=True)).reshape(len(X), -1)
    leaves_t = np.asarray(port_in_jax.predict(X, pred_leaf=True)).reshape(
        len(X), -1)
    np.testing.assert_array_equal(
        leaves_t, np.asarray(tb.predict(X, pred_leaf=True)).reshape(
            len(X), -1))
    assert len(jb._gbdt.models) == len(tb._gbdt.models) == len(rec)
    l2 = params.get("lambda_l2", 0.0)
    for t, (a, b) in enumerate(zip(jb._gbdt.models, tb._gbdt.models)):
        g, h = rec[t]
        sets = [[(np.isin(lv, list(u)), np.isin(lv, list(v)))
                 for u, v in _leaf_sets(tree)]
                for tree, lv in ((a, leaves_j[:, t]), (b, leaves_t[:, t]))]
        for s in range(max(len(sets[0]), len(sets[1]))):
            (rj, lj), (rt, lt) = (x[s] if s < len(x) else (None, None)
                                  for x in sets)
            if (rj is not None and rt is not None
                    and np.array_equal(rj, rt) and np.array_equal(lj, lt)):
                continue
            vj, mj = _gain64(rj, lj, g, h, l2, params)
            vt, mt = _gain64(rt, lt, g, h, l2, params)
            assert abs(vj - vt) <= 1e-9 * max(1.0, mj, mt), (
                f"tree {t} split {s}: the packages split differently with "
                f"f64 gains {vj!r} (JAX) and {vt!r} (port)")
            return t, s
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    return None


def check(X, jb, tb, rec, params, ties=None):
    """``compare`` meets ``ties``; with none, the raw predictions agree
    to atol 1e-5 and the model text loads in both packages and predicts
    the same."""
    found = compare(X, jb, tb, rec, params)
    assert found == ties
    if found is not None:
        return
    pj, pt = (b.predict(X, raw_score=True) for b in (jb, tb))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    jax_in_port = lgt.Booster(model_str=jb.model_to_string(),
                              params={"device_type": "cpu"})
    np.testing.assert_allclose(jax_in_port.predict(X, raw_score=True), pj,
                               rtol=0, atol=1e-5)
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(port_in_jax.predict(X, raw_score=True), pt,
                               rtol=0, atol=1e-5)
