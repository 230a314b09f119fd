"""Quantized-gradient training end to end (``use_quantized_grad``):
``lightgbm_tpu_torch.train`` (``device_type`` cpu) against the JAX
package on ``examples/binary_classification``, 15 leaves, 4 trees, on
every body of the port -- the mega path at K=1 and K=4 and the
histogram-subtraction path -- with ``quant_train_renew_leaf`` off and on
(``examples/regression`` in test_torch_quantized_regression.py).  The
JAX package grows its default K=1 trees; the frontier's trees are K=1's.

The histograms sum integer carriers, exact in f32 at these sizes, so the
trees are held to the JAX package's split for split (``compare``):
every split partitions the training rows as JAX's does, and every tree
has its leaf values within rtol 1e-4 / atol 1e-5.  Where they part, the
two splits must tie exactly: their gains recounted in f64 from the
tree's own carriers times its scale (the port's, captured as it
discretizes; the JAX package's are the same bit for bit,
test_torch_quantized.py) agree to 1e-9 of the gains' mass.  ``ties``
records the (tree, split) of such a tie per case (ROADMAP section C).
Raw predictions then agree to atol 1e-5 where no tie was met, and the
model text loads in both packages.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models.boosting import GBDT, scores_from_phys

from test_torch_categorical_trees import _gain64, _l2_of
from test_torch_train import _leaf_sets
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 4
BASE = {"num_leaves": 15, "verbosity": -1, "use_quantized_grad": True}
BODIES = {"mega_k1": {"tpu_frontier_k": 1},
          "mega_k4": {"tpu_frontier_k": 4},
          "subtraction": {"tpu_megakernel": "off"}}


def example(name):
    d = np.loadtxt(os.path.join(ROOT, "examples", name))
    return d[:, 1:], d[:, 0]


@contextlib.contextmanager
def carriers():
    """Each tree's (grad, hess) as its histograms sum them -- the integer
    carriers times the scale, f64 in original row order -- recorded as
    the port discretizes."""
    out = []
    orig = GBDT._quantize

    def record(self, ghi, eager):
        orig(self, ghi, eager)
        s = self.learner.qscale.double()
        out.append(tuple((scores_from_phys(ghi, self.num_data, r).double()
                          * s[r]).numpy() for r in (0, 1)))

    with mock.patch.object(GBDT, "_quantize", record):
        yield out


def train_port(X, y, params, rounds=ROUNDS, **ds_kw):
    """The port's booster (cpu) and its trees' carriers."""
    with carriers() as rec:
        tb = lgt.train(dict(BASE, device_type="cpu", **params),
                       lgt.Dataset(X, label=y, **ds_kw), rounds)
    return tb, rec


def train_jax(X, y, params, rounds=ROUNDS, **ds_kw):
    jb = lgb.train(dict(BASE, **params), lgb.Dataset(X, label=y, **ds_kw),
                   rounds)
    jb.num_trees()
    return jb


def compare(X, jb, tb, rec, params):
    """The first (tree, split) where the packages part, after checking it
    is an exact tie; None when every tree agrees (see module doc)."""
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    leaves_j = np.asarray(jb.predict(X, pred_leaf=True))
    leaves_t = np.asarray(port_in_jax.predict(X, pred_leaf=True))
    np.testing.assert_array_equal(leaves_t, tb.predict(X, pred_leaf=True))
    mappers = tb._gbdt.train_data.bin_mappers
    models = list(zip(jb._gbdt.models, tb._gbdt.models))
    assert len(jb._gbdt.models) == len(tb._gbdt.models) == len(rec)
    for t, (a, b) in enumerate(models):
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
            vj, mj = _gain64(rj, lj, g, h, _l2_of(a, s, mappers, params),
                             params)
            vt, mt = _gain64(rt, lt, g, h, _l2_of(b, s, mappers, params),
                             params)
            assert abs(vj - vt) <= 1e-9 * max(1.0, mj, mt), (
                f"tree {t} split {s}: the packages split differently with "
                f"f64 gains {vj!r} (JAX) and {vt!r} (port)")
            return t, s
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    return None


def check(X, jb, tb, rec, params, ties=None):
    """``compare``, the recorded tie, and with none the raw predictions
    and the model text both ways."""
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


def run_bodies(X, y, objective, renew, jax_cache):
    """One JAX booster, the port's three bodies against it."""
    params = {"objective": objective, "quant_train_renew_leaf": renew}
    key = (objective, renew)
    if key not in jax_cache:
        jax_cache[key] = train_jax(X, y, params)
    return params, jax_cache[key]


@pytest.fixture(scope="module")
def jax_boosters():
    return {}


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("renew", [False, True], ids=["plain", "renew"])
def test_binary_trees_match_jax(body, renew, jax_boosters):
    X, y = example("binary_classification/binary.train")
    params, jb = run_bodies(X, y, "binary", renew, jax_boosters)
    tb, rec = train_port(X, y, dict(params, **BODIES[body]))
    lr = tb._gbdt.learner
    assert lr.subtract == (body == "subtraction")
    assert lr.K == (4 if body == "mega_k4" else 1)
    assert lr.qscale is not None
    assert (tb._gbdt._renew_rows == (5, 6)) == renew
    check(X, jb, tb, rec, params)
