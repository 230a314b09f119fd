"""Frontier-batched growth of the port (``tpu_frontier_k`` > 1) on the CPU.

``ops/split.py``'s ``oracle_next_pick`` and ``frontier_topk`` equal the
JAX package's on seeded inputs with ties, -inf, NaN and k=1.  Trees of
the port's frontier equal the port's K=1 trees bit for bit -- model text
minus its ``[param]`` lines, predictions, and the row order of both row
buffers after each tree (the tree-end undo included) -- also at num_leaves
budgets that K does not divide and where the replay prunes speculative
splits; and they have the JAX frontier's structure (``tpu_frontier_k=K``
with ``tpu_megakernel=xla``) with leaf values within the repo's bar (rtol
1e-4 / atol 1e-5: the two packages sum f32 gradients in other orders).
The spec's parsing, errors and fallback follow the JAX learner's.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models import learner as lm
from lightgbm_tpu_torch.ops import split as tsplit
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel):
    d = np.loadtxt(os.path.join(ROOT, "examples", rel))
    return d[:, 1:], d[:, 0]


BINARY = "binary_classification/binary.train"
# 15 leaves on binary.train stays clear of the packages' f32 near-ties
# (ROADMAP.md C)
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1}


def _trees(bst):
    """Model text minus the [param] lines (tpu_frontier_k differs)."""
    return [ln for ln in bst.model_to_string().splitlines()
            if not ln.startswith("[")]


def _train_port(X, y, rounds=3, **params):
    """Train on the CPU, keeping both row buffers after each tree."""
    bst = lgt.Booster(dict(BASE, device_type="cpu", **params),
                      lgt.Dataset(X, label=y))
    bufs = []
    for _ in range(rounds):
        bst.update()
        pb, pg = bst._gbdt._phys
        bufs.append((pb.clone(), pg.view(torch.int32).clone()))
    return bst, bufs


def _same_bufs(a, b):
    return all(torch.equal(x, y) and torch.equal(u, v)
               for (x, u), (y, v) in zip(a, b))


# ---- the elections against the JAX package ------------------------------

def _scores(rng, n, kind):
    if kind == "ties":
        return rng.choice([0.5, 1.0, 2.0], n).astype(np.float32)
    if kind == "special":
        return rng.choice([1.0, 2.0, -np.inf, np.nan, np.inf, 0.5],
                          n).astype(np.float32)
    return rng.randn(n).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "special"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_oracle_pick_and_topk_equal_jax(kind, k):
    """One shape of 40 items (the JAX calls compile once a k)."""
    import jax.numpy as jnp
    rng = np.random.RandomState(k)
    n = 40
    for _ in range(12):
        s = _scores(rng, n, kind)
        req = int(rng.randint(n))
        ji, jo = jsplit.frontier_topk(jnp.asarray(s), req, k)
        ti, to = tsplit.frontier_topk(torch.as_tensor(s), req, k)
        assert np.array_equal(np.asarray(ji), ti.numpy()), (s, req, k)
        assert np.array_equal(np.asarray(jo), to.numpy()), (s, req, k)
        slots = rng.permutation(n).astype(np.int32)
        slots[rng.rand(n) < 0.3] = 3            # ties of the slots too
        avail = rng.rand(n) < 0.6
        a = jsplit.oracle_next_pick(jnp.asarray(s), jnp.asarray(slots),
                                    jnp.asarray(avail))
        b = tsplit.oracle_next_pick(torch.as_tensor(s),
                                    torch.as_tensor(slots),
                                    torch.as_tensor(avail))
        assert int(a[0]) == int(b[0])
        assert np.array_equal(np.float32(a[1]), b[1].numpy(),
                              equal_nan=True)


def test_oracle_pick_nan_and_empty():
    """A NaN among the available gains makes the maximum NaN and the item
    0 in both packages (the replay then stops the tree, as the K=1
    election stops at a NaN gain); nothing available gives -inf."""
    import jax.numpy as jnp
    g = np.array([1.0, np.nan, 3.0, 2.0], np.float32)
    slots = np.array([3, 2, 1, 0], np.int32)
    for avail in ([True, True, True, False], [False] * 4):
        a = jsplit.oracle_next_pick(jnp.asarray(g), jnp.asarray(slots),
                                    jnp.asarray(avail))
        b = tsplit.oracle_next_pick(torch.as_tensor(g),
                                    torch.as_tensor(slots),
                                    torch.as_tensor(avail))
        assert int(a[0]) == int(b[0]) == 0
        assert np.array_equal(np.float32(a[1]), b[1].numpy(),
                              equal_nan=True)
        assert not float(b[1]) > 0


# ---- trees: the port's frontier against its K=1 and the JAX frontier -----

@pytest.fixture(scope="module")
def k1():
    X, y = _load(BINARY)
    return X, y, _train_port(X, y)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_frontier_trees_equal_k1_and_jax(k1, k):
    X, y, (b1, bufs1) = k1
    bk, bufsk = _train_port(X, y, tpu_frontier_k=k)
    assert bk._gbdt.learner.K == k
    assert _trees(bk) == _trees(b1)
    assert np.array_equal(bk.predict(X, raw_score=True),
                          b1.predict(X, raw_score=True))
    assert _same_bufs(bufsk, bufs1)
    jb = lgb.train(dict(BASE, tpu_megakernel="xla", tpu_frontier_k=k),
                   lgb.Dataset(X, label=y), num_boost_round=2)
    assert jb._gbdt.learner.frontier_k == k
    for a, b in zip(jb._gbdt.models, bk._gbdt.models):
        assert a.num_leaves == b.num_leaves
        for f in ("split_feature", "threshold_bin", "left_child",
                  "right_child", "leaf_count"):
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), f
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("leaves,k", [(8, 5), (12, 4), (15, 7)])
def test_frontier_budget_boundary(leaves, k):
    """Budgets that K does not divide: the final steps shrink k_step and
    the replay prunes speculative splits; trees and row order stay K=1's
    (examples/regression, 31 leaves of data)."""
    X, y = _load("regression/regression.train")
    kw = dict(objective="regression", num_leaves=leaves)
    b1, bufs1 = _train_port(X, y, **kw)
    bk, bufsk = _train_port(X, y, tpu_frontier_k=k, **kw)
    assert _trees(bk) == _trees(b1)
    assert _same_bufs(bufsk, bufs1)
    lr = bk._gbdt.learner
    assert 0 <= lr.last_made - (bk._gbdt.models[-1].num_leaves - 1) <= k - 1


@pytest.mark.parametrize("min_gain", [5.0, 1e9])
def test_frontier_trees_that_stop_early(min_gain):
    """Trees that stop before the budget (a large min_gain_to_split), down
    to stumps, equal K=1's: the replay stops on a gain that is not > 0."""
    X, y = _load(BINARY)
    kw = dict(num_leaves=31, min_gain_to_split=min_gain)
    b1, bufs1 = _train_port(X, y, rounds=2, **kw)
    bk, bufsk = _train_port(X, y, rounds=2, tpu_frontier_k=3, **kw)
    assert _trees(bk) == _trees(b1)
    assert _same_bufs(bufsk, bufs1)
    leaves = [t.num_leaves for t in bk._gbdt.models]
    assert all(n < 31 for n in leaves) and (min_gain < 1e9 or leaves == [1, 1])


def test_frontier_prune_engages_and_stays_bitidentical():
    """After JAX's test of the same name: masked gradients and a bag count
    at a binding budget make children outrank speculative picks, so some
    speculative splits are pruned (made > committed, by at most K-1); the
    record, leafmat, nodemat and both row buffers equal K=1's."""
    X, y = _load(BINARY)
    g0 = (0.5 - y).astype(np.float32)
    K = 4
    pruned = 0
    for seed in range(6):
        mask = np.random.RandomState(seed).rand(len(y)) < 0.55
        out = {}
        for k in (1, K):
            bst = lgt.Booster(dict(BASE, num_leaves=12, device_type="cpu",
                                   tpu_frontier_k=k), lgt.Dataset(X, label=y))
            lr = bst._gbdt.learner
            pb, pg = bst._gbdt._phys
            ids = pg[2].view(torch.int32)[lr.row0:lr.row0 + lr.N].long()
            m = torch.as_tensor(mask)[ids]
            pg[0, lr.row0:lr.row0 + lr.N] = torch.where(
                m, torch.as_tensor(g0)[ids], torch.zeros(()))
            pg[1, lr.row0:lr.row0 + lr.N] = torch.where(
                m, torch.full((), 0.25), torch.zeros(()))
            lr.bag.fill_(int(mask.sum()))
            rec = lr.build_tree(pb, pg)
            out[k] = (rec, lr.leafmat.clone(), lr.nodemat.clone(),
                      pb.clone(), pg.clone(), lr.last_made)
        (a, la, na, pa, ga, _), (b, lb, nb, pbk, gbk, made) = out[1], out[K]
        for field in a:
            assert np.array_equal(np.asarray(a[field]),
                                  np.asarray(b[field])), (seed, field)
        for u, v in ((la, lb), (na, nb), (ga, gbk)):
            assert torch.equal(u.view(torch.int32), v.view(torch.int32))
        assert torch.equal(pa, pbk)
        assert made - b["s"] <= K - 1
        pruned += int(made > b["s"])
    assert pruned > 0, "no seed engaged pruning: the case tests nothing"


# ---- the spec: parsing, errors and the fallback ---------------------------

def _k(params):
    return lm.frontier_k(Config(dict(BASE, **params)), True, 15, "cpu")


def test_frontier_k_plumbing():
    assert _k({}) == 1                              # auto: 1 on the CPU
    assert _k({"tpu_frontier_k": "auto"}) == 1
    assert lm.frontier_k(Config(BASE), True, 15, "cuda") == \
        lm.AUTO_FRONTIER_K
    assert _k({"tpu_frontier_k": 6}) == 6
    assert _k({"tpu_frontier_k": 99}) == 14         # capped at L - 1
    assert _k({"tpu_frontier_k": 1}) == 1
    for bad in (0, "bogus", -2):
        with pytest.raises(ValueError):
            _k({"tpu_frontier_k": bad})


def test_frontier_falls_back_to_k1_on_the_subtraction_path():
    """tpu_megakernel=off with K > 1 logs the JAX package's warning and
    trains with K=1, the same trees as K=1."""
    X, y = _load(BINARY)
    seen = []
    from lightgbm_tpu_torch.utils import log
    log.register_callback(seen.append)
    try:
        b = lgt.train(dict(BASE, device_type="cpu", tpu_megakernel="off",
                           tpu_frontier_k=4, verbosity=1),
                      lgt.Dataset(X, label=y), num_boost_round=2)
    finally:
        log.register_callback(None)
    assert b._gbdt.learner.K == 1
    assert any("tpu_frontier_k=4" in m and "using 1" in m for m in seen)
    b1 = lgt.train(dict(BASE, device_type="cpu", tpu_megakernel="off"),
                   lgt.Dataset(X, label=y), num_boost_round=2)
    assert _trees(b) == _trees(b1)


def test_bfloat16_pair_trains_the_exact_path():
    """tpu_hist_dtype=bfloat16_pair is accepted as a name for the exact
    path: the same trees as float32, on both split bodies."""
    X, y = _load(BINARY)
    for body in ({}, {"tpu_megakernel": "off"}):
        a = lgt.train(dict(BASE, device_type="cpu", **body),
                      lgt.Dataset(X, label=y), num_boost_round=2)
        b = lgt.train(dict(BASE, device_type="cpu",
                           tpu_hist_dtype="bfloat16_pair", **body),
                      lgt.Dataset(X, label=y), num_boost_round=2)
        assert _trees(a) == _trees(b)
