"""Row and feature sampling of the port against the JAX package, on the
CPU: the port's copy of ``jax.random`` (utils/random.py), the sampling
pass of the fused iteration (ops/sample.py) and the feature mask.

Everything here is bit for bit: the draws are integer arithmetic, and
the masks, GOSS scales and in-bag counts follow from the same f32
comparisons and products.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import sample as smp
from lightgbm_tpu_torch.utils import random as jr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 3, 12345, 2 ** 31 - 1, -5]
LENGTHS = [1, 2, 7, 1000, 1023]


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _key(seed):
    return jax.random.PRNGKey(seed)


# ---- utils/random.py against jax.random ---------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in(seed):
    k, kk = _key(seed), jr.PRNGKey(seed)
    np.testing.assert_array_equal(_bits(k), kk)
    for n in (2, 3, 5):
        np.testing.assert_array_equal(_bits(jax.random.split(k, n)),
                                      jr.split(kk, n))
    for d in (0, 1, 6, 1000, 2 ** 31 + 7):
        np.testing.assert_array_equal(_bits(jax.random.fold_in(k, d)),
                                      jr.fold_in(kk, d))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform(seed):
    k, kk = _key(seed), jr.PRNGKey(seed)
    for n in LENGTHS:
        np.testing.assert_array_equal(_bits(jax.random.bits(k, (n,))),
                                      jr.random_bits(kk, (n,)))
        want = _bits(jax.random.uniform(k, (n,)))
        np.testing.assert_array_equal(jr.uniform(kk, (n,)).view(np.uint32),
                                      want)
        got = jr.torch_uniform_at(kk, torch.arange(n)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want)
    np.testing.assert_array_equal(_bits(jax.random.bits(k, (3, 5))),
                                  jr.random_bits(kk, (3, 5)))


@pytest.mark.parametrize("seed", SEEDS)
def test_permutation(seed):
    """One sort round below 1,626 values, two above (JAX ``_shuffle``)."""
    k, kk = _key(seed), jr.PRNGKey(seed)
    for n in (1, 2, 5, 28, 284, 1700):
        want = np.asarray(jax.random.permutation(k, n))
        np.testing.assert_array_equal(jr.permutation(kk, n), want)
        np.testing.assert_array_equal(
            jr.torch_permutation(kk, n, "cpu").numpy(), want)


# ---- the sampling pass against the JAX fused step's arithmetic ----------
def _payload(seed, N=1500, Npad=2048, C=256):
    """A payload as the fused iteration lays it out: rows in a shuffled
    physical order between pad rows (row id N), grad/hess 0 on pads."""
    rng = np.random.RandomState(seed)
    ghi = np.zeros((8, Npad), np.float32)
    rid = np.full(Npad, N, np.int32)
    rid[C:C + N] = rng.permutation(N)
    real = rid != N
    g = rng.randn(Npad).astype(np.float32)
    g[rng.rand(Npad) < 0.05] = 0.25            # ties in |g h|
    h = (rng.rand(Npad) + 0.05).astype(np.float32)
    ghi[0] = np.where(real, g, 0)
    ghi[1] = np.where(real, h, 0)
    ghi[2] = rid.view(np.float32)
    ghi[4] = np.where(rng.rand(Npad) < 0.3, 1.0, -1.0) * real
    return ghi, N


def _jax_step(ghi, N, mode, key, frac=1.0, pos=1.0, neg=1.0, top_k=1,
              other_k=1):
    """The JAX package's in-program sampling (boosting.py
    ``_setup_fused_phys`` ``step``), line for line on the payload."""
    ghi = jnp.asarray(ghi)
    rowid = jax.lax.bitcast_convert_type(ghi[2], jnp.int32)
    vf = (rowid != N).astype(jnp.float32)
    g, h = ghi[0], ghi[1]
    if mode == smp.MODE_GOSS:
        imp = jnp.abs(g * h)
        threshold = jax.lax.top_k(imp, top_k)[0][-1]
        is_top = (imp >= threshold) & (vf > 0)
        n_top = jnp.sum(is_top.astype(jnp.int32))
        rest = jnp.maximum(N - n_top, 1)
        prob = other_k / rest.astype(jnp.float32)
        keep = (~is_top) & (vf > 0) & (jax.random.uniform(key, g.shape)
                                       < prob)
        mult = (N - top_k) / other_k
        scale = jnp.where(is_top, 1.0, jnp.where(keep, mult, 0.0))
        return g * scale, h * scale, jnp.sum((is_top | keep).astype(
            jnp.int32))
    u = jnp.take(jax.random.uniform(key, (N + 1,)), jnp.minimum(rowid, N))
    if mode == smp.MODE_BAG:
        sel = (u < frac) & (vf > 0)
    else:
        sel = jnp.where(ghi[4] > 0, u < pos, u < neg) & (vf > 0)
    sf = sel.astype(jnp.float32)
    return g * sf, h * sf, jnp.sum(sel.astype(jnp.int32))


CASES = {
    "bag": (smp.MODE_BAG, dict(frac=0.7)),
    "bag_small": (smp.MODE_BAG, dict(frac=0.05)),
    "balanced": (smp.MODE_BALANCED, dict(pos=0.5, neg=0.9)),
    "goss": (smp.MODE_GOSS, dict(top_k=300, other_k=150)),
    "goss_ties": (smp.MODE_GOSS, dict(top_k=1, other_k=1499)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_plain_equals_jax_step(case, seed):
    mode, kw = CASES[case]
    ghi, N = _payload(seed)
    key = jr.fold_in(jr.PRNGKey(3), seed + 1)
    jg, jh, jcnt = _jax_step(ghi, N, mode, jnp.asarray(key), **kw)
    t = torch.tensor(ghi)
    bag = torch.zeros(1, dtype=torch.int32)
    args = dict(N=N, key=key)
    if mode == smp.MODE_GOSS:
        thr, n_top = smp.goss_threshold(t, N, kw["top_k"])
        args.update(thr=thr, n_top=n_top, other_k=kw["other_k"],
                    mult=(N - kw["top_k"]) / kw["other_k"])
    elif mode == smp.MODE_BAG:
        args.update(frac=kw["frac"])
    else:
        args.update(pos_frac=kw["pos"], neg_frac=kw["neg"], sign_row=4)
    smp.sample(t, bag, mode, **args)
    assert int(bag[0]) == int(jcnt) > 0
    # equal values; an out-of-bag zero may differ in sign: these eager
    # ops keep g * 0 = -0, the compiled fused program folds the product
    # into a select (+0), as the port does (test_torch_sampling_iter.py)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(jg))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(jh))
    np.testing.assert_array_equal(t[2:].numpy().view(np.int32),
                                  ghi[2:].view(np.int32))


def _load():
    d = np.loadtxt(os.path.join(ROOT, "examples", "binary_classification",
                                "binary.train"))
    return d[:, 1:], d[:, 0]


def test_feature_masks_as_jax():
    """The host feature mask, iteration after iteration, from the same
    ``feature_fraction_seed``."""
    X, y = _load()
    p = {"objective": "binary", "verbosity": -1, "feature_fraction": 0.6,
         "feature_fraction_seed": 11}
    jb = lgb.Booster(dict(p, tpu_frontier_k=1), lgb.Dataset(X, label=y))
    tb = lgt.Booster(dict(p, device_type="cpu"), lgt.Dataset(X, label=y))
    F = tb._gbdt.learner.F
    for it in range(4):
        want = np.asarray(jb._gbdt._feature_mask(it))
        got = tb._gbdt._feature_mask()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == int(F * 0.6)


def test_feature_mask_reaches_the_pair_search():
    """The mask set on the learner is the IN_MASK column of every child's
    info rows, and no split uses a masked feature."""
    X, y = _load()
    tb = lgt.Booster({"objective": "binary", "verbosity": -1,
                      "device_type": "cpu", "num_leaves": 15},
                     lgt.Dataset(X, label=y))
    lr = tb._gbdt.learner
    mask = np.zeros(lr.F, bool)
    mask[[0, 3, 6, 8]] = True
    lr.set_feature_mask(mask)
    tb._gbdt.train_one_iter()
    np.testing.assert_array_equal(lr.info[:, 4].numpy(),
                                  np.tile(mask.astype(np.float32), 2))
    t = tb._gbdt.models[-1]
    assert t.num_leaves > 2
    assert set(t.split_feature[:t.num_nodes()].tolist()) <= {0, 3, 6, 8}
