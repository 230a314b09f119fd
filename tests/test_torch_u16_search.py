"""The plain searches of the port past 256 bins against the JAX
package, on the CPU: ``split_pair_plain`` at BF = 1024 (prefix_sum's
blocks of 32 bins a lane) and ``split_cat_plain`` on a 389-bin
categorical (sets of 13 words).

Tolerances (ROADMAP's parity bar): the pair search's integer fields
equal ``find_best_split_fast``'s and its sums agree to rtol 1e-5 (f64
prefix sums against JAX's f32 ones); the categorical search's gain
agrees to rtol 1e-5 and its set and left count are JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.ops import split_cat as scat
from lightgbm_tpu_torch.ops import split_pair as sp
from torch_one_thread import one_torch_thread  # noqa: F401


def _wide_pair(seed, F=4, BF=1024):
    rng = np.random.RandomState(seed)
    nb = np.array([BF, 700, 300, 1000][:F], np.int32)
    miss = np.array([0, 1, 2, 2][:F], np.int32)
    dflt = np.where(miss == 1, 5, 0).astype(np.int32)
    hist = np.zeros((F, BF, 2), np.float32)
    for f in range(F):
        hist[f, :nb[f], 0] = rng.normal(size=nb[f])
        hist[f, :nb[f], 1] = rng.uniform(0.01, 2.0, size=nb[f])
    return nb, miss, dflt, hist


@pytest.mark.parametrize("seed", [0, 1])
def test_split_pair_plain_at_1024_bins_equals_find_best_split_fast(seed):
    """split_pair_plain at BF = 1024 (prefix_sum's blocks of 32 bins a
    lane) against JAX find_best_split_fast on each child."""
    F, BF = 4, 1024
    hists, infos = [], []
    for c in range(2):
        nb, miss, dflt, hist = _wide_pair(10 * seed + c)
        info = np.zeros((F, 8), np.float32)
        info[:, 0] = hist[0, :, 0].sum()
        info[:, 1] = hist[0, :, 1].sum()
        info[:, 2] = 40000 + 1000 * c
        info[:, 4] = 1.0
        hists.append(hist)
        infos.append(info)
    half = np.zeros((F, 8), np.int32)
    half[:, 0], half[:, 1], half[:, 2] = nb, miss, dflt
    p = dict(l1=0.0, l2=1e-3, max_delta_step=0.0, min_gain_to_split=0.0,
             min_data_in_leaf=20, min_sum_hessian=1e-3, max_depth=0)
    got = sp.split_pair(
        torch.as_tensor(np.concatenate([h[..., 0] for h in hists])),
        torch.as_tensor(np.concatenate([h[..., 1] for h in hists])),
        torch.as_tensor(np.concatenate([half, half])),
        torch.as_tensor(np.concatenate(infos)), **p).numpy()
    ctx = jsplit.SplitContext(jnp.asarray(nb), jnp.asarray(miss),
                              jnp.asarray(dflt), jnp.zeros(F, jnp.int32),
                              jnp.arange(F, dtype=jnp.int32))
    for c in range(2):
        info = infos[c]
        ref = jsplit.find_best_split_fast(
            jnp.asarray(hists[c]), ctx, jnp.float32(info[0, 0]),
            jnp.float32(info[0, 1]), jnp.int32(info[0, 2]), p["l1"],
            p["l2"], p["max_delta_step"], p["min_gain_to_split"],
            p["min_data_in_leaf"], p["min_sum_hessian"],
            jnp.asarray(info[:, 4] > 0))
        row = got[c]
        ints = row[1:6].view(np.int32)
        assert ints[0] == int(ref.feature) and ints[1] == int(ref.threshold)
        assert bool(row[3] > 0.5) == bool(ref.default_left)
        assert ints[3] == int(ref.left_count)
        assert ints[4] == int(ref.right_count)
        scale = max(abs(float(info[0, 0])), float(info[0, 1]), 1.0)
        np.testing.assert_allclose(
            row[[6, 7]], [float(ref.left_sum_g), float(ref.left_sum_h)],
            rtol=1e-5, atol=1e-5 * scale)


def test_split_cat_plain_at_389_bins_equals_jax():
    """split_cat_plain on a 389-bin categorical (sets of 13 words)
    against JAX find_best_split_categorical: the gain to rtol 1e-5, the
    same set of bins and left count."""
    rng = np.random.RandomState(2)
    F, BF, nb = 2, 400, 389
    hist = np.zeros((F, BF, 2), np.float32)
    hist[:, 1:nb, 1] = rng.uniform(5.0, 40.0, (F, nb - 1))
    hist[:, 1:nb, 0] = rng.normal(size=(F, nb - 1)) * hist[:, 1:nb, 1] * 0.3
    info = np.zeros((F, 8), np.float32)
    info[:, 0] = hist[0, :, 0].sum()
    info[:, 1] = hist[0, :, 1].sum()
    info[:, 2] = np.floor(info[0, 1] * 4)
    info[:, 4] = 1.0
    kw = dict(l1=0.0, l2=0.0, max_delta_step=0.0, min_gain_to_split=0.0,
              min_data_in_leaf=20, min_sum_hessian=1e-3, max_depth=0,
              max_cat_threshold=32, cat_l2=10.0, cat_smooth=10.0,
              max_cat_to_onehot=4, min_data_per_group=100)
    half = np.zeros((F, 8), np.int32)
    half[:, 0], half[:, 1], half[:, 3] = nb, 2, 1
    hg = torch.as_tensor(np.concatenate([hist[..., 0]] * 2))
    hh = torch.as_tensor(np.concatenate([hist[..., 1]] * 2))
    fm = torch.as_tensor(np.concatenate([half] * 2))
    tinfo = torch.as_tensor(np.concatenate([info] * 2))
    pair = torch.full((2, 13), float("-inf"))
    pair[:, 1] = torch.tensor([F, F], dtype=torch.int32).view(torch.float32)
    W = tpart.cat_words(BF)
    sets = torch.zeros((2, W), dtype=torch.int32)
    scat.split_cat(hg, hh, fm, tinfo, torch.arange(F, dtype=torch.int32),
                   pair, sets, **{k: v for k, v in kw.items()})
    ctx = jsplit.SplitContext(jnp.full(F, nb, jnp.int32),
                              jnp.full(F, 2, jnp.int32),
                              jnp.zeros(F, jnp.int32),
                              jnp.ones(F, jnp.int32),
                              jnp.arange(F, dtype=jnp.int32))
    sum_h_tot = jnp.float32(info[0, 1]) + 2 * 1e-15
    mgs = jsplit.leaf_gain(jnp.float32(info[0, 0]), sum_h_tot, 0.0, 0.0,
                           0.0)
    gain, member, lg, lh, lc, _ = jsplit.find_best_split_categorical(
        jnp.asarray(hist), ctx, jnp.float32(info[0, 0]), sum_h_tot,
        jnp.float32(info[0, 2]), 0.0, 0.0, 0.0, mgs, 20, 1e-3, 32, 10.0,
        10.0, 4, 100)
    k = int(np.argmax(np.asarray(gain)))
    row = pair[0].numpy()
    assert row[12] == 1.0 and row[1:2].view(np.int32)[0] == k
    np.testing.assert_allclose(row[0], float(gain[k]) - float(mgs),
                               rtol=1e-5)
    assert row[4:5].view(np.int32)[0] == int(lc[k])
    words = sets[0].numpy().view(np.uint32).astype(np.int64)
    got = ((words[:, None] >> np.arange(32)) & 1).reshape(-1)[:BF] != 0
    np.testing.assert_array_equal(got, np.asarray(member[k]))
    assert got[nb:].sum() == 0 and W == 13
