"""Categorical features in the port against the JAX package, on the CPU:
bin mappers, bins and EFB groups, and the categorical split search.

Tolerances: bin mappers (``to_dict``), the binned matrix, the groups and
the feature metadata (``is_categorical`` included) are identical.  The
search: ``ops/split_cat.py`` forms its prefix sums in f64 rounded to f32
(as the pair search does) where JAX's ``find_best_split_categorical``
sums in f32, so each feature's best gain agrees to rtol 1e-5, and its
set and left count are identical unless the two choices tie: where the
sets differ, both sets' gains recounted in f64 from the histogram must
agree to 1e-6 of the gain.  The merged row (the numerical pair search,
then the categorical search) is held to JAX's ``find_best_split`` by the
same rule.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split_cat as scat
from lightgbm_tpu_torch.ops import split_pair as sp


def cat_data(n=3000, seed=0, bundle=False):
    """A 12-level categorical with NaN, negative and rare values, a
    3-level one, two numerical columns; with ``bundle``, a mostly-NaN
    categorical (default and most frequent bin 0) and a mostly-zero
    numerical column on other rows, which EFB bundles together."""
    rng = np.random.RandomState(seed)
    c12 = rng.randint(0, 12, n).astype(float)
    c12[rng.rand(n) < 0.05] = np.nan
    c12[rng.rand(n) < 0.02] = -1
    c12[:4] = 50                                    # rare
    c3 = rng.randint(0, 3, n).astype(float)
    x1, x2 = rng.randn(n), rng.randn(n)
    y = (np.isin(c12, (2, 5, 7, 11)) * 2.0 + (c3 == 1) * 0.7 + 0.3 * x1
         + 0.1 * rng.randn(n))
    cols = [c12, x1, c3, x2]
    if bundle:
        r = rng.rand(n)
        sparse = np.where(r < 0.2, rng.randint(1, 7, n), np.nan)
        znum = np.where((r >= 0.2) & (r < 0.3), rng.rand(n) + 0.1, 0.0)
        y = y + np.isin(sparse, (2, 4)) * 2.5 + znum
        cols += [sparse, znum]
    return np.column_stack(cols), y


CATS = {False: [0, 2], True: [0, 2, 4]}


@pytest.mark.parametrize("bundle", [False, True])
def test_bin_mappers_bins_and_groups_equal_jax(bundle):
    X, y = cat_data(bundle=bundle)
    params = {"objective": "regression", "verbosity": -1,
              "min_data_in_bin": 3}
    jd = lgb.Dataset(X, label=y, categorical_feature=CATS[bundle],
                     params=params).construct()._inner
    td = lgt.Dataset(X, label=y, categorical_feature=CATS[bundle],
                     params=dict(params, device_type="cpu")
                     ).construct()._inner
    assert [bm.to_dict() for bm in td.bin_mappers] == \
        [bm.to_dict() for bm in jd.bin_mappers]
    for bt, bj in zip(td.bin_mappers, jd.bin_mappers):
        assert bt.categorical_2_bin == bj.categorical_2_bin
        assert bt.feature_info() == bj.feature_info()
    assert [(g.feature_indices, g.bin_offsets, g.num_total_bin)
            for g in td.groups] == \
        [(g.feature_indices, g.bin_offsets, g.num_total_bin)
         for g in jd.groups]
    np.testing.assert_array_equal(td.binned, np.asarray(jd.host_binned()))
    mt, mj = td.feature_meta_arrays(), jd.feature_meta_arrays()
    for k in mt:
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
    assert mt["is_categorical"].sum() == len(CATS[bundle])
    if bundle:
        assert any(len(g.feature_indices) > 1 and 4 in g.feature_indices
                   for g in td.groups)
    # unseen, NaN and negative values bin like JAX's, with and without
    # the out-of-vocabulary sentinel
    q = np.array([np.nan, -3.0, 50.0, 2.7, 1e9, 0.0, 11.0])
    for bt, bj in zip(td.bin_mappers, jd.bin_mappers):
        for oov in (False, True):
            if bt.bin_type == 1:
                np.testing.assert_array_equal(bt.values_to_bins(q, oov),
                                              bj.values_to_bins(q, oov))


SEARCH_PARAMS = {
    "defaults": dict(max_cat_threshold=32, cat_l2=10.0, cat_smooth=10.0,
                     max_cat_to_onehot=4, min_data_per_group=100,
                     min_data_in_leaf=20),
    "threshold2": dict(max_cat_threshold=2, cat_l2=0.0, cat_smooth=1.0,
                       max_cat_to_onehot=4, min_data_per_group=10,
                       min_data_in_leaf=5),
    "onehot": dict(max_cat_threshold=32, cat_l2=10.0, cat_smooth=10.0,
                   max_cat_to_onehot=32, min_data_per_group=50,
                   min_data_in_leaf=10),
    "l1_mds": dict(max_cat_threshold=8, cat_l2=5.0, cat_smooth=50.0,
                   max_cat_to_onehot=4, min_data_per_group=200,
                   min_data_in_leaf=20, l1=0.5, max_delta_step=0.7),
    "group1": dict(max_cat_threshold=16, cat_l2=1.0, cat_smooth=0.0,
                   max_cat_to_onehot=2, min_data_per_group=1,
                   min_data_in_leaf=1, min_sum_hessian=5.0),
}


def _search_kw(p):
    kw = dict(l1=0.0, l2=0.1, max_delta_step=0.0, min_gain_to_split=0.0,
              min_sum_hessian=1e-3, max_depth=0)
    kw.update(p)
    return kw


def random_hist(seed, F=12, BF=64, nb=None):
    """(F, BF, 2) f32 histograms of one leaf, counts from the hessians,
    with per-feature bin counts (``nb``, default drawn) from one-vs-rest
    to wide sorted sets; every feature's bins hold the same rows."""
    rng = np.random.RandomState(seed)
    if nb is None:
        nb = rng.choice([2, 3, 4, 8, 20, 40, BF], F)
    cnt = rng.randint(0, 300, (F, BF)) * (np.arange(BF)[None] < nb[:, None])
    cnt[:, 0] = rng.randint(0, 300, F)
    n = int(cnt.sum(1).max())
    cnt[:, 0] += n - cnt.sum(1)                     # every row n rows
    h = (cnt * rng.uniform(0.15, 0.25, (F, BF))).astype(np.float32)
    g = (cnt * rng.normal(0, 0.3, (F, BF))
         + rng.normal(0, 0.5, (F, 1)) * cnt).astype(np.float32)
    # every feature's bins sum to the leaf's totals (bin 0 takes the rest)
    g[:, 0] += g.sum(1).mean() - g.sum(1)
    h[:, 0] += h.sum(1).max() - h.sum(1)
    hist = np.stack([g, h], -1)
    return hist, nb.astype(np.int32), n


def _gain64(hist, members, nb, kw):
    """f64 gain of a left set of bins, with the arm's l2."""
    l2 = kw["l2"] + (kw["cat_l2"] if nb > kw["max_cat_to_onehot"] else 0.0)
    G, H = hist[:, 0].astype(np.float64), hist[:, 1].astype(np.float64)
    lg, lh = G[members].sum(), H[members].sum()

    def lgain(g, h):
        s = np.sign(g) * max(abs(g) - kw["l1"], 0.0)
        if kw["max_delta_step"] > 0:
            o = min(max(-s / (h + l2), -kw["max_delta_step"]),
                    kw["max_delta_step"])
            return -(2.0 * s * o + (h + l2) * o * o)
        return s * s / (h + l2)

    return lgain(lg, lh) + lgain(G.sum() - lg, H.sum() - lh)


def _jax_ctx(nb, is_cat):
    F = len(nb)
    z = jnp.zeros(F, jnp.int32)
    return jsplit.SplitContext(
        num_bin=jnp.asarray(nb), missing_type=z, default_bin=z,
        is_categorical=jnp.asarray(is_cat, jnp.int32),
        feature_index=jnp.arange(F, dtype=jnp.int32))


@pytest.mark.parametrize("case", sorted(SEARCH_PARAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_split_cat_per_feature_matches_jax(case, seed):
    kw = _search_kw(SEARCH_PARAMS[case])
    hist, nb, n = random_hist(seed + 10 * len(case))
    F, BF, _ = hist.shape
    sg, sh = hist[0, :, 0].sum(), hist[0, :, 1].sum()
    info = np.zeros((F, 8), np.float32)
    info[:, 0], info[:, 1], info[:, 2], info[:, 4] = sg, sh, n, 1.0
    gain, member, lg, lh, lc, l2e, mgs = scat.per_feature(
        torch.as_tensor(hist[..., 0]), torch.as_tensor(hist[..., 1]),
        torch.as_tensor(nb[:, None]), torch.as_tensor(info), **kw)
    sum_h_tot = jnp.float32(sh) + 2 * jsplit.K_EPSILON
    jmgs = jsplit.leaf_gain(jnp.float32(sg), sum_h_tot, kw["l1"], kw["l2"],
                            kw["max_delta_step"])
    jg, jm, jlg, jlh, jlc, jl2 = jsplit.find_best_split_categorical(
        jnp.asarray(hist), _jax_ctx(nb, np.ones(F)), jnp.float32(sg),
        sum_h_tot, jnp.float32(n), kw["l1"], kw["l2"], kw["max_delta_step"],
        jmgs, kw["min_data_in_leaf"], kw["min_sum_hessian"],
        kw["max_cat_threshold"], kw["cat_l2"], kw["cat_smooth"],
        kw["max_cat_to_onehot"], kw["min_data_per_group"])
    jg, jm = np.asarray(jg), np.asarray(jm)
    np.testing.assert_allclose(gain.numpy(), jg, rtol=1e-5)
    np.testing.assert_allclose(l2e.numpy(), np.asarray(jl2))
    valid = 0
    for f in range(F):
        if not np.isfinite(jg[f]):
            continue
        valid += 1
        mt, mj = member[f].numpy(), jm[f]
        assert not mt[0] and not mj[0]
        if np.array_equal(mt, mj):
            assert float(lc[f]) == float(jlc[f])
            continue
        gt, gj = _gain64(hist[f], mt, nb[f], kw), _gain64(hist[f], mj,
                                                         nb[f], kw)
        assert abs(gt - gj) <= 1e-6 * max(abs(gj), 1.0), (f, gt, gj)
    assert valid >= 3


@pytest.mark.parametrize("case", ["defaults", "threshold2", "onehot"])
def test_merged_search_matches_jax_find_best_split(case):
    """The pair search over the numerical features, then split_cat over
    the categorical ones, per child, against JAX's general search with
    the same feature mask: feature, arm (is_cat), set and gain."""
    kw = _search_kw(SEARCH_PARAMS[case])
    cat_kw = {k: kw.pop(k) for k in ("max_cat_threshold", "cat_l2",
                                     "cat_smooth", "max_cat_to_onehot",
                                     "min_data_per_group")}
    F, C = 12, 2
    rng = np.random.RandomState(len(case))
    is_cat = (np.arange(F) % 3 != 1).astype(np.int32)
    nb = rng.choice([3, 4, 8, 20, 40, 64], F).astype(np.int32)
    hists, infos = [], []
    for c in range(C):
        hist, _, n = random_hist(100 + c + len(case), F, nb=nb)
        info = np.zeros((F, 8), np.float32)
        info[:, 0] = hist[0, :, 0].sum()
        info[:, 1] = hist[0, :, 1].sum()
        info[:, 2], info[:, 4] = n, rng.rand(F) > 0.2
        hists.append(hist)
        infos.append(info)
    half = np.zeros((F, 8), np.int32)
    half[:, 0], half[:, 3] = nb, is_cat
    hg = torch.as_tensor(np.concatenate([h[..., 0] for h in hists]))
    hh = torch.as_tensor(np.concatenate([h[..., 1] for h in hists]))
    fm = torch.as_tensor(np.concatenate([half] * C))
    info = torch.as_tensor(np.concatenate(infos))
    pair = sp.split_pair_plain(hg, hh, fm, info, **kw)
    sets = torch.zeros((C, 8), dtype=torch.int32)
    scat.split_cat(hg, hh, fm, info, torch.as_tensor(
        np.nonzero(is_cat)[0].astype(np.int32)), pair, sets, **kw, **cat_kw)
    for c in range(C):
        inf = info[c * F].numpy()
        best = jsplit.find_best_split(
            jnp.asarray(hists[c]), _jax_ctx(nb, is_cat), jnp.float32(inf[0]),
            jnp.float32(inf[1]), jnp.float32(inf[2]), kw["l1"], kw["l2"],
            kw["max_delta_step"], kw["min_gain_to_split"],
            kw["min_data_in_leaf"], kw["min_sum_hessian"],
            feature_mask=jnp.asarray(infos[c][:, 4] > 0),
            cat_params=cat_kw)
        row = pair[c]
        feat = int(row[1:2].view(torch.int32))
        t_cat = bool(row[12] > 0.5)
        np.testing.assert_allclose(float(row[0]), float(best.gain),
                                   rtol=1e-5)
        assert infos[c][feat, 4] > 0
        if feat == int(best.feature):
            assert t_cat == bool(best.is_cat)
            if t_cat:
                w = sets[c].numpy().astype(np.int64)[:, None] & 0xFFFFFFFF
                bins = np.nonzero(((w >> np.arange(32)) & 1).reshape(-1))[0]
                np.testing.assert_array_equal(
                    bins, np.nonzero(np.asarray(best.cat_set))[0])
        else:   # a tie between two features: equal f32-resolution gains
            assert abs(float(row[0]) - float(best.gain)) <= 2e-7 * abs(
                float(best.gain))


def test_merge_takes_the_smaller_feature_on_equal_gains():
    """JAX's argmax over features: on an equal gain the smaller feature
    wins, the categorical row replaces the numerical one only then or on
    a strictly greater gain; equal gains between two categorical
    features go to the smaller one too."""
    hist, nb, n = random_hist(5, F=4, BF=32)
    nb[:] = 20
    hist[2] = hist[1]                       # two identical features
    hist[:, 20:] = 0
    F = 4
    half = np.zeros((F, 8), np.int32)
    half[:, 0], half[:, 3] = nb, 1
    info = np.zeros((2 * F, 8), np.float32)
    info[:, 0] = hist[0, :, 0].sum()
    info[:, 1] = hist[0, :, 1].sum()
    info[:, 2], info[:, 4] = n, 1.0
    info[[0, 3, 4, 7], 4] = 0.0             # only features 1 and 2 searched
    args = [torch.as_tensor(np.concatenate([hist[..., i]] * 2))
            for i in (0, 1)] + [torch.as_tensor(np.concatenate([half] * 2)),
                                torch.as_tensor(info)]
    kw = _search_kw(SEARCH_PARAMS["threshold2"])
    cats = torch.arange(F, dtype=torch.int32)
    neg = torch.full((2, 13), float("-inf"))
    neg[:, 1] = torch.tensor([F, F], dtype=torch.int32).view(torch.float32)
    first, sets = neg.clone(), torch.zeros((2, 8), dtype=torch.int32)
    scat.split_cat(*args, cats, first, sets, **kw)
    assert int(first[0, 1:2].view(torch.int32)) == 1
    gain = float(first[0, 0])
    assert np.isfinite(gain) and first[0, 12] == 1.0
    for num_feat, cat_wins in ((0, False), (1, False), (3, True)):
        pair = neg.clone()
        pair[:, 0] = gain
        pair[:, 1] = torch.tensor([num_feat] * 2,
                                  dtype=torch.int32).view(torch.float32)
        out = torch.full((2, 8), 5, dtype=torch.int32)
        scat.split_cat(*args, cats, pair, out, **kw)
        assert bool(pair[0, 12] == 1.0) == cat_wins
        assert int(pair[0, 1:2].view(torch.int32)) == (1 if cat_wins
                                                       else num_feat)
        assert torch.equal(out[0], sets[0] if cat_wins
                           else torch.zeros(8, dtype=torch.int32))
    pair = neg.clone()                     # strictly greater: cat wins
    pair[:, 0] = float(np.nextafter(np.float32(gain), np.float32(-np.inf)))
    scat.split_cat(*args, cats, pair, torch.zeros((2, 8), dtype=torch.int32),
                   **kw)
    assert pair[0, 12] == 1.0
