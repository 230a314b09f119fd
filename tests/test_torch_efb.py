"""EFB bundles in the port against the JAX package, on the CPU.

A synthetic set of 2,400 rows: four standard-normal columns and four
categorical columns of 5, 8, 3 and 6 levels, one-hot encoded.  The
indicators of one categorical never share a row, so the default params
(``enable_bundle=true``) bundle each categorical into one group.

Tolerances: groups, offsets, ``bin_start`` and the binned matrix are
bit-identical.  The per-feature view (ops/feat_view.py) equals JAX's
``_feat_view`` in every non-default bin and, in a bundled feature's
rebuilt default bin, to 1e-6 relative to the leaf total: both take the
leaf total minus the feature's other bins in f32, summed in another
order.  Trees: structure identical, leaf values rtol 1e-4 / atol 1e-5,
raw predictions atol 1e-5 (the repo's bar).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import feat_view as fv
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 5
LEVELS = (5, 8, 3, 6)


def _data(n=2400, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.normal(size=(n, 4))
    cats = [rng.randint(0, k, size=n) for k in LEVELS]
    X = np.hstack([dense] + [np.eye(k)[c] for k, c in zip(LEVELS, cats)])
    z = dense[:, 0] + (cats[0] == 2) - (cats[1] > 4) + 0.5 * dense[:, 1]
    y_bin = (z + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    y_reg = z + 0.5 * cats[3] + 0.1 * rng.normal(size=n)
    return X, {"binary": y_bin, "regression": y_reg}


X, LABELS = _data()


def _groups(ds):
    return [(g.feature_indices, g.bin_offsets, g.num_total_bin)
            for g in ds.groups]


def _structure(t):
    n = t.num_nodes()
    return (t.num_leaves, t.split_feature[:n].tolist(),
            t.threshold_bin[:n].tolist(), t.threshold[:n].tolist(),
            t.decision_type[:n].tolist(), t.left_child[:n].tolist(),
            t.right_child[:n].tolist(), t.leaf_count.tolist(),
            t.internal_count.tolist())


def _same_trees(jb, tb):
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert _structure(a) == _structure(b)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("enable_bundle", [True, False])
def test_groups_and_bins_bit_identical(enable_bundle):
    y = LABELS["binary"]
    p = {"enable_bundle": enable_bundle, "verbosity": -1}
    jd = lgb.Dataset(X, label=y, params=p).construct()._inner
    td = lgt.Dataset(X, label=y,
                     params=dict(p, device_type="cpu")).construct()._inner
    assert _groups(td) == _groups(jd)
    bundles = [g for g in td.groups if len(g.feature_indices) > 1]
    assert len(bundles) == (len(LEVELS) if enable_bundle else 0)
    np.testing.assert_array_equal(np.asarray(jd.host_binned()), td.binned)
    jm, tm = jd.feature_meta_arrays(), td.feature_meta_arrays()
    for k in tm:
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    # validation rows are binned with the training set's groups
    np.testing.assert_array_equal(jd.bin_matrix(X[:300]),
                                  td.bin_matrix(X[:300]))


@pytest.fixture(scope="module", params=sorted(LABELS))
def trained(request):
    y = LABELS[request.param]
    params = {"objective": request.param, "num_leaves": 15,
              "verbosity": -1}
    jb = lgb.train(dict(params, tpu_frontier_k=1), lgb.Dataset(X, label=y),
                   num_boost_round=ROUNDS)
    jb.num_trees()
    tb = lgt.train(dict(params, device_type="cpu"), lgt.Dataset(X, label=y),
                   num_boost_round=ROUNDS)
    return y, params, jb, tb


def test_bundled_data_takes_the_subtraction_body(trained):
    lr = trained[3]._gbdt.learner
    assert lr.bundled and lr.subtract and lr.K == 1
    assert lr.F == X.shape[1] and lr.G == 4 + len(LEVELS)


def test_bundled_trees_match_jax(trained):
    _, _, jb, tb = trained
    _same_trees(jb, tb)
    assert any(t.num_leaves == 15 for t in tb._gbdt.models)
    # a bundled feature (an indicator) is split on
    splits = np.concatenate([t.split_feature[:t.num_nodes()]
                             for t in tb._gbdt.models])
    assert (splits >= 4).any()


def test_bundled_raw_predictions_match_jax(trained):
    _, _, jb, tb = trained
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def test_dataset_from_jax_bundles_trains_the_same_trees(trained):
    """convert.dataset_from_arrays carries JAX's bundles (features,
    offsets, bin counts): the trees equal those of the port's own
    binning, bit for bit."""
    y, params, jb, tb = trained
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.boosting import GBDT
    from lightgbm_tpu_torch.models.objective import create_objective
    jd = jb._gbdt.train_data
    spec = [(g.feature_indices, g.bin_offsets, g.num_total_bin)
            for g in jd.groups]
    ds = convert.dataset_from_arrays(
        np.asarray(jd.host_binned()), [bm.to_dict() for bm in jd.bin_mappers],
        spec, y, params=dict(params, device_type="cpu"))
    assert _groups(ds) == _groups(tb._gbdt.train_data)
    cfg = Config(dict(params, device_type="cpu"))
    g = GBDT(cfg, ds, create_objective(cfg), "cpu")
    for _ in range(ROUNDS):
        g.train_one_iter()
    for a, b in zip(g.models, tb._gbdt.models):
        assert _structure(a) == _structure(b)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def test_feat_view_plain_equals_jax(trained):
    """The port's f32 view against JAX's ``_feat_view`` on random group
    histograms and leaf totals."""
    _, _, jb, tb = trained
    jl, lr = jb._gbdt.learner, tb._gbdt.learner
    rng = np.random.RandomState(3)
    G, B, Bp, F = jl.G, jl.B, lr.children.shape[-1], lr.F
    for trial in range(3):
        hist = np.zeros((G, B, 2), np.float32)
        for g, grp in enumerate(tb._gbdt.train_data.groups):
            nb = grp.num_total_bin
            hist[g, :nb, 0] = rng.randn(nb)
            hist[g, :nb, 1] = rng.rand(nb) + 0.1
        tot = hist[0].sum(axis=0)          # every group holds every row
        want = np.asarray(jl._feat_view(hist, tot[0], tot[1]))
        ch = np.zeros((2, 2, G, Bp), np.float32)
        ch[:, :, :, :B] = hist.transpose(2, 0, 1)[:, None]
        info = np.zeros((2 * F, 8), np.float32)
        info[:, 0], info[:, 1] = tot
        got = fv.feat_view_plain(torch.tensor(ch), torch.tensor(info),
                                 lr.view).numpy()
        BF = want.shape[1]
        assert not got[..., BF:].any()
        for c in range(2):
            for p in range(2):
                g_, w_ = got[p, c, :, :BF], want[:, :, p]
                fixed = lr.view.fix.numpy()
                np.testing.assert_array_equal(g_[:, 1:], w_[:, 1:])
                np.testing.assert_array_equal(g_[~fixed, 0], w_[~fixed, 0])
                np.testing.assert_allclose(g_[fixed, 0], w_[fixed, 0],
                                           rtol=0,
                                           atol=1e-6 * abs(tot[p]) + 1e-6)


def test_feat_view_fixed_plain_is_exact(trained):
    """The card's arithmetic: the default bin of a bundled feature is the
    group's exact integer total minus its other bins, an empty bin exactly
    0, every value the state's (int64 * 2^-k) in f32."""
    tb = trained[3]
    lr = tb._gbdt.learner
    G, Bp = lr.G, lr.children.shape[-1]
    rng = np.random.RandomState(4)
    state = torch.zeros((3, 2, G, Bp), dtype=torch.int64)
    for g, grp in enumerate(tb._gbdt.train_data.groups):
        nb = grp.num_total_bin
        b = torch.as_tensor(rng.randint(0, nb, size=500))
        for slot in (1, 2):
            for p in range(2):
                v = torch.as_tensor(rng.randint(-2 ** 40, 2 ** 40, size=500))
                state[slot, p, g].index_add_(0, b, v * (p + 1))
    step = torch.zeros(24, dtype=torch.int32)
    step[1], step[11], step[12] = 7, 1, 2        # SB_CNT, SB_WA, SB_WB
    absmax = torch.tensor([0.75, 0.25])
    kcnt = 1000
    got = fv.feat_view_fixed_plain(state, step, absmax, kcnt, lr.view)
    inv = fv.scale_inverse(absmax, kcnt)
    meta = lr.view.meta.numpy()
    st = state.numpy()
    for c, slot in enumerate((1, 2)):
        for p in range(2):
            for f in range(lr.F):
                g, bs, isb, nb = (int(v) for v in meta[:, f])
                row = st[slot, p, g]
                want = np.zeros(Bp, np.int64)
                if isb:
                    want[1:nb] = row[bs + 1:bs + nb]
                    want[0] = row.sum() - want[1:nb].sum()
                else:
                    want[:nb] = row[:nb]
                w32 = (want.astype(np.float64) * float(inv[p])).astype(
                    np.float32)
                np.testing.assert_array_equal(got[p, c, f].numpy(), w32)
    step[1] = 0
    assert not fv.feat_view_fixed_plain(state, step, absmax, kcnt,
                                        lr.view).any()


def test_bundled_and_sampled_step_loop_trees_equal_eager_oracle():
    """The step loop (the graph's sequence, on the CPU) grows the eager
    oracle's trees bit for bit on bundled data under bagging and
    feature_fraction: the feature view, the device bag count and the
    device feature mask."""
    from test_torch_tree_loop import assert_same_tree, lockstep
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "bagging_fraction": 0.7, "bagging_freq": 1,
              "feature_fraction": 0.7}
    for a, b in lockstep(X, LABELS["binary"], params, "cpu"):
        assert_same_tree(a, b)
    lr = a._gbdt.learner
    assert lr.bundled and lr.syncs == 3
    assert int(lr.bag[0]) < len(X) and 0 < int(lr.fmask.sum()) < lr.F


def test_root_view_sums_to_the_root_totals():
    """The view the root's search reads: every feature's bins, its
    rebuilt default bin included, sum to the root's totals (the CPU view
    reads them from the info rows, which the bookkeeping writes before
    the search)."""
    tb = lgt.Booster({"objective": "binary", "num_leaves": 7,
                      "verbosity": -1, "device_type": "cpu"},
                     lgt.Dataset(X, label=LABELS["binary"]))
    g = tb._gbdt
    lr = g.learner
    pb, pg = g._phys
    pg[0, lr.row0:lr.row0 + lr.N] = torch.linspace(-1, 1, lr.N)
    pg[1, lr.row0:lr.row0 + lr.N] = 0.25
    lr._root(pb, pg)
    sums = lr.sums.numpy()
    view = lr.fchildren.numpy().sum(axis=3)          # (plane, child, F)
    for p in range(2):
        np.testing.assert_allclose(view[p], sums[p], rtol=1e-5,
                                   atol=1e-4 * lr.N)
    assert lr.view.fix.any()
