"""Quantized-gradient training's pieces: the port's discretizer
(lightgbm_tpu_torch/ops/quantize.py, the plain twin of
csrc/quantize.cu) and the scale arms of the histogram twins, against the
JAX package.

  * The fused iteration's discretizer: JAX computes it inside its fused
    program (boosting.py ``_setup_fused_phys``), so ``_jax_fused`` below
    is those lines verbatim over the padded payload, with the key
    ``fold_in(PRNGKey(seed), iter + 1)`` and draws at the physical
    position; the port's carriers and scale must equal them bit for bit,
    with and without stochastic rounding, with the constant-hessian
    shortcut, and on bagged (zeroed) and GOSS-scaled rows.
  * The eager discretizer: the JAX package's own
    ``GBDT._discretize_gradients`` over (N,) rows in original order,
    advancing its ``quant_rng`` chain, against the port's pass drawn at
    each row's id over a permuted payload, twice in a row.
  * The scale arms: every plain twin (split_mega, hist_fixed, leaf_hist,
    leaf_hist_fixed, the histogram state's children, feat_view_fixed)
    given integer carriers and a scale equals JAX's ``_scale_hist`` of
    the integer-domain histogram, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.models.learner import SerialTreeLearner as JaxLearner
from lightgbm_tpu_torch.ops import feat_view as fv
from lightgbm_tpu_torch.ops import hist_state as hs
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import split_mega as sm
from lightgbm_tpu_torch.ops.partition import make_scalars
from lightgbm_tpu_torch.ops.quantize import quantize, scale_planes
from lightgbm_tpu_torch.utils import random as jrandom
from torch_one_thread import one_torch_thread  # noqa: F401

N, NPAD, C = 900, 1280, 128


def _payload(seed, mode):
    """(8, NPAD) payload with (g, h) on the real rows [C, C + N): normal
    grads and positive hessians, zeroed out of a bag or scaled by GOSS's
    factors (``mode``); row ids permuted so physical and original order
    differ; pads carry the sentinel N."""
    rng = np.random.RandomState(seed)
    g = rng.randn(N).astype(np.float32) * 3
    h = (rng.rand(N) + 0.05).astype(np.float32)
    if mode == "bagged":
        keep = rng.rand(N) < 0.7
        g, h = np.where(keep, g, 0.0), np.where(keep, h, 0.0)
    elif mode == "goss":
        f = rng.choice(np.float32([0.0, 1.0, 4.5]), N)
        g, h = g * f, h * f
    ghi = np.zeros((8, NPAD), np.float32)
    ghi[0, C:C + N] = g
    ghi[1, C:C + N] = h
    rowid = np.full(NPAD, N, np.int32)
    rowid[C:C + N] = rng.permutation(N)
    ghi[2] = rowid.view(np.float32)
    return ghi


def _jax_fused(ghi, it, bins, const_h, stoch, seed=0):
    """JAX boosting.py ``_setup_fused_phys``'s in-program discretizer,
    line for line, over the padded payload."""
    rowid = jax.lax.bitcast_convert_type(jnp.asarray(ghi[2]), jnp.int32)
    vf = (rowid != N).astype(jnp.float32)
    g = jnp.asarray(ghi[0]) * vf
    h = jnp.asarray(ghi[1]) * vf
    q_bins = float(bins)
    q_key = jax.random.PRNGKey(seed)
    gs = jnp.maximum(jnp.max(jnp.abs(g)) / (q_bins / 2.0), 1e-30)
    max_h = jnp.max(jnp.abs(h))
    hs_ = jnp.maximum(max_h if const_h else max_h / q_bins, 1e-30)
    if stoch:
        kg, kh = jax.random.split(jax.random.fold_in(q_key, it + 1))
        rg = jax.random.uniform(kg, g.shape)
        rh = jax.random.uniform(kh, h.shape)
    else:
        rg = rh = 0.5
    ig = jnp.trunc(g / gs + jnp.where(g >= 0, rg, -rg))
    ih = jnp.ones_like(h) if const_h else jnp.trunc(h / hs_ + rh)
    return (np.asarray(ig * vf), np.asarray(ih * vf),
            np.asarray(jnp.stack([gs, hs_])))


def _port(ghi, **kw):
    t = torch.as_tensor(ghi.copy())
    absmax = t[:2].abs().amax(dim=1)
    scale = torch.zeros(2)
    quantize(t, absmax, scale, N=N, **kw)
    return t.numpy(), scale.numpy()


@pytest.mark.parametrize("mode", ["plain", "bagged", "goss"])
@pytest.mark.parametrize("const_h", [False, True], ids=["hess", "const_h"])
@pytest.mark.parametrize("stoch", [True, False], ids=["stoch", "nearest"])
def test_fused_discretizer_matches_jax_bit_for_bit(mode, const_h, stoch):
    ghi = _payload(3, mode)
    it, bins = 4, 4 if mode == "plain" else 6
    ig, ih, scale = _jax_fused(ghi, it, bins, const_h, stoch)
    keys = (jrandom.split(jrandom.fold_in(jrandom.PRNGKey(0), it + 1))
            if stoch else None)
    out, pscale = _port(ghi, bins=bins, const_h=const_h, keys=keys,
                        renew_rows=(5, 6))
    np.testing.assert_array_equal(pscale.view(np.int32),
                                  scale.view(np.int32))
    np.testing.assert_array_equal(out[0].view(np.int32), ig.view(np.int32))
    np.testing.assert_array_equal(out[1].view(np.int32), ih.view(np.int32))
    # the true rows ride rows 5 and 6; the rest of the payload is kept
    np.testing.assert_array_equal(out[5:7], ghi[:2])
    np.testing.assert_array_equal(out[2:5], ghi[2:5])
    assert np.all(out[:2] == np.trunc(out[:2]))


@pytest.mark.parametrize("objective", ["regression", "binary"])
@pytest.mark.parametrize("row_sampling", [False, True],
                         ids=["unsampled", "sampled"])
@pytest.mark.parametrize("stoch", [True, False], ids=["stoch", "nearest"])
def test_eager_discretizer_matches_jax_bit_for_bit(objective, row_sampling,
                                                   stoch):
    ghi = _payload(5, "bagged" if row_sampling else "plain")
    rng = np.random.RandomState(0)
    X = rng.randn(N, 3)
    jb = lgb.Booster({"objective": objective, "verbosity": -1,
                      "use_quantized_grad": True,
                      "stochastic_rounding": stoch},
                     lgb.Dataset(X, label=(X[:, 0] > 0).astype(float)))
    gbdt = jb._gbdt
    rowid = ghi[2].view(np.int32)[C:C + N]
    g = np.zeros(N, np.float32)
    h = np.zeros(N, np.float32)
    g[rowid], h[rowid] = ghi[0, C:C + N], ghi[1, C:C + N]
    const = objective == "regression"
    q_rng = jrandom.PRNGKey(0)
    for _ in range(2):          # the chain advances a call
        ig, ih, scale = (np.asarray(a) for a in gbdt._discretize_gradients(
            jnp.asarray(g), jnp.asarray(h), row_sampling=row_sampling))
        keys = None
        if stoch:
            q_rng, sub = jrandom.split(q_rng)
            keys = jrandom.split(sub)
        out, pscale = _port(ghi, bins=4,
                            const_h=const and not row_sampling, keys=keys,
                            by_rowid=True)
        np.testing.assert_array_equal(pscale.view(np.int32),
                                      scale.view(np.int32))
        np.testing.assert_array_equal(
            out[0, C:C + N].view(np.int32), ig[rowid].view(np.int32))
        np.testing.assert_array_equal(
            out[1, C:C + N].view(np.int32), ih[rowid].view(np.int32))
        assert not out[:2, :C].any() and not out[:2, C + N:].any()


G, B = 5, 60


def _binned(seed):
    """Integer carriers on a quantized payload and its bins."""
    rng = np.random.RandomState(seed)
    bins = torch.as_tensor(rng.randint(0, B, (G, NPAD)).astype(np.uint8))
    ghi = torch.zeros((8, NPAD))
    ghi[0] = torch.as_tensor(rng.randint(-3, 4, NPAD).astype(np.float32))
    ghi[1] = torch.as_tensor(rng.randint(0, 5, NPAD).astype(np.float32))
    ghi[2] = torch.arange(NPAD, dtype=torch.int32).view(torch.float32)
    scale = torch.tensor([0.0137, 0.00291], dtype=torch.float32)
    return bins, ghi, scale


def _jax_scaled(planes, scale):
    """JAX learner.py ``_scale_hist`` of (2, ..., Bp) integer planes, back
    in the port's layout."""
    h = jnp.moveaxis(jnp.asarray(planes.numpy()), 0, -1)
    return torch.as_tensor(np.moveaxis(np.array(
        JaxLearner._scale_hist(h, jnp.asarray(scale.numpy()))), -1, 0))


def _same(a, b):
    np.testing.assert_array_equal(a.numpy().view(np.int32),
                                  b.numpy().view(np.int32))


@pytest.mark.parametrize("plain", ["f32", "fixed"])
def test_split_mega_scale_arm_equals_jax(plain):
    bins, ghi, scale = _binned(1)
    Bp = sm.hist_geometry(B)[1]
    sc = make_scalars(C, N, 1, 0, 0, B, 0, 0, 20, 0)
    kw = dict(num_bins=B, num_groups=G)
    if plain == "f32":
        _, raw = sm.split_mega_plain(bins.clone(), ghi.clone(), sc, move=False,
                                     **kw)
        _, got = sm.split_mega_plain(bins.clone(), ghi.clone(), sc, move=False,
                                     scale=scale, **kw)
    else:
        raw = sm.hist_fixed_plain(bins, ghi, sc, **kw)
        got = sm.hist_fixed_plain(bins, ghi, sc, scale=scale, **kw)
    # (G, 4, Bp): planes left g, left h, right g, right h
    raw = raw.view(G, 2, 2, Bp).permute(2, 0, 1, 3)
    want = _jax_scaled(raw, scale).permute(1, 2, 0, 3).reshape(got.shape)
    _same(got, want)


@pytest.mark.parametrize("plain", ["f32", "fixed"])
def test_leaf_hist_scale_arm_equals_jax(plain):
    bins, ghi, scale = _binned(2)
    kw = dict(num_bins=B, num_groups=G, planes=True)
    f = th.leaf_hist_plain if plain == "f32" else th.leaf_hist_fixed_plain
    raw = f(bins, ghi, C + 7, 500, **kw)
    _same(f(bins, ghi, C + 7, 500, scale=scale, **kw),
          _jax_scaled(raw, scale))


@pytest.mark.parametrize("plain", ["f32", "fixed"])
def test_hist_state_children_scale_arm_equals_jax(plain):
    """A root, then a split: the state keeps the integer sums, only the
    children the search reads are scaled."""
    bins, ghi, scale = _binned(3)
    f32 = plain == "f32"
    f = hs.leaf_hist_rmw_plain if f32 else hs.leaf_hist_rmw_fixed_plain
    extra = {} if f32 else dict(absmax=ghi[:2].abs().amax(dim=1), kcnt=N)
    outs = []
    for sc in (None, scale):
        state = torch.zeros((4, 2, G, sm.hist_geometry(B)[1]),
                            dtype=torch.float32 if f32 else torch.int64)
        kw = dict(num_bins=B, num_groups=G, state=state, scale=sc, **extra)
        f(bins, ghi, C, N, idx=(-1, 0, 0, 0), **kw)
        outs.append((f(bins, ghi, C, 300, idx=(0, 0, 1, 1), **kw),
                     state.clone()))
    (raw, st_raw), (got, st_got) = outs
    assert torch.equal(st_raw, st_got)
    _same(got, _jax_scaled(raw, scale))


def test_feat_view_fixed_scale_arm_equals_jax():
    bins, ghi, scale = _binned(4)
    Bp = sm.hist_geometry(B)[1]
    # two groups bundle two features each, the rest stand alone
    group = np.array([0, 0, 1, 2, 2, 3, 4], np.int32)
    bstart = np.array([0, 20, 0, 0, 30, 0, 0], np.int32)
    isb = np.array([1, 1, 0, 1, 1, 0, 0], np.int32)
    nbin = np.array([20, 25, 40, 30, 28, 60, 12], np.int32)
    view = fv.View(group, bstart, isb, nbin, G, Bp, "cpu")
    state = torch.zeros((3, 2, G, Bp), dtype=torch.int64)
    absmax = ghi[:2].abs().amax(dim=1)
    kw = dict(num_bins=B, num_groups=G, state=state, absmax=absmax, kcnt=N)
    hs.leaf_hist_rmw_fixed_plain(bins, ghi, C, N, idx=(-1, 0, 0, 0), **kw)
    hs.leaf_hist_rmw_fixed_plain(bins, ghi, C, 400, idx=(0, 1, 2, 1), **kw)
    step = torch.zeros(40, dtype=torch.int32)
    step[1], step[11], step[12] = N, 1, 2
    raw = fv.feat_view_fixed_plain(state, step, absmax, N, view)
    got = fv.feat_view_fixed_plain(state, step, absmax, N, view, scale=scale)
    _same(got, _jax_scaled(raw, scale))


def test_scale_planes_is_the_identity_without_a_scale():
    h = torch.randn(4, 3, 16)
    assert scale_planes(h, None, 0) is h
    s = torch.tensor([2.0, 0.5])
    np.testing.assert_array_equal(scale_planes(h, s, 0).numpy(),
                                  (h * s.repeat(2).view(4, 1, 1)).numpy())


def _lockstep_data(case):
    rng = np.random.RandomState(11)
    X = rng.normal(size=(3000, 5))
    if case == "efb":
        X = np.hstack([X, np.eye(6)[rng.randint(0, 6, 3000)]])
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 2] ** 2
         + 0.3 * rng.normal(size=3000) > 0).astype(float)
    return X, y


@pytest.mark.parametrize("case", ["mega", "subtraction", "efb"])
def test_step_loop_trees_equal_eager_oracle(case):
    """Quantized (bagged, with the leaf renewal): the device-loop steps
    on the CPU grow the eager oracle's trees bit for bit, row order and
    renewed leaf values included."""
    import test_torch_tree_loop as _tl
    X, y = _lockstep_data(case)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "use_quantized_grad": True, "quant_train_renew_leaf": True,
              "bagging_fraction": 0.8, "bagging_freq": 1}
    if case == "subtraction":
        params["tpu_megakernel"] = "off"
    for a, b in _tl.lockstep(X, y, params, "cpu"):
        _tl.assert_same_tree(a, b)
    lr = a._gbdt.learner
    assert lr.qscale is not None and lr.bundled == (case == "efb")
