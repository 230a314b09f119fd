"""Monotone constraints in the port's bookkeeping and refresh against the
JAX package, on the CPU:

  * ``tree_step_plain``'s children bounds (the mid rule of JAX's basic
    bounds) and bin boxes (JAX ``_child_boxes`` itself), exactly;
  * ``mono_refresh_plain`` and the refresh's re-search
    (``SerialTreeLearner._refresh``) against the JAX learner's
    ``_mc_refresh`` on the same random boxes, outputs and histograms:
    every bound exactly, the changed leaves' re-searched rows identical
    but for exact ties, their gains and outputs within rtol 2e-4 / atol
    1e-5 (the pair search's bar);
  * the config: ``monotone_constraints_method=advanced`` is refused by
    name, the aliases select the method and the penalty.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.models.learner import SerialTreeLearner as JaxLearner
from lightgbm_tpu_torch.ops import mono as tmono
from lightgbm_tpu_torch.ops import tree_step as ts
from lightgbm_tpu_torch.ops.partition import SB_DONE, SB_LEAF, SB_S, step_len

from test_torch_categorical import random_hist
from test_torch_kernels_cuda import mono_tree_case
from test_torch_monotone_trees import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", range(8))
def test_tree_step_plain_children_bounds_and_boxes_follow_jax(seed):
    """The commit of a pending split writes the children's bounds (the
    mid rule of JAX's basic bounds) and boxes (JAX ``_child_boxes``); the
    next election writes the elected split's children's bounds into the
    info block."""
    case, boxes = mono_tree_case(seed)
    lm0, fmeta = case[0].clone(), case[5]
    step0 = case[2].clone()
    leaf, new = int(step0[SB_LEAF]), int(step0[SB_S])
    pcol = lm0[:, leaf].numpy()
    pci = pcol.view(np.int32)
    fe = int(pci[ts.LM_BFEAT])
    mono = int(fmeta[7, fe])
    mid = (pcol[ts.LM_BLOUT] + pcol[ts.LM_BROUT]) * np.float32(0.5)
    num = not pcol[ts.LM_BISCAT] > 0.5
    pmin, pmax = pcol[ts.LM_CMIN], pcol[ts.LM_CMAX]
    want = [np.maximum(pmin, mid) if num and mono < 0 else pmin,
            np.minimum(pmax, mid) if num and mono > 0 else pmax,
            np.maximum(pmin, mid) if num and mono > 0 else pmin,
            np.minimum(pmax, mid) if num and mono < 0 else pmax]
    b0 = boxes.clone()
    ts.tree_step_plain(ts.MODE_STEP, *case, row0=256, N=5000, boxes=boxes)
    lm = case[0]
    got = [lm[ts.LM_CMIN, leaf], lm[ts.LM_CMAX, leaf], lm[ts.LM_CMIN, new],
           lm[ts.LM_CMAX, new]]
    np.testing.assert_array_equal(np.float32(got), np.float32(want))
    F = fmeta.shape[1]
    bl = jnp.arange(boxes.shape[1]) == leaf
    st = {"leaf_lo": jnp.asarray(b0[0].numpy()),
          "leaf_hi": jnp.asarray(b0[1].numpy())}
    fm = fmeta[:, fe].numpy()
    jb = JaxLearner._child_boxes(
        types.SimpleNamespace(F=F), st, bl, jnp.int32(fe),
        jnp.bool_(not num), jnp.int32(fm[6]), jnp.int32(fm[4]),
        jnp.int32(fm[5]), jnp.bool_(pcol[ts.LM_BDL] > 0.5),
        jnp.int32(pci[ts.LM_BTHR]))
    plo, phi, l_hi, r_lo = (np.asarray(v) for v in jb)
    np.testing.assert_array_equal(boxes[0, leaf].numpy(), plo)
    np.testing.assert_array_equal(boxes[1, leaf].numpy(), l_hi)
    np.testing.assert_array_equal(boxes[0, new].numpy(), r_lo)
    np.testing.assert_array_equal(boxes[1, new].numpy(), phi)
    others = [i for i in range(boxes.shape[1]) if i not in (leaf, new)]
    assert torch.equal(boxes[:, others], b0[:, others])
    step, info = case[2], case[6].numpy()
    if int(step[SB_DONE]):
        return
    e = int(step[SB_LEAF])
    ecol = lm[:, e].numpy()
    eb = ts.child_bounds(ecol, int(fmeta[7, int(ecol.view(np.int32)
                                                [ts.LM_BFEAT])]))
    np.testing.assert_array_equal(info[:F, 5:7], np.tile(eb[:2], (F, 1)))
    np.testing.assert_array_equal(info[F:, 5:7], np.tile(eb[2:], (F, 1)))


def test_tree_step_plain_root_writes_unbounded_info_and_root_box():
    import test_torch_tree_loop as tl
    case = tl.tree_case(0)
    F = case[5].shape[1]
    boxes = torch.full((2, 10, F), 7, dtype=torch.int32)
    ts.tree_step_plain(ts.MODE_ROOT, *case, row0=256, N=5000, boxes=boxes)
    info = case[6].numpy()
    assert np.all(info[:, 5] == -np.inf) and np.all(info[:, 6] == np.inf)
    assert torch.equal(boxes[0, 0], torch.zeros(F, dtype=torch.int32))
    assert torch.equal(boxes[1, 0], case[5][4] - 1)
    assert torch.all(boxes[:, 1:] == 7)


# -- the refresh against JAX's _mc_refresh --------------------------------
def _random_tree_boxes(rng, L, nb, live):
    """Boxes of ``live`` leaves grown by random numerical splits from the
    root box (each leaf keeps its own slot, the new one the next)."""
    F = len(nb)
    lo = np.zeros((L + 1, F), np.int32)
    hi = np.tile(nb - 1, (L + 1, 1)).astype(np.int32)
    for new in range(1, live):
        leaf = int(rng.randint(new))
        cand = [f for f in range(F) if hi[leaf, f] > lo[leaf, f]]
        f = int(rng.choice(cand))
        t = int(rng.randint(lo[leaf, f], hi[leaf, f]))
        lo[new], hi[new] = lo[leaf], hi[leaf]
        hi[leaf, f], lo[new, f] = t, t + 1
    return lo, hi


@pytest.fixture(scope="module")
def learners():
    """A JAX and a port learner on the same 600 rows, 31 leaves, the
    intermediate method (their state is replaced by the tests)."""
    rng = np.random.RandomState(0)
    X = rng.randn(600, 5)
    y = X[:, 0] - 0.5 * X[:, 1] + 0.2 * rng.randn(600)
    p = {"objective": "regression", "num_leaves": 31, "verbosity": -1,
         "monotone_constraints": [1, -1, 0, 1, 0],
         "monotone_constraints_method": "intermediate",
         "min_data_in_leaf": 5}
    jb = lgb.train(dict(p), lgb.Dataset(X, label=y), 1)
    jb.num_trees()
    tb = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, label=y), 1)
    return jb._gbdt.learner, tb._gbdt.learner


def _split_gain64(hist, ai, cmin, cmax):
    """f64 gain of a numerical split (fields ``ai``: feature, threshold)
    of a leaf with histogram ``hist`` (F, B, 2) and bounds [cmin, cmax],
    no missing values and no regularization, and the sum of the three
    |leaf gains|."""
    h = hist[int(ai[ts.LM_BFEAT])].astype(np.float64)
    t = int(ai[ts.LM_BTHR])
    sg, sh = h[:, 0].sum(), h[:, 1].sum()
    lg, lh = h[:t + 1, 0].sum(), h[:t + 1, 1].sum()

    def part(g, hh):
        out = min(max(-g / hh, float(cmin)), float(cmax))
        return -(2.0 * g * out + hh * out * out)

    parts = [part(lg, lh), part(sg - lg, sh - lh), part(sg, sh)]
    return parts[0] + parts[1] - parts[2], sum(abs(v) for v in parts)


@pytest.mark.parametrize("seed", range(4))
def test_mono_refresh_matches_jax_mc_refresh(seed, learners):
    jl, tl = learners
    assert tl.mc_mode == "intermediate" and jl.mc_mode == "intermediate"
    L, F = tl.L, tl.F
    nb = tl._fmeta[4]
    rng = np.random.RandomState(seed)
    live = int(rng.randint(4, L + 1))
    lo, hi = _random_tree_boxes(rng, L, nb, live)
    lm = ts.empty_leafmat(L)
    hists = np.zeros((L + 1, F, tl.B, 2), np.float32)
    for leaf in range(live):
        h, _, n = random_hist(seed * 50 + leaf, F=F, BF=tl.B, nb=nb.copy())
        hists[leaf] = h
        cnt = int(np.float32(h[0, :, 1].sum()) * 4)
        lm[:, leaf] = ts.leaf_column(0, cnt, cnt, h[0, :, 0].sum(),
                                     h[0, :, 1].sum(), int(rng.randint(1, 6)),
                                     rng.randn(), -1, 0, np.zeros(13))
        if rng.rand() < 0.3:
            lm[ts.LM_CMIN, leaf] = rng.randn() - 3
    # outputs that mostly respect the directions (a leaf's box centre along
    # each monotone feature, signed), with noise
    sign = tl._fmeta[7]
    lm[ts.LM_VALUE, :live] = ((lo[:live] + hi[:live]) * sign / nb).sum(1) \
        + 0.05 * rng.randn(live)
    fmask = np.ones(F, bool)
    st = {"leaf_lo": jnp.asarray(lo), "leaf_hi": jnp.asarray(hi),
          "hist": jnp.asarray(hists), "feat_used": jnp.zeros(F, bool)}
    jlm = jnp.zeros((jl._nlf, L + 1), jnp.float32).at[:ts.NLF].set(lm)
    jlm3, _ = jl._mc_refresh(st, jlm, jnp.int32(live), jnp.asarray(fmask))
    jlm3 = np.asarray(jlm3)[:ts.NLF]

    # the port: the same leafmat, boxes and histogram state
    tl.leafmat.copy_(torch.as_tensor(lm))
    tl.boxes.copy_(torch.as_tensor(np.stack([lo, hi])))
    Bp = tl.state.shape[-1]
    slots = tl.state.shape[0]
    state = np.zeros((slots, 2, F, Bp), np.float32)
    state[:, :, :, :tl.B] = hists[:slots].transpose(0, 3, 1, 2)
    tl.state.copy_(torch.as_tensor(state))
    tl.step.zero_()
    tl.step[SB_S] = live - 1
    tl.fmask.fill_(1.0)
    before = tl.leafmat.clone()
    tl._refresh()
    got = tl.leafmat.numpy()
    for r in (ts.LM_CMIN, ts.LM_CMAX):
        np.testing.assert_array_equal(got[r, :live], jlm3[r, :live])
    changed = tl.mc_changed.numpy().astype(bool)
    assert changed.any() and not changed[live:].any()
    same = crossed = ties = 0
    for leaf in range(L):
        if not changed[leaf]:
            assert torch.equal(tl.leafmat[ts.LM_BGAIN:ts.LM_BISCAT + 1, leaf],
                               before[ts.LM_BGAIN:ts.LM_BISCAT + 1, leaf])
            continue
        a, b = got[:, leaf], jlm3[:, leaf]
        if not np.isfinite(b[ts.LM_BGAIN]):
            assert not np.isfinite(a[ts.LM_BGAIN])
            continue
        ai, bi = a.view(np.int32), b.view(np.int32)
        if a[ts.LM_CMIN] >= a[ts.LM_CMAX]:
            # crossed bounds clip every candidate's outputs to one value:
            # every gain is 0 but for the f32 rounding of the leaf's own
            # gain, and each package's rounding picks
            shift = float(a[ts.LM_SUM_G]) ** 2 / float(a[ts.LM_SUM_H])
            assert abs(float(a[ts.LM_BGAIN]) - float(b[ts.LM_BGAIN])) <= (
                1e-6 * max(1.0, shift))
            crossed += 1
            continue
        np.testing.assert_allclose(a[ts.LM_BGAIN], b[ts.LM_BGAIN],
                                   rtol=2e-4, atol=1e-5)
        same += 1
        if (ai[ts.LM_BFEAT], ai[ts.LM_BTHR]) != (bi[ts.LM_BFEAT],
                                                 bi[ts.LM_BTHR]):
            # two thresholds whose outputs clip to the same bound tie in
            # exact arithmetic: their f64 gains agree to f32 resolution
            # of the leaf's gains
            ga, gb = (_split_gain64(hists[leaf], x.view(np.int32),
                                    a[ts.LM_CMIN], a[ts.LM_CMAX])
                      for x in (a, b))
            assert abs(ga[0] - gb[0]) <= 2 ** -23 * max(1.0, ga[1], gb[1])
            ties += 1
        np.testing.assert_allclose(a[[ts.LM_BLOUT, ts.LM_BROUT]],
                                   b[[ts.LM_BLOUT, ts.LM_BROUT]],
                                   rtol=2e-4, atol=1e-5)
    assert same >= 1, (same, crossed)


def test_mono_refresh_plain_of_a_stopped_tree_changes_nothing():
    L, F = 6, 3
    lm = torch.as_tensor(ts.empty_leafmat(L))
    boxes = torch.zeros((2, L + 1, F), dtype=torch.int32)
    fmeta = torch.zeros((ts.FMETA_ROWS, F), dtype=torch.int32)
    fmeta[7, 0] = 1
    step = torch.zeros(step_len(8), dtype=torch.int32)
    step[SB_DONE], step[SB_S] = 1, 4
    changed = torch.ones(L, dtype=torch.int32)
    info = torch.full((L * F, 8), 3.0)
    before = lm.clone()
    tmono.mono_refresh(lm, boxes, fmeta, step, torch.ones(F), changed, info)
    assert torch.equal(lm.view(torch.int32), before.view(torch.int32))
    assert not changed.any()
    assert torch.all(info == 3.0)


# -- the config -----------------------------------------------------------
@pytest.mark.parametrize("key", ["monotone_constraints_method",
                                 "mc_method", "monotone_constraining_method"])
def test_advanced_method_is_refused_by_name(key):
    X = np.random.RandomState(0).randn(200, 3)
    with pytest.raises(NotImplementedError,
                       match="monotone_constraints_method='advanced'"):
        lgt.train({"objective": "regression", "device_type": "cpu",
                   "monotone_constraints": "1,0,-1", key: "advanced",
                   "verbosity": -1}, lgt.Dataset(X, label=X[:, 0]), 1)


@pytest.mark.parametrize("key,method,mode", [
    ("monotone_constraints", "basic", "basic"),
    ("mc", "intermediate", "intermediate"),
    ("monotone_constraint", "intermediate", "intermediate")])
def test_aliases_select_the_method(key, method, mode):
    X = np.random.RandomState(1).randn(300, 3)
    b = lgt.train({"objective": "regression", "device_type": "cpu",
                   key: [1, 0, -1], "mc_method": method, "mc_penalty": 1.5,
                   "num_leaves": 7, "verbosity": -1},
                  lgt.Dataset(X, label=X[:, 0] - X[:, 2]), 2)
    lr = b._gbdt.learner
    assert lr.use_mc and lr.mc_mode == mode and lr.subtract and lr.K == 1
    assert lr.monotone_penalty == 1.5 and lr.mc_pen is not None
    np.testing.assert_array_equal(lr._fmeta[7], [1, 0, -1])
