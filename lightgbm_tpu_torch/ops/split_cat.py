"""The categorical split search of the children of a split, merged into
the numerical pair search's rows.

No TPU kernel corresponds to it: the JAX package computes
``find_best_split_categorical`` (lightgbm_tpu/ops/split.py) in XLA inside
its general search ``find_best_split``, which takes the best of the
categorical and the numerical candidates by one argmax over features.
The port runs the numerical scans in ``ops/split_pair.py`` (which skips
the rows whose FM_IS_CAT column is set) and this search after it, as the
hand-written kernel ``csrc/split_cat.cu`` on the card, so that a tree
with categorical features still grows inside one CUDA graph.
``split_cat`` dispatches on the device of its inputs: CPU tensors run
``split_cat_plain``, CUDA tensors launch the kernel or raise.  The two
agree bit for bit: the kernel runs the same f32 operations in the same
order (compiled with ``--fmad=false``) and the same blocked f64 prefix
sums (ops/split.py ``prefix_sum``).

Inputs: the pair search's ``hist_g`` / ``hist_h`` (C F, BF), ``fmeta``
(C F, 8) and ``info`` (C F, 8) (ops/split_pair.py), ``cat_feats`` (NC,)
int32, the categorical features' indices in increasing order, and the
pair search's (C, 13) rows ``pair``, merged in place.  Output
``cat_out`` (C, W) int32: each child's category set as a bitset of bins
(bit b & 31 of word b >> 5), zero where the numerical split stays;
W = ops/partition.py ``cat_words(BF)``, 8 up to 256 bins.  Any width:
past 256 bins (uint16 data) the kernel's arm strides its threads over
the bins, with its per-bin rows in device scratch (``new_work``).

Per (child, categorical feature), as JAX's ``find_best_split_categorical``
(reference: FindBestThresholdCategoricalInner):
  * one-vs-rest when ``num_bin <= max_cat_to_onehot`` (``lambda_l2``):
    the first bin of the largest valid gain;
  * otherwise the bins whose estimated count is >= ``cat_smooth`` sorted
    stably by ``G / (H + cat_smooth)`` -- a bin's rank is the number of
    bins of a smaller ratio, or of an equal one and a smaller index (a
    NaN ratio counts as +inf) -- and prefix sets scanned from both ends
    up to ``min(max_cat_threshold, (used + 1) / 2)`` categories with
    ``lambda_l2 + cat_l2``, the ``min_data_per_group`` gate carried along
    the scan; the forward end wins ties;
  * bin 0 (NaN / other) never joins the set; the feature mask (IN_MASK)
    and ``max_depth`` apply.
Per child the best categorical feature is the largest gain, the smaller
feature on ties; it replaces the numerical row when its gain relative to
the leaf is strictly greater, or equal (and finite) with a smaller
feature index -- the JAX argmax over features.  The row's fields: the
relative gain, the feature, threshold 0, default_left 0, the left count,
sums and outputs (``l2_eff`` the arm's), and LM_BISCAT = 1.

The monotone arm (``mono=True``; JAX ``find_best_split_categorical``
with the leaf's bounds): a categorical feature is never monotone itself,
but its children's outputs are clipped to the child's bounds ``[IN_CMIN,
IN_CMAX]`` (ops/split_pair.py) and every gain, the leaf's shift among
them, is taken at the clipped outputs; the winner's outputs are clipped.
Without ``mono`` the arm is not compiled into the launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .partition import cat_words
from .split import (K_EPSILON, clip_out, gain_given, leaf_gain, leaf_output,
                    prefix_sum)
from .split_pair import (FM_NUM_BIN, IN_CMAX, IN_CMIN, IN_DEPTH, IN_MASK,
                         IN_NUM_DATA, IN_SUM_G, IN_SUM_H, OUT_FIELDS)

REC_FIELDS = 8      # a kernel record's words before its set's W words
WIDE_ROWS = 11      # per-bin scratch rows of the kernel's wide arm
NARROW_BF = 256     # the widest row of the kernel's shared-memory arm
MAX_CHILDREN = 65535    # the launch grid's y extent

# launches of the CUDA kernel by this wrapper, a launch recorded into a
# CUDA graph under capture included (a replay launches without the
# wrapper and is not counted; nor is the plain version)
launches = 0


def cat_params(config) -> dict:
    """The categorical search's parameters from a Config."""
    return dict(max_cat_threshold=int(config.max_cat_threshold),
                cat_l2=float(config.cat_l2),
                cat_smooth=float(config.cat_smooth),
                max_cat_to_onehot=int(config.max_cat_to_onehot),
                min_data_per_group=int(config.min_data_per_group))


def _first_argmax(x):
    """Index of the first maximum along the last axis, and the maximum."""
    m = x.max(dim=-1, keepdim=True).values
    idx = torch.argmax((x == m).to(torch.int8), dim=-1)
    return idx, m[..., 0]


def per_feature(G, H, nb, inf, *, l1, l2, max_delta_step, min_gain_to_split,
                min_data_in_leaf, min_sum_hessian, max_depth,
                max_cat_threshold, cat_l2, cat_smooth, max_cat_to_onehot,
                min_data_per_group, mono=False):
    """Each row's best categorical split: rows of (BF,) f32 histograms
    ``G`` / ``H`` with their (R, 1) num_bin ``nb`` and (R, 8) info rows
    (``mono``: the monotone arm, the bounds from the info rows).
    Returns (gain (R,), member (R, BF) bool, lg, lh incl. eps, lc, l2_eff,
    min_gain_shift)."""
    R, BF = G.shape
    dev = G.device
    f32 = torch.float32
    args = (l1, l2, max_delta_step)
    l2c = l2 + cat_l2
    neg = torch.tensor(float("-inf"), dtype=f32, device=dev)
    z = torch.zeros((), dtype=f32, device=dev)
    sum_g = inf[:, IN_SUM_G:IN_SUM_G + 1]
    sum_h_tot = inf[:, IN_SUM_H:IN_SUM_H + 1] + 2 * K_EPSILON
    num_data = inf[:, IN_NUM_DATA:IN_NUM_DATA + 1]
    depth = inf[:, IN_DEPTH]
    fmask = inf[:, IN_MASK] > 0
    cnt_factor = num_data / sum_h_tot
    cmin = inf[:, IN_CMIN:IN_CMIN + 1]
    cmax = inf[:, IN_CMAX:IN_CMAX + 1]

    def pair_gain(lg, lh, rg, rh, l2e):
        """The two children's gain at l2 ``l2e`` (clipped outputs with
        ``mono``)."""
        a = (l1, l2e, max_delta_step)
        if not mono:
            return leaf_gain(lg, lh, *a) + leaf_gain(rg, rh, *a)
        lo = clip_out(leaf_output(lg, lh, *a), cmin, cmax)
        ro = clip_out(leaf_output(rg, rh, *a), cmin, cmax)
        return (gain_given(lg, lh, l1, l2e, lo)
                + gain_given(rg, rh, l1, l2e, ro))

    if mono:
        mgs = gain_given(sum_g, sum_h_tot, l1, l2, clip_out(
            leaf_output(sum_g, sum_h_tot, *args), cmin, cmax)) \
            + min_gain_to_split
    else:
        mgs = leaf_gain(sum_g, sum_h_tot, *args) + min_gain_to_split
    mdl = float(min_data_in_leaf)
    msh = min_sum_hessian
    mdpg = float(min_data_per_group)

    bins = torch.arange(BF, device=dev)[None, :]
    in_range = (bins >= 1) & (bins < nb)
    cnt_bin = torch.where(in_range, torch.floor(H * cnt_factor + 0.5), z)

    # one-vs-rest
    hess_t = H + K_EPSILON
    other_g = sum_g - G
    other_h = (sum_h_tot - H) - K_EPSILON
    other_cnt = num_data - cnt_bin
    gain_oh = pair_gain(G, hess_t, other_g, other_h, l2)
    valid_oh = (in_range & (cnt_bin >= mdl) & (H >= msh)
                & (other_cnt >= mdl) & (other_h >= msh) & (gain_oh > mgs))
    best_oh, best_oh_gain = _first_argmax(torch.where(valid_oh, gain_oh, neg))
    oh_sel = best_oh[:, None]

    # sorted prefix sets: a bin's rank is the count of bins of a smaller
    # ratio, or of an equal one and a smaller index (NaN ratios as +inf),
    # the kernel's exact count; a stable sort gives the same ranks (+ 0.0
    # makes -0.0 +0.0, which the count holds equal) in O(BF log BF)
    valid_s = in_range & (cnt_bin >= cat_smooth)
    ratio = torch.where(valid_s, G / (H + cat_smooth), torch.inf)
    ratio = torch.where(torch.isnan(ratio), torch.inf, ratio) + 0.0
    order = torch.sort(ratio, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(BF, device=dev).expand(R, BF))  # (R, BF)
    used = valid_s.sum(dim=1, keepdim=True)
    max_num_cat = torch.clamp(torch.div(used + 1, 2, rounding_mode="floor"),
                              max=max_cat_threshold)

    def sort(v):
        out = torch.zeros_like(v)
        return out.scatter_(1, rank, torch.where(valid_s, v, z))

    sG, sH, sC = sort(G), sort(H), sort(cnt_bin)
    cs = prefix_sum(torch.stack([sG, sH, sC]))
    pg, ph, pc = cs[0], cs[1], cs[2]
    tvg, tvh, tvc = pg[:, BF - 1:], ph[:, BF - 1:], pc[:, BF - 1:]
    pos = bins
    ridx = used - 2 - pos

    def prefix_at(p, idx):
        v = torch.gather(p, 1, torch.clamp(idx, min=0))
        return torch.where(idx >= 0, v, z)

    lg_f, lh_f, lc_f = pg, ph + K_EPSILON, pc
    lg_r = tvg - prefix_at(pg, ridx)
    lh_r = (tvh - prefix_at(ph, ridx)) + K_EPSILON
    lc_r = tvc - prefix_at(pc, ridx)
    in_loop = (pos < used) & (pos < max_num_cat)
    step_f = sC
    step_r = prefix_at(sC, used - 1 - pos)
    lim = int(torch.minimum(used, max_num_cat).max()) if R else 0

    def candidates(lg, lh, lc, step):
        rg = sum_g - lg
        rh = sum_h_tot - lh
        rc = num_data - lc
        left_ok = (lc >= mdl) & (lh >= msh)
        broken = (rc < mdl) | (rc < mdpg) | (rh < msh)
        not_broken = torch.cumsum(broken.to(torch.int32), dim=1) == 0
        ok = left_ok & not_broken & in_loop
        ev = torch.zeros_like(ok)
        c = torch.zeros(R, dtype=f32, device=dev)
        for i in range(lim):
            c = c + step[:, i]
            e = ok[:, i] & (c >= mdpg)
            ev[:, i] = e
            c = torch.where(e, z, c)
        gain = pair_gain(lg, lh, rg, rh, l2c)
        return torch.where(ev & (gain > mgs), gain, neg)

    bi_f, bg_f = _first_argmax(candidates(lg_f, lh_f, lc_f, step_f))
    bi_r, bg_r = _first_argmax(candidates(lg_r, lh_r, lc_r, step_r))
    use_rev = bg_r > bg_f
    bi = torch.where(use_rev, bi_r, bi_f)[:, None]
    k = bi + 1
    member_s = torch.where(use_rev[:, None], (rank >= used - k) & (rank < used),
                           rank < k) & valid_s

    def sel(a_f, a_r):
        return torch.where(use_rev[:, None], torch.gather(a_r, 1, bi),
                           torch.gather(a_f, 1, bi))[:, 0]

    onehot = nb[:, 0] <= max_cat_to_onehot
    gain = torch.where(onehot, best_oh_gain, torch.maximum(bg_f, bg_r))
    gain = torch.where(fmask, gain, neg)
    if max_depth > 0:
        gain = torch.where(depth < float(max_depth), gain, neg)
    member = torch.where(onehot[:, None], bins == oh_sel, member_s)
    lg = torch.where(onehot, torch.gather(G, 1, oh_sel)[:, 0],
                     sel(lg_f, lg_r))
    lh = torch.where(onehot, torch.gather(H, 1, oh_sel)[:, 0] + K_EPSILON,
                     sel(lh_f, lh_r))
    lc = torch.where(onehot, torch.gather(cnt_bin, 1, oh_sel)[:, 0],
                     sel(lc_f, lc_r))
    l2_eff = torch.where(onehot, torch.tensor(l2, dtype=f32, device=dev),
                         torch.tensor(l2c, dtype=f32, device=dev))
    return gain, member, lg, lh, lc, l2_eff, mgs[:, 0]


def pack_set(member) -> torch.Tensor:
    """(R, BF) bool -> (R, W) int32 bitsets, W = cat_words(BF)."""
    R, BF = member.shape
    W = cat_words(BF)
    m = torch.zeros((R, 32 * W), dtype=torch.int64, device=member.device)
    m[:, :BF] = member.to(torch.int64)
    w = (m.view(R, W, 32)
         << torch.arange(32, device=member.device)).sum(dim=2)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def split_cat_plain(hist_g, hist_h, fmeta, info, cat_feats, pair, cat_out,
                    *, children: int = 2, mono: bool = False, **kw) -> None:
    """Plain version of the kernel, in place on ``pair`` / ``cat_out``
    (see module doc)."""
    C = children
    F = hist_g.shape[0] // C
    dev = hist_g.device
    f32, i32 = torch.float32, torch.int32
    NC = cat_feats.shape[0]
    cat_out.zero_()
    if NC == 0:
        return
    cf = cat_feats.long()
    rows = (torch.arange(C, device=dev)[:, None] * F + cf[None, :]).reshape(-1)
    gain, member, lg, lh, lc, l2e, mgs = per_feature(
        hist_g[rows], hist_h[rows], fmeta[rows, FM_NUM_BIN:FM_NUM_BIN + 1],
        info[rows], mono=mono, **kw)
    words = pack_set(member)
    neg = float("-inf")
    l1, mds = kw["l1"], kw["max_delta_step"]
    for c in range(C):
        s = slice(c * NC, (c + 1) * NC)
        k, g = _first_argmax(gain[s])
        r = c * NC + int(k)
        row0 = c * F
        sg = info[row0, IN_SUM_G]
        sh = info[row0, IN_SUM_H] + 2 * K_EPSILON
        nd = info[row0, IN_NUM_DATA]
        rel = torch.where(g > neg, g - mgs[r], torch.tensor(neg, device=dev))
        num_rel = pair[c, 0]
        num_feat = int(pair[c, 1].view(i32))
        feat = int(cf[int(k)])
        if not (rel > num_rel or (rel == num_rel and rel > neg
                                  and feat < num_feat)):
            continue
        l_g, l_h, l_c = lg[r], lh[r], lc[r]
        r_g, r_h, r_c = sg - l_g, sh - l_h, nd - l_c
        l2v = float(l2e[r])
        ints = torch.tensor([feat, 0, int(l_c), int(r_c)], dtype=i32,
                            device=dev).view(f32)
        zero = torch.zeros((), dtype=f32, device=dev)
        lout = leaf_output(l_g, l_h, l1, l2v, mds)
        rout = leaf_output(r_g, r_h, l1, l2v, mds)
        if mono:
            lo_c, hi_c = info[row0, IN_CMIN], info[row0, IN_CMAX]
            lout = clip_out(lout, lo_c, hi_c)
            rout = clip_out(rout, lo_c, hi_c)
        pair[c] = torch.stack([
            rel, ints[0], ints[1], zero, ints[2], ints[3], l_g,
            l_h - K_EPSILON, r_g, r_h - K_EPSILON, lout, rout, zero + 1.0])
        cat_out[c] = words[r]


def split_cat(hist_g, hist_h, fmeta, info, cat_feats, pair, cat_out, *,
              l1: float, l2: float, max_delta_step: float,
              min_gain_to_split: float, min_data_in_leaf: int,
              min_sum_hessian: float, max_depth: int, max_cat_threshold: int,
              cat_l2: float, cat_smooth: float, max_cat_to_onehot: int,
              min_data_per_group: int, children: int = 2, work=None,
              mono: bool = False) -> None:
    """Merge the children's best categorical splits into ``pair`` and
    write their sets to ``cat_out``, in place (see module doc); ``work``
    is the kernel's scratch on the card (``new_work``); ``mono`` the
    monotone arm."""
    kw = dict(l1=l1, l2=l2, max_delta_step=max_delta_step,
              min_gain_to_split=min_gain_to_split,
              min_data_in_leaf=min_data_in_leaf,
              min_sum_hessian=min_sum_hessian, max_depth=max_depth,
              max_cat_threshold=max_cat_threshold, cat_l2=cat_l2,
              cat_smooth=cat_smooth, max_cat_to_onehot=max_cat_to_onehot,
              min_data_per_group=min_data_per_group)
    if hist_g.device.type == "cpu":
        return split_cat_plain(hist_g, hist_h, fmeta, info, cat_feats, pair,
                               cat_out, children=children, mono=mono, **kw)
    return split_cat_cuda(hist_g, hist_h, fmeta, info, cat_feats, pair,
                          cat_out, children=children, work=work, mono=mono,
                          **kw)


def work_words(children: int, ncat: int, width: int) -> int:
    """Words of the kernel's scratch for rows of ``width`` bins: one
    record (REC_FIELDS + W words) a (child, categorical feature), the done
    counter, and past 256 bins the wide arm's WIDE_ROWS rows of ``width``
    a record."""
    n = children * ncat
    wide = n * WIDE_ROWS * width if width > NARROW_BF else 0
    return n * (REC_FIELDS + cat_words(width)) + 1 + wide


def new_work(children: int, ncat: int, device,
             width: int = NARROW_BF) -> torch.Tensor:
    """The kernel's scratch (``work_words``), zero: the done counter
    starts at 0 and the last block leaves it there."""
    return torch.zeros(work_words(children, ncat, width), dtype=torch.int32,
                       device=device)


def split_cat_cuda(hist_g, hist_h, fmeta, info, cat_feats, pair, cat_out, *,
                   children, work=None, mono=False, **kw) -> None:
    global launches
    C = children
    F2, BF = hist_g.shape
    NC = cat_feats.shape[0]
    if (C < 1 or F2 % C or F2 == 0 or BF < 1 or NC == 0
            or C > MAX_CHILDREN):
        raise ValueError(f"split_cat needs ({C}F, BF) histograms and a "
                         f"categorical feature, got {tuple(hist_g.shape)} "
                         f"and {NC}")
    W = cat_words(BF)
    kernels.require_cuda(hist_g, torch.float32, "hist_g")
    kernels.require_cuda(hist_h, torch.float32, "hist_h", (F2, BF))
    kernels.require_cuda(fmeta, torch.int32, "fmeta", (F2, 8))
    kernels.require_cuda(info, torch.float32, "info", (F2, 8))
    kernels.require_cuda(cat_feats, torch.int32, "cat_feats", (NC,))
    kernels.require_cuda(pair, torch.float32, "pair", (C, OUT_FIELDS))
    kernels.require_cuda(cat_out, torch.int32, "cat_out", (C, W))
    if work is None:
        work = new_work(C, NC, hist_g.device, BF)
    kernels.require_cuda(work, torch.int32, "work",
                         (work_words(C, NC, BF),))
    fn = kernels.load("split_cat").split_cat_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 6 + [ctypes.c_int]
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p])
    err = fn(kernels.ptr(hist_g), kernels.ptr(hist_h), kernels.ptr(fmeta),
             kernels.ptr(info), kernels.ptr(cat_feats), kernels.ptr(pair),
             kernels.ptr(cat_out), kernels.ptr(work), F2 // C, C, BF, NC, W,
             kw["l1"], kw["l2"], kw["max_delta_step"],
             kw["min_gain_to_split"], float(kw["min_data_in_leaf"]),
             kw["min_sum_hessian"], int(kw["max_depth"]),
             int(kw["max_cat_threshold"]),
             float(kw["l2"] + kw["cat_l2"]), kw["cat_smooth"],
             int(kw["max_cat_to_onehot"]), float(kw["min_data_per_group"]),
             int(bool(mono)), kernels.stream_ptr(hist_g.device))
    kernels.check(err, "split_cat_launch")
    launches += 1
