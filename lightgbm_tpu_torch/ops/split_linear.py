"""The piece-wise-linear split search of ``linear_tree_mode``
leafwise_gain, in plain PyTorch.

Port of lightgbm_tpu/ops/split.py ``_linear_side`` /
``find_best_split_linear`` and ops/histogram.py
``linear_moment_planes``: XLA operations in the JAX package, not a
Pallas kernel.  A split's gain is that of two leaf-local linear models
``const + coeff * x`` over the split feature's raw value, each side's
closed-form centered ridge fit (``linear_side``), from the moment planes
Σx·g, Σx·h, Σx·x·h, which are the histogram scaled by each bin's
representative raw value (ops/binning.py ``bin_rep_values``; 0 at the
NaN bin and at the MISSING_ZERO default bin, so both scans share one
set of moment prefix sums).  The gain shift is the leaf's own model:
the best whole-leaf single-feature fit, read off the moment totals.
The masks, the candidate order and its tie key are those of the
constant search (ops/split_pair.py).

Precision: the prefix sums are ops/split.py ``prefix_sum64`` (the pair
kernel's blocked f64 association, on the CPU and on the card alike) and
the linear gains, the shift and the leaf's own model are computed in
f64; the counts, hessian bounds, sums and outputs of the winner's row
are split_pair's f32 values.  The JAX package computes all of it in
f32, where ``var = Σx²h - xm·Σxh`` cancels, so the two packages can
part at near-ties (ROADMAP section C records the sites).

``split_linear`` is the learner's search over C children at once,
capture-safe (fixed shapes, no host read): split_pair's (C, 13) rows
and each child's own model as (C, 3) f32 ``(const, coeff, feature
id bits)``.  ``find_best_split_linear`` is the one-leaf search of the
JAX package's signature, for the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .split import K_EPSILON, leaf_output, prefix_sum64
from .split_pair import IN_DEPTH, IN_MASK, IN_NUM_DATA, IN_SUM_G, IN_SUM_H

LIN_FIELDS = 3


class BestSplitLinear(NamedTuple):
    """One leaf's best split and its own model (JAX ``BestSplitLinear``
    without the categorical fields)."""
    gain: torch.Tensor
    feature: torch.Tensor
    threshold: torch.Tensor
    default_left: torch.Tensor
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    left_count: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor
    self_const: torch.Tensor
    self_coeff: torch.Tensor
    self_feature: torch.Tensor


def linear_moment_planes(feat_hist, rep_vals) -> torch.Tensor:
    """(3, F, BF) Σx·g, Σx·h, Σx·x·h of a leaf from its (F, BF, 2)
    histogram and the (F, BF) representative values (JAX
    ``linear_moment_planes``), in the histogram's dtype."""
    xg = rep_vals * feat_hist[..., 0]
    xh = rep_vals * feat_hist[..., 1]
    return torch.stack([xg, xh, rep_vals * xh])


def linear_side(g, h, xg, xh, xxh, l2: float, lam: float):
    """(gain, coeff, const) of one side's centered ridge fit of ``coeff
    * x + const`` (JAX ``_linear_side``): ``xm = Σxh / h``, ``xgc = Σxg
    - xm g``, ``var = Σx²h - xm Σxh``; gain ``g² / (h + l2) + xgc² /
    (var + lam)``, the slope's term dropped where ``var`` is not > 0."""
    xm = xh / h
    xgc = xg - xm * g
    var = xxh - xm * xh
    ok = var > 0.0
    denom = torch.where(ok, var + lam, 1.0)
    coeff = torch.where(ok, -xgc / denom, 0.0)
    gain = g * g / (h + l2) + torch.where(ok, xgc * xgc / denom, 0.0)
    const = -g / (h + l2) - coeff * xm
    return gain, coeff, const


class LinearStatic(NamedTuple):
    """What a learner's searches share, fixed by its features: the masks
    of the bins each scan covers and of the bins that can be a threshold,
    the representative values."""
    in_range: torch.Tensor    # (F, BF) bool
    scan: torch.Tensor        # (2, 1, 1, F, BF) bool: forward, reverse bins
    cand: torch.Tensor        # (2, 1, F, BF) bool: forward, reverse
    snan: torch.Tensor        # (F,) f32: a one-scan NaN feature
    rep: torch.Tensor         # (F, BF) f64, 0 past each feature's bins
    fid: torch.Tensor         # (F,) int64 original feature ids


def linear_static(nb, mtype, dflt, rep, fid, BF: int) -> LinearStatic:
    """The ``LinearStatic`` of features with ``num_bin`` / ``missing_type``
    / ``default_bin`` (F,) int, representative values ``rep`` (F, >= BF)
    and original ids ``fid``, at the search's width BF (split_pair's
    masks: ops/split_pair.py)."""
    dev = rep.device
    i32 = torch.int32
    bins = torch.arange(BF, device=dev, dtype=i32)
    nb, mtype, dflt = (torch.as_tensor(v, device=dev).to(i32)[:, None]
                       for v in (nb, mtype, dflt))
    in_range = bins < nb
    zero_m = mtype == 1
    nan_m = mtype == 2
    two_scan = (nb > 2) & (mtype != 0)
    at_dflt = bins == dflt
    bmax = nb - 1 - (nan_m & two_scan).to(i32)
    mf = in_range & ~(zero_m & at_dflt)
    mr = in_range & ~(two_scan & zero_m & at_dflt) & (bins <= bmax)
    cf = two_scan & in_range & (bins <= nb - 2) & ~(zero_m & at_dflt)
    cr = (in_range & (bins <= bmax - 1)
          & ~(two_scan & zero_m & (bins == dflt - 1)))
    return LinearStatic(
        in_range=in_range, scan=torch.stack([mf, mr])[:, None, None],
        cand=torch.stack([cf, cr])[:, None],
        snan=(~two_scan & nan_m)[:, 0].to(torch.float32),
        rep=torch.where(in_range, rep[:, :BF].to(dev), 0.0).double(),
        fid=torch.as_tensor(fid, device=dev).long())


def _search(hg, hh, sum_g, sum_h, num_data, fmask, depth_ok,
            st: LinearStatic, *, l2: float, min_gain_to_split: float,
            min_data_in_leaf: int, min_sum_hessian: float, lam: float):
    """The search of C children at once: ``hg`` / ``hh`` (C, F, BF) f32,
    ``sum_g`` / ``sum_h`` / ``num_data`` (C,) f32, ``fmask`` (C, F) bool,
    ``depth_ok`` (C,) bool, ``st`` the features' ``LinearStatic``.  Each
    operation runs on every side, scan and child at once, so a search is
    a fixed, short run of launches.  Returns the (C, 13) rows and (C, 3)
    own models."""
    C, F, BF = hg.shape
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    K = K_EPSILON
    sh_tot = sum_h + 2 * K
    # per child: (sum_g, sum_h + 2 K_EPSILON, num_data), f32 and f64
    S = torch.stack([sum_g, sh_tot, num_data])[:, :, None, None]
    S64 = torch.stack([sum_g.to(f64), sum_h.to(f64) + 2 * K])[
        :, :, None, None]
    cnt_bin = torch.where(st.in_range, torch.floor(
        hh * (num_data / sh_tot)[:, None, None] + 0.5), 0.0)
    H = torch.stack([hg, hh, cnt_bin]).to(f64)                # (3, C, F, BF)
    # [g, h, count] of the forward scan's bins, of the reverse scan's, then
    # the moments Σxg, Σxh, Σxxh over every bin: their prefix sums
    cs = prefix_sum64(torch.cat([
        torch.where(st.scan, H[None], 0.0).view(6, C, F, BF),
        linear_moment_planes(H[:2].movedim(0, -1), st.rep)]))
    # split_pair's f32 sides (the winner's row, the counts and hessians
    # the bounds test): [g, h, count] left and right of each threshold
    c32 = cs[:6].float().view(2, 3, C, F, BF)
    fwd = c32[0]
    fwd[1] += K
    rev = c32[1, ..., BF - 1:] - c32[1]
    rev[1] += K
    side32 = torch.stack([fwd, S - fwd, S - rev, rev])   # (4, 3, C, F, BF)
    # the f64 sides of the linear models: forward left / right, reverse
    # left / right, and the whole leaf (its own model) broadcast on bins
    lf = cs[0:2].clone()
    lf[1] += K
    rr = cs[3:5, ..., BF - 1:] - cs[3:5]
    rr[1] += K
    mom = cs[6:9]
    tot = mom[..., BF - 1:]
    gh = torch.stack([lf, S64 - lf, S64 - rr, rr, S64.expand_as(lf)])
    xs = torch.stack([mom, tot - mom, mom, tot - mom, tot.expand_as(mom)])
    gain, coeff, const = linear_side(gh[:, 0], gh[:, 1], xs[:, 0], xs[:, 1],
                                     xs[:, 2], l2, lam)   # (5, C, F, BF)
    # the leaf's own model: its best single-feature fit among the
    # features of its mask (the first of equal gains)
    sf_j = torch.argmax(torch.where(fmask, gain[4, ..., 0], float("-inf")),
                        dim=1, keepdim=True)                    # (C, 1)
    shift = gain[4, ..., 0].gather(1, sf_j)[..., None] + min_gain_to_split
    ok = ((side32[:, 2] >= float(min_data_in_leaf))
          & (side32[:, 1] >= min_sum_hessian))                 # (4, ...)
    live = (fmask & depth_ok[:, None])[..., None]
    pair = torch.stack([gain[0] + gain[1], gain[2] + gain[3]])
    valid = (st.cand & ok[0::2] & ok[1::2] & (pair > shift)
             & live)                                          # (2, ...)
    g2 = torch.where(valid, pair, float("-inf"))
    # the candidates in the tie order, per feature the reverse scan's
    # thresholds descending, then the forward scan's ascending: the first
    # of the largest gains wins (all -inf: no split)
    cand = torch.cat([g2[1].flip(2), g2[0]], dim=2).view(C, -1)
    idx = torch.argmax(cand, dim=1, keepdim=True)
    stats = torch.cat([side32[2].flip(3), side32[0]], dim=3)  # (3, C, F, 2BF)
    lg, lh, lc = stats.view(3, C, -1).gather(
        2, idx[None].expand(3, C, 1))[..., 0]
    wfeat = idx[:, 0] // (2 * BF)
    r = idx[:, 0] - wfeat * (2 * BF)
    thr = torch.where(r < BF, BF - 1 - r, r - BF)
    dl = (r < BF).to(f32) * (1.0 - st.snan[wfeat])
    rg, rh, rc = sum_g - lg, sh_tot - lh, num_data - lc
    gain_rel = (cand.gather(1, idx)[:, 0] - shift[:, 0, 0]).to(f32)

    def bitf(v):
        return v.to(i32).view(f32)

    rows = torch.stack([
        gain_rel, bitf(wfeat), bitf(thr), dl, bitf(lc), bitf(rc),
        lg, lh - K, rg, rh - K,
        leaf_output(lg, lh, 0.0, l2, 0.0), leaf_output(rg, rh, 0.0, l2, 0.0),
        torch.zeros_like(lg)], dim=1)
    sel = sf_j[None].expand(2, C, 1)
    own = torch.cat([torch.stack([const[4, ..., 0], coeff[4, ..., 0]])
                     .gather(2, sel)[..., 0].T.to(f32),
                     bitf(st.fid[sf_j])], dim=1)
    return rows, own


def split_linear(hist_g, hist_h, info, st: LinearStatic, *, l2: float,
                 min_gain_to_split: float, min_data_in_leaf: int,
                 min_sum_hessian: float, max_depth: int, lam: float,
                 children: int = 2, out=None, lin_out=None):
    """The learner's search of ``children`` = C children (split_pair's
    inputs: (C F, BF) histograms and IN_* info rows; ``st`` the
    features' ``linear_static``): (C, 13) rows into ``out`` and (C, 3)
    own models into ``lin_out`` when given.  Capture-safe on the card."""
    C = children
    F2, BF = hist_g.shape
    F = F2 // C
    head = info.view(C, F, 8)[:, 0]
    depth_ok = (head[:, IN_DEPTH] < float(max_depth) if max_depth > 0
                else torch.ones(C, dtype=torch.bool, device=info.device))
    rows, own = _search(
        hist_g.view(C, F, BF), hist_h.view(C, F, BF), head[:, IN_SUM_G],
        head[:, IN_SUM_H], head[:, IN_NUM_DATA],
        info[:, IN_MASK].view(C, F) > 0, depth_ok, st, l2=l2,
        min_gain_to_split=min_gain_to_split,
        min_data_in_leaf=min_data_in_leaf, min_sum_hessian=min_sum_hessian,
        lam=lam)
    if out is not None:
        out.copy_(rows)
        rows = out
    if lin_out is not None:
        lin_out.copy_(own)
        own = lin_out
    return rows, own


def find_best_split_linear(feat_hist, ctx, sum_g, sum_h, num_data,
                           l2: float, min_gain_to_split: float,
                           min_data_in_leaf: int, min_sum_hessian: float,
                           rep_vals, linear_lambda: float,
                           feature_mask=None,
                           feature_index=None) -> BestSplitLinear:
    """One leaf's search from its (F, BF, 2) histogram (JAX
    ``find_best_split_linear``'s arguments; ``ctx`` ops/split.py
    ``SplitContext``, ``feature_index`` (F,) the original ids, default
    0 .. F - 1)."""
    F, BF, _ = feat_hist.shape
    dev = feat_hist.device
    f32 = torch.float32

    def one(v):
        return torch.as_tensor(v, device=dev).to(f32).reshape(1)

    fmask = (torch.ones((1, F), dtype=torch.bool, device=dev)
             if feature_mask is None
             else torch.as_tensor(feature_mask, device=dev).reshape(1, F))
    fid = (torch.arange(F, device=dev) if feature_index is None
           else torch.as_tensor(feature_index, device=dev))
    st = linear_static(ctx.num_bin, ctx.missing_type, ctx.default_bin,
                       torch.as_tensor(rep_vals, device=dev).to(f32), fid,
                       BF)
    rows, own = _search(
        feat_hist[None, ..., 0].to(f32), feat_hist[None, ..., 1].to(f32),
        one(sum_g), one(sum_h), one(num_data), fmask,
        torch.ones(1, dtype=torch.bool, device=dev), st, l2=l2,
        min_gain_to_split=min_gain_to_split,
        min_data_in_leaf=min_data_in_leaf, min_sum_hessian=min_sum_hessian,
        lam=linear_lambda)
    r = rows[0]
    ints = r.view(torch.int32)
    return BestSplitLinear(
        gain=r[0], feature=ints[1], threshold=ints[2],
        default_left=r[3] > 0.5, left_sum_g=r[6], left_sum_h=r[7],
        right_sum_g=r[8], right_sum_h=r[9], left_count=ints[4],
        right_count=ints[5], left_output=r[10], right_output=r[11],
        self_const=own[0, 0], self_coeff=own[0, 1],
        self_feature=own[0].view(torch.int32)[2])

