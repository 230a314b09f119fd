"""Kernel 1: best numerical split for two sibling leaves at once.

Counterpart of the TPU kernel ``best_split_pair_pallas``
(lightgbm_tpu/ops/split_pallas.py), with the semantics of
``ops/split.py:find_best_split_fast`` applied to both children of the
split just made.  ``split_pair`` dispatches on the device of its
inputs: CPU tensors run ``split_pair_plain`` (plain PyTorch), CUDA
tensors launch the hand-written kernel ``csrc/split_pair.cu`` or raise.

Inputs (the JAX kernel's layout, without its (8, 128) TPU tile):
  hist_g / hist_h: (2F, BF) f32, the left child's F feature rows stacked
    above the right child's;
  fmeta: (2F, 8) int32, FM_* columns (per-feature metadata, repeated);
  info: (2F, 8) f32, IN_* columns (the child's sums, count and depth
    broadcast over its rows; IN_MASK is the per-child feature mask).
Output: (2, 13) f32, one row per child: the leafmat segment
``LM_BGAIN..LM_BISCAT`` of models/learner.py with the int fields
(feature, threshold, left/right count) bitcast into f32 -- read them
with ``.view(torch.int32)``, never with a value cast.

The winner is the minimum preference key among the maximum-gain
candidates (per feature the reverse scan's thresholds descending, then
the forward scan's ascending; smaller feature first), the reference's
scan-order tie-break.  Counts ride f32, exact below 2^24 rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .split import K_EPSILON, leaf_gain, leaf_output, prefix_sum

FM_NUM_BIN, FM_MISSING, FM_DEFAULT = 0, 1, 2
IN_SUM_G, IN_SUM_H, IN_NUM_DATA, IN_DEPTH, IN_MASK = 0, 1, 2, 3, 4
OUT_FIELDS = 13
_BIG_KEY = 1 << 30

# launches of the CUDA kernel (the plain version is not counted)
launches = 0


def split_pair_plain(hist_g, hist_h, fmeta, info, *, l1: float, l2: float,
                     max_delta_step: float, min_gain_to_split: float,
                     min_data_in_leaf: int, min_sum_hessian: float,
                     max_depth: int) -> torch.Tensor:
    """Plain PyTorch version: the JAX kernel's arithmetic in f32, with
    the kernel's blocked f64 prefix sums (ops/split.py prefix_sum)."""
    F2, BF = hist_g.shape
    F = F2 // 2
    dev = hist_g.device
    f32, i32 = torch.float32, torch.int32
    args = (l1, l2, max_delta_step)
    nb = fmeta[:, FM_NUM_BIN:FM_NUM_BIN + 1]
    mtype = fmeta[:, FM_MISSING:FM_MISSING + 1]
    dflt = fmeta[:, FM_DEFAULT:FM_DEFAULT + 1]
    sum_g = info[:, IN_SUM_G:IN_SUM_G + 1]
    sum_h_tot = info[:, IN_SUM_H:IN_SUM_H + 1] + 2 * K_EPSILON
    num_data = info[:, IN_NUM_DATA:IN_NUM_DATA + 1]
    depth = info[:, IN_DEPTH:IN_DEPTH + 1]
    fmask = info[:, IN_MASK:IN_MASK + 1] > 0
    cnt_factor = num_data / sum_h_tot

    bins = torch.arange(BF, device=dev, dtype=i32)[None, :]
    in_range = bins < nb
    zero_m = mtype == 1
    nan_m = mtype == 2
    two_scan = (nb > 2) & (mtype != 0)
    z = torch.zeros((), dtype=f32, device=dev)
    cnt_bin = torch.where(in_range, torch.floor(hist_h * cnt_factor + 0.5), z)
    at_dflt = bins == dflt
    bmax = nb - 1 - (nan_m & two_scan).to(i32)
    mf = in_range & ~(zero_m & at_dflt)
    mr = in_range & ~(two_scan & zero_m & at_dflt) & (bins <= bmax)
    cs = prefix_sum(torch.stack([
        torch.where(mf, hist_g, z), torch.where(mf, hist_h, z),
        torch.where(mf, cnt_bin, z), torch.where(mr, hist_g, z),
        torch.where(mr, hist_h, z), torch.where(mr, cnt_bin, z)]))
    lg_f, lh_f, lc_f = cs[0], cs[1] + K_EPSILON, cs[2]
    rg_f, rh_f, rc_f = sum_g - lg_f, sum_h_tot - lh_f, num_data - lc_f
    rg_r = cs[3, :, BF - 1:] - cs[3]
    rh_r = (cs[4, :, BF - 1:] - cs[4]) + K_EPSILON
    rc_r = cs[5, :, BF - 1:] - cs[5]
    lg_r, lh_r, lc_r = sum_g - rg_r, sum_h_tot - rh_r, num_data - rc_r
    gain_f = leaf_gain(lg_f, lh_f, *args) + leaf_gain(rg_f, rh_f, *args)
    gain_r = leaf_gain(lg_r, lh_r, *args) + leaf_gain(rg_r, rh_r, *args)
    mgs = leaf_gain(sum_g, sum_h_tot, *args) + min_gain_to_split
    mdl = float(min_data_in_leaf)

    def ok(lc, rc, lh, rh):
        return ((lc >= mdl) & (rc >= mdl) & (lh >= min_sum_hessian)
                & (rh >= min_sum_hessian))

    valid_f = (two_scan & in_range & (bins <= nb - 2) & ~(zero_m & at_dflt)
               & ok(lc_f, rc_f, lh_f, rh_f) & (gain_f > mgs) & fmask)
    valid_r = (in_range & (bins <= bmax - 1)
               & ~(two_scan & zero_m & (bins == dflt - 1))
               & ok(lc_r, rc_r, lh_r, rh_r) & (gain_r > mgs) & fmask)
    if max_depth > 0:
        depth_ok = depth < float(max_depth)
        valid_f = valid_f & depth_ok
        valid_r = valid_r & depth_ok
    neg = torch.tensor(float("-inf"), dtype=f32, device=dev)
    gf = torch.where(valid_f, gain_f, neg)
    gr = torch.where(valid_r, gain_r, neg)
    feat = (torch.arange(F2, device=dev, dtype=i32) % F)[:, None]
    pref_r = feat * (2 * BF) + (BF - 1 - bins)
    pref_f = feat * (2 * BF) + BF + bins
    snan = (~two_scan & nan_m)[:, 0]

    rows = []
    for c in range(2):
        s = slice(c * F, (c + 1) * F)
        gmax = torch.maximum(gf[s].max(), gr[s].max())
        key_r = torch.where(gr[s] >= gmax, pref_r[s], _BIG_KEY)
        key_f = torch.where(gf[s] >= gmax, pref_f[s], _BIG_KEY)
        keys = torch.cat([key_r, key_f], dim=1).reshape(-1)   # (F*2BF,)
        idx = torch.argmin(keys)
        win = keys[idx]
        row, col = idx // (2 * BF), idx % (2 * BF)
        is_rev = col < BF

        def pick(a_r, a_f):
            return torch.cat([a_r[s], a_f[s]], dim=1).reshape(-1)[idx]

        lg, lh, lc = pick(lg_r, lg_f), pick(lh_r, lh_f), pick(lc_r, lc_f)
        wfeat = win // (2 * BF)
        r = win - wfeat * (2 * BF)
        thr = torch.where(r < BF, BF - 1 - r, r - BF)
        dl = is_rev.to(f32) * (1.0 - snan[s][row].to(f32))
        sg = info[c * F, IN_SUM_G]
        sh = info[c * F, IN_SUM_H] + 2 * K_EPSILON
        nd = info[c * F, IN_NUM_DATA]
        rg, rh, rc = sg - lg, sh - lh, nd - lc
        shift = leaf_gain(sg, sh, *args) + min_gain_to_split
        gain_rel = torch.where(win < _BIG_KEY, gmax - shift, neg)

        def bitf(v):
            return v.to(i32).view(f32)

        rows.append(torch.stack([
            gain_rel, bitf(wfeat), bitf(thr), dl, bitf(lc), bitf(rc),
            lg, lh - K_EPSILON, rg, rh - K_EPSILON,
            leaf_output(lg, lh, *args), leaf_output(rg, rh, *args),
            torch.zeros((), dtype=f32, device=dev)]))
    return torch.stack(rows)


def split_pair(hist_g, hist_h, fmeta, info, *, l1: float, l2: float,
               max_delta_step: float, min_gain_to_split: float,
               min_data_in_leaf: int, min_sum_hessian: float,
               max_depth: int) -> torch.Tensor:
    """(2, 13) f32 best-split rows for both children (see module doc).
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    kw = dict(l1=l1, l2=l2, max_delta_step=max_delta_step,
              min_gain_to_split=min_gain_to_split,
              min_data_in_leaf=min_data_in_leaf,
              min_sum_hessian=min_sum_hessian, max_depth=max_depth)
    if hist_g.device.type == "cpu":
        return split_pair_plain(hist_g, hist_h, fmeta, info, **kw)
    return split_pair_cuda(hist_g, hist_h, fmeta, info, **kw)


def split_pair_cuda(hist_g, hist_h, fmeta, info, *, l1, l2, max_delta_step,
                    min_gain_to_split, min_data_in_leaf, min_sum_hessian,
                    max_depth) -> torch.Tensor:
    global launches
    F2, BF = hist_g.shape
    if F2 % 2 or F2 == 0 or not 1 <= BF <= 256:
        raise ValueError(f"split_pair needs (2F, BF<=256) histograms, got "
                         f"{tuple(hist_g.shape)}")
    kernels.require_cuda(hist_g, torch.float32, "hist_g")
    kernels.require_cuda(hist_h, torch.float32, "hist_h", (F2, BF))
    kernels.require_cuda(fmeta, torch.int32, "fmeta", (F2, 8))
    kernels.require_cuda(info, torch.float32, "info", (F2, 8))
    fn = kernels.load("split_pair").split_pair_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p])
    dev = hist_g.device
    out = torch.empty((2, OUT_FIELDS), dtype=torch.float32, device=dev)
    err = fn(kernels.ptr(hist_g), kernels.ptr(hist_h), kernels.ptr(fmeta),
             kernels.ptr(info), kernels.ptr(out), F2 // 2, BF, l1, l2,
             max_delta_step, min_gain_to_split, float(min_data_in_leaf),
             min_sum_hessian, int(max_depth), kernels.stream_ptr(dev))
    kernels.check(err, "split_pair_launch")
    launches += 1
    return out
