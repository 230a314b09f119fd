"""Kernel 1: best numerical split for two sibling leaves at once, or for
the 2K children of a frontier step in one launch.

Counterpart of the TPU kernel ``best_split_pair_pallas``
(lightgbm_tpu/ops/split_pallas.py), with the semantics of
``ops/split.py:find_best_split_fast`` applied to both children of the
split just made.  ``split_pair`` dispatches on the device of its
inputs: CPU tensors run ``split_pair_plain`` (plain PyTorch), CUDA
tensors launch the hand-written kernel ``csrc/split_pair.cu`` or raise.

Inputs (the JAX kernel's layout, without its (8, 128) TPU tile), for
``children`` = C children (2: a pair, the left child first):
  hist_g / hist_h: (C F, BF) f32, each child's F feature rows stacked
    in child order;
  fmeta: (C F, 8) int32, FM_* columns (per-feature metadata, repeated;
    a row whose FM_IS_CAT is set is a categorical feature, which the
    numerical scans skip: ops/split_cat.py searches it);
  info: (C F, 8) f32, IN_* columns (the child's sums, count and depth
    broadcast over its rows; IN_MASK is the per-child feature mask).
Output: (C, 13) f32, one row per child: the leafmat segment
``LM_BGAIN..LM_BISCAT`` of models/learner.py with the int fields
(feature, threshold, left/right count) bitcast into f32 -- read them
with ``.view(torch.int32)``, never with a value cast.

The winner is the minimum preference key among the maximum-gain candidates
(per feature the reverse scan's thresholds descending, then the forward
scan's ascending; smaller feature first), the reference's scan-order
tie-break.  Counts ride f32, exact below 2^24 rows.  Any width BF: past
256 bins (uint16 data) the kernel's lanes walk ceil(BF / 32) bins each
from device memory instead of 8 in registers, with the same association of
the f64 prefix sums, so the two versions still agree bit for bit.  Each
child's search reads only its own rows, so a child's row has the same bits
whatever C is: the frontier runs one launch over its 2K children where the
JAX frontier runs K pair searches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .split import (K_EPSILON, clip_out, gain_given, leaf_gain, leaf_output,
                    prefix_sum)

FM_NUM_BIN, FM_MISSING, FM_DEFAULT, FM_IS_CAT, FM_MONO = 0, 1, 2, 3, 4
(IN_SUM_G, IN_SUM_H, IN_NUM_DATA, IN_DEPTH, IN_MASK, IN_CMIN,
 IN_CMAX) = range(7)
OUT_FIELDS = 13
_BIG_KEY = 1 << 30

# launches of the CUDA kernel by this wrapper, a launch recorded into a
# CUDA graph under capture included (a replay launches without the
# wrapper and is not counted; nor is the plain version)
launches = 0


def split_pair_plain(hist_g, hist_h, fmeta, info, *, l1: float, l2: float,
                     max_delta_step: float, min_gain_to_split: float,
                     min_data_in_leaf: int, min_sum_hessian: float,
                     max_depth: int, children: int = 2, mono: bool = False,
                     pen=None) -> torch.Tensor:
    """Plain PyTorch version: the JAX kernel's arithmetic in f32, with
    the kernel's blocked f64 prefix sums (ops/split.py prefix_sum); the
    monotone arm with ``mono`` (see module doc)."""
    F2, BF = hist_g.shape
    F = F2 // children
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
    fmask = ((info[:, IN_MASK:IN_MASK + 1] > 0)
             & (fmeta[:, FM_IS_CAT:FM_IS_CAT + 1] == 0))
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
    if mono:
        cmin = info[:, IN_CMIN:IN_CMIN + 1]
        cmax = info[:, IN_CMAX:IN_CMAX + 1]
        mdir = fmeta[:, FM_MONO:FM_MONO + 1]

        def pair_gain(lg, lh, rg, rh):
            lo = clip_out(leaf_output(lg, lh, *args), cmin, cmax)
            ro = clip_out(leaf_output(rg, rh, *args), cmin, cmax)
            g = gain_given(lg, lh, l1, l2, lo) + gain_given(rg, rh, l1, l2, ro)
            bad = ((mdir > 0) & (lo > ro)) | ((mdir < 0) & (lo < ro))
            return torch.where(bad, float("-inf"), g)

        gain_f = pair_gain(lg_f, lh_f, rg_f, rh_f)
        gain_r = pair_gain(lg_r, lh_r, rg_r, rh_r)
        mgs = gain_given(sum_g, sum_h_tot, l1, l2, clip_out(
            leaf_output(sum_g, sum_h_tot, *args), cmin, cmax)) \
            + min_gain_to_split
    else:
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
    if pen is not None:
        # each feature's best (the largest gain, the smaller key), its
        # gain relative to the shift times the penalty at the child's
        # depth when the feature is monotone (JAX's feature-level rule);
        # only that candidate stays, with the penalized gain
        gall = torch.cat([gr, gf], dim=1)                     # (CF, 2BF)
        fmax = gall.max(dim=1, keepdim=True).values
        fkey = torch.where(gall >= fmax, torch.cat([pref_r, pref_f], 1),
                           _BIG_KEY).min(dim=1, keepdim=True).values
        p = pen[depth.long().clamp(0, pen.shape[0] - 1)]
        rel = fmax - mgs
        rel = torch.where(fmeta[:, FM_MONO:FM_MONO + 1] != 0, rel * p, rel)
        fgain = torch.where(fmax > neg, mgs + rel, neg)
        gr = torch.where(pref_r == fkey, fgain, neg)
        gf = torch.where(pref_f == fkey, fgain, neg)

    # per child: the largest gain, the smallest key among the candidates
    # that reach it, its candidate's sums (every child at once)
    C = children
    gmax = torch.maximum(gf.view(C, -1).max(dim=1).values,
                         gr.view(C, -1).max(dim=1).values)        # (C,)
    gm = gmax.repeat_interleave(F)[:, None]
    keys = torch.cat([torch.where(gr >= gm, pref_r, _BIG_KEY),
                      torch.where(gf >= gm, pref_f, _BIG_KEY)],
                     dim=1).view(C, -1)                            # (C, 2FBF)
    idx = torch.argmin(keys, dim=1, keepdim=True)
    win = keys.gather(1, idx)[:, 0]
    row = idx[:, 0] // (2 * BF)
    is_rev = idx[:, 0] % (2 * BF) < BF

    def pick(a_r, a_f):
        return torch.cat([a_r.expand(-1, BF), a_f.expand(-1, BF)],
                         dim=1).view(C, -1).gather(1, idx)[:, 0]

    lg, lh, lc = pick(lg_r, lg_f), pick(lh_r, lh_f), pick(lc_r, lc_f)
    wfeat = win // (2 * BF)
    r = win - wfeat * (2 * BF)
    thr = torch.where(r < BF, BF - 1 - r, r - BF)
    dl = is_rev.to(f32) * (1.0 - snan.view(C, F).gather(
        1, row[:, None])[:, 0].to(f32))
    head = info.view(C, F, 8)[:, 0]
    sg = head[:, IN_SUM_G]
    sh = head[:, IN_SUM_H] + 2 * K_EPSILON
    nd = head[:, IN_NUM_DATA]
    rg, rh, rc = sg - lg, sh - lh, nd - lc
    lout = leaf_output(lg, lh, *args)
    rout = leaf_output(rg, rh, *args)
    if mono:
        lo_c, hi_c = head[:, IN_CMIN], head[:, IN_CMAX]
        shift = gain_given(sg, sh, l1, l2, clip_out(
            leaf_output(sg, sh, *args), lo_c, hi_c)) + min_gain_to_split
        lout = clip_out(lout, lo_c, hi_c)
        rout = clip_out(rout, lo_c, hi_c)
    else:
        shift = leaf_gain(sg, sh, *args) + min_gain_to_split
    gain_rel = torch.where(win < _BIG_KEY, gmax - shift, neg)

    def bitf(v):
        return v.to(i32).view(f32)

    return torch.stack([
        gain_rel, bitf(wfeat), bitf(thr), dl, bitf(lc), bitf(rc),
        lg, lh - K_EPSILON, rg, rh - K_EPSILON, lout, rout,
        torch.zeros(C, dtype=f32, device=dev)], dim=1)


def penalty_table(penalty: float, L: int) -> torch.Tensor:
    """(P,) f32 factors of ``monotone_penalty`` by depth 0 .. P - 1 (JAX
    ``find_best_split``, reference monotone_constraints.hpp:357): K_EPSILON
    while ``penalty >= depth + 1``, else ``1 - penalty / 2^depth`` (penalty
    at most 1) or ``1 - 2^(penalty - 1 - depth)``, plus K_EPSILON, in f32.
    Past depth ``penalty + 40`` every factor is 1.0 in f32, so P is at
    most that (and at most L, the deepest leaf's depth + 1); a deeper
    child reads the last entry."""
    f = np.float32
    pen = f(penalty)
    P = max(1, min(int(L), int(np.ceil(penalty)) + 40))
    out = np.empty(P, np.float32)
    for d in range(P):
        df = f(d)
        if pen >= df + f(1.0):
            out[d] = f(K_EPSILON)
        elif pen <= f(1.0):
            out[d] = f(1.0) - pen / np.exp2(df) + f(K_EPSILON)
        else:
            out[d] = f(1.0) - np.exp2(f(penalty - 1.0) - df) + f(K_EPSILON)
    return torch.from_numpy(out)


def split_pair(hist_g, hist_h, fmeta, info, *, l1: float, l2: float,
               max_delta_step: float, min_gain_to_split: float,
               min_data_in_leaf: int, min_sum_hessian: float,
               max_depth: int, out=None, children: int = 2,
               mono: bool = False, pen=None) -> torch.Tensor:
    """(children, 13) f32 best-split rows (see module doc), written into
    ``out`` when it is given (the learner's preallocated rows).  CPU
    tensors run the plain version; CUDA tensors launch the kernel.
    ``mono`` turns the monotone arm on, ``pen`` (``penalty_table``, on the
    inputs' device) its penalty."""
    if pen is not None and not mono:
        raise ValueError("split_pair: the monotone penalty needs mono=True")
    kw = dict(l1=l1, l2=l2, max_delta_step=max_delta_step,
              min_gain_to_split=min_gain_to_split,
              min_data_in_leaf=min_data_in_leaf,
              min_sum_hessian=min_sum_hessian, max_depth=max_depth,
              children=children, mono=mono, pen=pen)
    if hist_g.device.type == "cpu":
        rows = split_pair_plain(hist_g, hist_h, fmeta, info, **kw)
        return rows if out is None else out.copy_(rows)
    return split_pair_cuda(hist_g, hist_h, fmeta, info, out=out, **kw)


def check_args(hist_g, hist_h, fmeta, info, children=2) -> None:
    """The wrapper's checks of its inputs on the card."""
    F2, BF = hist_g.shape
    if children < 1 or F2 % children or F2 == 0 or BF < 1:
        raise ValueError(f"split_pair needs ({children}F, BF) histograms, "
                         f"got {tuple(hist_g.shape)}")
    kernels.require_cuda(hist_g, torch.float32, "hist_g")
    kernels.require_cuda(hist_h, torch.float32, "hist_h", (F2, BF))
    kernels.require_cuda(fmeta, torch.int32, "fmeta", (F2, 8))
    kernels.require_cuda(info, torch.float32, "info", (F2, 8))


def launcher():
    """The built kernel's ctypes entry, its signature set."""
    fn = kernels.load("split_pair").split_pair_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return fn


def launch_args(hist_g, hist_h, fmeta, info, out, *, l1, l2, max_delta_step,
                min_gain_to_split, min_data_in_leaf, min_sum_hessian,
                max_depth, children=2, mono=False, pen=None) -> list:
    """The arguments of ``launcher()`` for one launch."""
    F2, BF = hist_g.shape
    return [kernels.ptr(hist_g), kernels.ptr(hist_h), kernels.ptr(fmeta),
            kernels.ptr(info), kernels.ptr(out), F2 // children, children,
            BF, l1, l2,
            max_delta_step, min_gain_to_split, float(min_data_in_leaf),
            min_sum_hessian, int(max_depth), int(bool(mono)),
            None if pen is None else kernels.ptr(pen),
            0 if pen is None else int(pen.shape[0]),
            kernels.stream_ptr(hist_g.device)]


def split_pair_cuda(hist_g, hist_h, fmeta, info, *, out=None,
                    **kw) -> torch.Tensor:
    global launches
    C = kw["children"]
    check_args(hist_g, hist_h, fmeta, info, C)
    fn = launcher()
    if out is None:
        out = torch.empty((C, OUT_FIELDS), dtype=torch.float32,
                          device=hist_g.device)
    kernels.require_cuda(out, torch.float32, "out", (C, OUT_FIELDS))
    if kw["pen"] is not None:
        kernels.require_cuda(kw["pen"], torch.float32, "pen")
    err = fn(*launch_args(hist_g, hist_h, fmeta, info, out, **kw))
    kernels.check(err, "split_pair_launch")
    launches += 1
    return out
