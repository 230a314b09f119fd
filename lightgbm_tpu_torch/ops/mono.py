"""Intermediate monotone constraints: after each split, every leaf's
output bounds from the leaves it is comparable with, and a re-search of
the leaves whose bounds changed.

No TPU kernel corresponds to it: the JAX package's ``_mc_refresh``
(lightgbm_tpu/models/learner.py; the reference's
IntermediateLeafConstraints, monotone_constraints.hpp) is XLA inside the
while-loop body of ``_build_tree_impl``.  The port runs it inside the
tree's captured CUDA graph, between a split's commit and the next
election (ops/tree_step.py ``MODE_COMMIT`` / ``MODE_ELECT``), as three
hand-written kernels of ``csrc/mono.cu`` around the pair search
(ops/split_pair.py, and ops/split_cat.py with categorical features) over
all L leaves, ``children = L``.  Each function dispatches on the device
of its inputs: CPU tensors run its plain version, CUDA tensors launch its
kernel or raise.  Kernel and plain version agree bit for bit: the
refresh compares integers and takes maxima and minima of f32 values, the
planes convert exact int64 sums as the histogram state's children are
converted, the overlay copies.

  * ``mono_refresh``: each leaf carries its bin box, (2, L + 1, F) int32
    ``boxes`` (its lowest and highest bin per feature, written by
    ops/tree_step.py).  Two live leaves are comparable along monotone
    feature m when their boxes overlap in every feature but m and are
    disjoint along m; a leaf's lower bound is the largest output of the
    comparable leaves its direction puts below it, its upper bound the
    smallest of those above it (-inf / +inf when there is none).  The
    live leaves are the step block's ``SB_S + 1``; a stopped tree
    (``SB_DONE``) changes nothing.  It writes every live leaf's bounds
    into leafmat's ``LM_CMIN`` / ``LM_CMAX``, a (L,) int32 flag of the
    leaves whose bounds changed, and the (L F, 8) info rows of the
    re-search (each leaf's sums, bag-aware count, depth, the tree's
    feature mask and its bounds).  On the card one block a leaf, its
    threads over the other leaves: the grid covers the leaf pairs.
  * ``mono_planes``: the changed leaves' (2, L, F, Bp) f32 search planes
    from the histogram state (ops/hist_state.py), times the quantized
    scale when there is one; with EFB bundles the per-feature view
    (ops/feat_view.py).  On the card the state is int64 and each value is
    converted as the state kernel converts the children it hands the
    search, (int64 -> double) * 2^-k -> f32, a bundled default bin fixed
    in int64 first (``mono_planes_fixed_plain`` is this arithmetic in
    plain PyTorch); on the CPU the state is f32 and the planes are its
    slots, as JAX's refresh reads its state.
  * ``mono_overlay``: each changed leaf's re-searched row into leafmat's
    ``LM_BGAIN .. LM_BISCAT`` and, with categorical features, its set
    into ``leafcat``.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .feat_view import _gather, feat_view_plain, scale_inverse
from .partition import SB_DONE, SB_S, check_step_block
from .quantize import scale_planes
from .split_pair import IN_CMAX, IN_CMIN, OUT_FIELDS
from .tree_step import (FMETA_ROWS, LM_BGAIN, LM_BISCAT, LM_CMAX, LM_CMIN,
                        LM_CNT_G, LM_DEPTH, LM_SUM_G, LM_SUM_H, LM_VALUE,
                        NLF)

FM_MONO_ROW = 7     # fmeta's monotone direction row (ops/tree_step.py)
INFO_COLS = 8

# launches of each CUDA kernel by its wrapper, a launch recorded into a
# CUDA graph under capture included (a replay launches without the
# wrapper and is not counted; nor are the plain versions)
launches = {"mono_refresh": 0, "mono_planes": 0, "mono_overlay": 0}


def _fi(x: torch.Tensor) -> torch.Tensor:
    """f32 fields -> the int32 their bits hold."""
    return x.contiguous().view(torch.int32)


# -- the refresh --------------------------------------------------------
def mono_refresh_plain(lm, boxes, fmeta, step, fmask, changed, info) -> None:
    """Plain version of ``mono_refresh``, in place (see module doc); it
    runs on the CPU and, for the card's checks, on the card."""
    L, F, dev = lm.shape[1] - 1, fmeta.shape[1], lm.device
    changed.zero_()
    if int(step[SB_DONE]):
        return
    live = int(step[SB_S]) + 1
    lo, hi = boxes[0, :L], boxes[1, :L]
    vals = lm[LM_VALUE, :L]
    exist = torch.arange(L, device=dev) < live
    # [Y, X, f]: the two boxes overlap along f
    inter = (lo[:, None, :] <= hi[None, :, :]) & (lo[None, :, :]
                                                   <= hi[:, None, :])
    miss = (~inter).sum(dim=2)
    pair_ok = exist[:, None] & exist[None, :]
    new_min = torch.full((L,), float("-inf"), device=dev)
    new_max = torch.full((L,), float("inf"), device=dev)
    mono = fmeta[FM_MONO_ROW]
    for m in torch.nonzero(mono).reshape(-1).tolist():
        only_m = (miss - (~inter[:, :, m]).to(miss.dtype)) == 0
        below = hi[None, :, m] < lo[:, None, m]      # X entirely below Y
        above = lo[None, :, m] > hi[:, None, m]
        lower, upper = (below, above) if int(mono[m]) > 0 else (above, below)
        new_min = torch.maximum(new_min, torch.where(
            only_m & lower & pair_ok, vals[None, :],
            float("-inf")).max(dim=1).values)
        new_max = torch.minimum(new_max, torch.where(
            only_m & upper & pair_ok, vals[None, :],
            float("inf")).min(dim=1).values)
    cmin = torch.where(exist, new_min, lm[LM_CMIN, :L])
    cmax = torch.where(exist, new_max, lm[LM_CMAX, :L])
    changed.copy_((exist & ((cmin != lm[LM_CMIN, :L])
                            | (cmax != lm[LM_CMAX, :L]))).to(torch.int32))
    lm[LM_CMIN, :L] = cmin
    lm[LM_CMAX, :L] = cmax
    rows = torch.zeros((L, F, INFO_COLS), dtype=torch.float32, device=dev)
    rows[:, :, 0] = lm[LM_SUM_G, :L, None]
    rows[:, :, 1] = lm[LM_SUM_H, :L, None]
    rows[:, :, 2] = _fi(lm[LM_CNT_G, :L]).float()[:, None]
    rows[:, :, 3] = _fi(lm[LM_DEPTH, :L]).float()[:, None]
    rows[:, :, 4] = fmask[None, :]
    rows[:, :, IN_CMIN] = cmin[:, None]
    rows[:, :, IN_CMAX] = cmax[:, None]
    info.copy_(rows.view(L * F, INFO_COLS))


def mono_refresh(lm, boxes, fmeta, step, fmask, changed, info) -> None:
    """Every leaf's bounds, the changed flags and the re-search's info
    rows, in place (see module doc): ``lm`` (NLF, L + 1) f32, ``boxes``
    (2, L + 1, F) int32, ``fmeta`` (8, F) int32, the step block, the
    (F,) feature mask, ``changed`` (L,) int32 and ``info`` (L F, 8)."""
    args = (lm, boxes, fmeta, step, fmask, changed, info)
    if lm.device.type == "cpu":
        return mono_refresh_plain(*args)
    L, F = lm.shape[1] - 1, fmeta.shape[1]
    for t, dtype, name, shape in (
            (lm, torch.float32, "leafmat", (NLF, L + 1)),
            (boxes, torch.int32, "boxes", (2, L + 1, F)),
            (fmeta, torch.int32, "fmeta", (FMETA_ROWS, F)),
            (fmask, torch.float32, "feature mask", (F,)),
            (changed, torch.int32, "changed", (L,)),
            (info, torch.float32, "info", (L * F, INFO_COLS))):
        kernels.require_cuda(t, dtype, name, shape)
    check_step_block(step)
    if L < 1 or F < 1:
        raise ValueError(f"mono_refresh: {L} leaves, {F} features")
    fn = kernels.load("mono").mono_refresh_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    err = fn(*(kernels.ptr(t) for t in args), L, F,
             kernels.stream_ptr(lm.device))
    kernels.check(err, "mono_refresh_launch")
    launches["mono_refresh"] += 1


# -- the re-search's planes --------------------------------------------
def mono_planes_plain(state, info, *, view=None, scale=None) -> torch.Tensor:
    """The CPU's (2, L, F, Bp) planes (see module doc): the f32 state's
    first L slots, times ``scale``; with ``view`` the per-feature view,
    the bundled default bins fixed from the leaves' sums in ``info``."""
    L = info.shape[0] // (view.F if view is not None else state.shape[2])
    ch = scale_planes(state[:L].transpose(0, 1), scale, 0)
    if view is None:
        return ch.contiguous()
    return feat_view_plain(ch, info, view)


def mono_planes_fixed_plain(state, changed, absmax, *, kcnt: int,
                            view=None, scale=None) -> torch.Tensor:
    """The card's planes in plain PyTorch, bit for bit: the changed
    leaves' slots of the int64 ``state``, a bundled default bin fixed in
    int64, then (int64 -> double) * 2^-k -> f32, times ``scale``; zeros
    for the leaves not changed."""
    L = changed.shape[0]
    ch = state[:L].transpose(0, 1)                          # (2, L, G, Bp)
    if view is not None:
        feat = _gather(ch, view)                            # int64
        total = ch.sum(dim=3)[:, :, view.meta[0].long()]
        feat[:, :, :, 0] += torch.where(view.fix, total - feat.sum(dim=3), 0)
        ch = feat
    inv = scale_inverse(absmax, kcnt).to(state.device)
    out = scale_planes((ch.double() * inv[:, None, None, None]).float(),
                       scale, 0)
    return torch.where(changed.bool()[None, :, None, None], out, 0.0)


def mono_planes(state, changed, absmax, info, *, kcnt: int, out,
                view=None, scale=None) -> None:
    """The changed leaves' search planes into ``out`` (2, L, F, Bp) (see
    module doc): CPU tensors run ``mono_planes_plain`` on the f32 state
    and ``info``; CUDA tensors launch the kernel on the int64 state,
    ``changed``, ``absmax`` and ``kcnt``, or raise."""
    if out.device.type == "cpu":
        out.copy_(mono_planes_plain(state, info, view=view, scale=scale))
        return
    _, L, F, Bp = out.shape
    G = state.shape[2]
    if (state.dim() != 4 or tuple(state.shape[1:]) != (2, G, Bp)
            or state.shape[0] < L or (view is None and F != G)):
        raise ValueError(f"mono_planes: state {tuple(state.shape)} against "
                         f"planes {tuple(out.shape)}")
    if not 0 < kcnt < (1 << 24):
        raise ValueError(f"mono_planes: kcnt {kcnt}")
    for t, dtype, name, shape in (
            (state, torch.int64, "state", None),
            (changed, torch.int32, "changed", (L,)),
            (absmax, torch.float32, "absmax", (2,)),
            (out, torch.float32, "out", (2, L, F, Bp))):
        kernels.require_cuda(t, dtype, name, shape)
    if view is not None:
        kernels.require_cuda(view.meta, torch.int32, "view", (4, F))
    if scale is not None:
        kernels.require_cuda(scale, torch.float32, "scale", (2,))
    fn = kernels.load("mono").mono_planes_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 3
    err = fn(kernels.ptr(state), kernels.ptr(changed), kernels.ptr(absmax),
             None if view is None else kernels.ptr(view.meta), G, F, Bp, L,
             int(kcnt), None if scale is None else kernels.ptr(scale),
             kernels.ptr(out), kernels.stream_ptr(out.device))
    kernels.check(err, "mono_planes_launch")
    launches["mono_planes"] += 1


# -- the overlay --------------------------------------------------------
def mono_overlay_plain(lm, leafcat, changed, rows, cats=None) -> None:
    """Plain version of ``mono_overlay``, in place on CPU tensors."""
    idx = torch.nonzero(changed).reshape(-1)
    lm[LM_BGAIN:LM_BISCAT + 1, idx] = rows[idx].t()
    if cats is not None:
        leafcat[idx] = cats[idx]


def mono_overlay(lm, leafcat, changed, rows, cats=None) -> None:
    """Each changed leaf's re-searched row ``rows`` (L, 13) into leafmat's
    best-split fields and, when ``cats`` (L, W) is given, its set into
    ``leafcat`` (L + 1, W), in place."""
    if lm.device.type == "cpu":
        return mono_overlay_plain(lm, leafcat, changed, rows, cats)
    L = changed.shape[0]
    W = leafcat.shape[1]
    for t, dtype, name, shape in (
            (lm, torch.float32, "leafmat", (NLF, L + 1)),
            (leafcat, torch.int32, "leafcat", (L + 1, W)),
            (changed, torch.int32, "changed", (L,)),
            (rows, torch.float32, "rows", (L, OUT_FIELDS))):
        kernels.require_cuda(t, dtype, name, shape)
    if cats is not None:
        kernels.require_cuda(cats, torch.int32, "cats", (L, W))
    fn = kernels.load("mono").mono_overlay_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    err = fn(kernels.ptr(lm), kernels.ptr(leafcat), kernels.ptr(changed),
             kernels.ptr(rows), None if cats is None else kernels.ptr(cats),
             L, W, kernels.stream_ptr(lm.device))
    kernels.check(err, "mono_overlay_launch")
    launches["mono_overlay"] += 1

