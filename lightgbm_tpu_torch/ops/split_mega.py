"""Kernel 2: the split mega-kernel -- partition a leaf and build both
children's histograms from one split decision.

Counterpart of the TPU kernel ``split_megakernel_pallas``
(lightgbm_tpu/ops/split_megakernel_pallas.py).  ``split_mega``
dispatches on the device of its inputs: CPU tensors run
``split_mega_plain`` (plain PyTorch: the ``both_children_hist_xla``
histogram math in f32 plus ``ops/partition.py:partition_leaf_plain``),
CUDA tensors launch the hand-written kernel ``csrc/split_mega.cu`` or
raise.

Buffers (partitioned IN PLACE):
  part_bins: (R, N_pad) uint8, one row per feature group (R >= G);
  part_ghi: (8, N_pad) f32 payload rows (grad, hess, row-id bits, score,
    objective rows), moved as raw 32-bit words;
  scalars: the leaf range and split decision, ``ops/partition.py
    make_scalars(start, cnt, col, bstart, isb, nb, dbin, mtype, thr, dl)``
    (host ints).
Returns ``(left_count, hist)``: a (1,) int32 tensor on the buffers'
device, and the (G, 4 * BH, 16) f32 accumulator of ``unpack_hist4``
(planes left-grad, left-hess, right-grad, right-hess; bin = hi*16+lo)
over the rows of the leaf as they were before the partition.  A call
with ``cnt == 0`` moves nothing and returns zeros.  With
``move=False`` the rows stay where they are and the left count is
``cnt``: the learner's root histogram is that call with an all-left
decision.

The two versions sum differently.  The plain version adds f32 values
with ``index_add_``.  The kernel sums exactly in 64-bit fixed point:
each grad (hess) becomes round(v * 2^k), k = ``fixed_exponent`` of a
bound on |grad| (|hess|) and the leaf's row count, and each bin's
integer sum is converted once to f32.  ``hist_fixed_plain`` is that
arithmetic in plain PyTorch, bit-identical to the kernel.  The bound is
``absmax``, a (2,) f32 tensor of max|grad| and max|hess| on the
buffers' device over at least the leaf's rows (the learner passes one
per tree); without it the kernel's wrapper takes it over the leaf.  The
CUDA kernel needs N_pad a multiple of 16 and 16-byte aligned buffers.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import kernels
from .partition import (GHI_ROWS, PART_ARGTYPES, S_CNT, S_COL, check_rows,
                        leaf_decisions, part_launch_args,
                        partition_leaf_plain, scalars_start, workspace)

FIXED_BITS = 62             # a bin's fixed-point sum stays below 2^62

# launches of the CUDA kernel (the plain version is not counted)
launches = 0


def hist_geometry(num_bins: int):
    """(BH, Bp): high-digit cardinality and the padded bin axis
    (bin b lives at [hi = b >> 4, lo = b & 15])."""
    BH = (num_bins + 15) // 16
    return BH, BH * 16


def unpack_hist4(acc, num_bins: int):
    """(G, 4*BH, 16) accumulator -> four (G, Bp) planes."""
    G = acc.shape[0]
    _, Bp = hist_geometry(num_bins)
    h4 = acc.reshape(G, 4, Bp)
    return h4[:, 0], h4[:, 1], h4[:, 2], h4[:, 3]


def _hist_add(hist, bins, gl, g, h, Bp: int) -> None:
    """Add the rows' grad/hess into the flat (G, 4, Bp) histogram."""
    G, cnt = bins.shape
    base = (torch.arange(G, device=bins.device) * (4 * Bp))[:, None]
    side = torch.where(gl, 0, 2 * Bp)[None, :]
    idx = (bins.long() + base + side).reshape(-1)
    hist.index_add_(0, idx, g.to(hist.dtype).expand(G, cnt).reshape(-1))
    hist.index_add_(0, idx + Bp, h.to(hist.dtype).expand(G, cnt).reshape(-1))


def hist_reference(part_bins, part_ghi, scalars, *, num_bins: int,
                   num_groups: int):
    """f64 histogram of a split and each bin's absolute mass (the sum of
    |grad| or |hess| over its rows), both (G, 4*BH, 16): the yardstick a
    f32 histogram is held to, |h - ref| <= rtol*|ref| + atol*mass, since
    any f32 order of summation errs in proportion to the mass."""
    G = num_groups
    BH, Bp = hist_geometry(num_bins)
    start, cnt, gl = leaf_decisions(part_bins, scalars)
    seg = part_bins[:G, start:start + cnt]
    g = part_ghi[0, start:start + cnt].double()
    h = part_ghi[1, start:start + cnt].double()
    ref = torch.zeros(G * 4 * Bp, dtype=torch.float64, device=seg.device)
    mass = torch.zeros_like(ref)
    _hist_add(ref, seg, gl, g, h, Bp)
    _hist_add(mass, seg, gl, g.abs(), h.abs(), Bp)
    return ref.view(G, 4 * BH, 16), mass.view(G, 4 * BH, 16)


def split_mega_plain(part_bins, part_ghi, scalars, *, num_bins: int,
                     num_groups: int, move: bool = True):
    """Plain PyTorch version of the kernel (same contract)."""
    G = num_groups
    BH, Bp = hist_geometry(num_bins)
    dev = part_bins.device
    hist = torch.zeros(G * 4 * Bp, dtype=torch.float32, device=dev)
    start, cnt, gl = leaf_decisions(part_bins, scalars)
    if cnt == 0:
        return (torch.zeros(1, dtype=torch.int32, device=dev),
                hist.view(G, 4 * BH, 16))
    s, e = start, start + cnt
    _hist_add(hist, part_bins[:G, s:e], gl, part_ghi[0, s:e],
              part_ghi[1, s:e], Bp)
    if not move:
        return (torch.full((1,), cnt, dtype=torch.int32, device=dev),
                hist.view(G, 4 * BH, 16))
    return (partition_leaf_plain(part_bins, part_ghi, scalars),
            hist.view(G, 4 * BH, 16))


def fixed_exponent(amax: float, cnt: int) -> int:
    """Exponent k of a plane's fixed-point scale 2^k: the largest k with
    cnt * amax * 2^k < 2^FIXED_BITS (the f32 bound times a count below
    2^24 is exact in double), clamped to the range a finite f32 needs.
    Same function as fixed_exponent in csrc/split_mega.cu."""
    _, e = math.frexp(float(amax) * float(cnt))
    return min(max(FIXED_BITS - e, -100), 220)


def leaf_absmax(part_ghi, start: int, cnt: int):
    """(2,) f32 max|grad|, max|hess| over the leaf's rows (zeros for no
    rows)."""
    if cnt == 0:
        return torch.zeros(2, dtype=torch.float32, device=part_ghi.device)
    return part_ghi[:2, start:start + cnt].abs().amax(dim=1)


def fixed_rows(part_ghi, s: int, c: int, absmax):
    """The fixed-point form of the grad and hess of the rows [s, s + c)
    that both kernels' histograms sum: round(v * 2^k) in double to int64,
    k = ``fixed_exponent`` of ``absmax`` (per plane) and c.  Returns the
    two (c,) int64 rows and the (2,) f64 factors 2^-k that convert their
    sums back."""
    ks = [fixed_exponent(a, c) for a in absmax.tolist()]
    vals = [torch.round(part_ghi[p, s:s + c].double()
                        * math.ldexp(1.0, ks[p])).long() for p in (0, 1)]
    inv = torch.tensor([math.ldexp(1.0, -k) for k in ks],
                       dtype=torch.float64, device=part_ghi.device)
    return vals, inv


def hist_fixed_plain(part_bins, part_ghi, scalars, *, num_bins: int,
                     num_groups: int, absmax=None):
    """The kernel's histogram in plain PyTorch, bit for bit: ``fixed_rows``,
    ``index_add_`` in int64, then (int64 -> double) * 2^-k -> f32.
    ``absmax`` as for the kernel (default: over the leaf)."""
    G = num_groups
    BH, Bp = hist_geometry(num_bins)
    start, cnt, gl = leaf_decisions(part_bins, scalars)
    acc = torch.zeros(G * 4 * Bp, dtype=torch.int64, device=part_bins.device)
    if cnt == 0:
        return acc.float().view(G, 4 * BH, 16)
    if absmax is None:
        absmax = leaf_absmax(part_ghi, start, cnt)
    (g, h), inv = fixed_rows(part_ghi, start, cnt, absmax)
    _hist_add(acc, part_bins[:G, start:start + cnt], gl, g, h, Bp)
    return ((acc.view(G, 4, Bp).double() * inv.repeat(2)[:, None]).float()
            .view(G, 4 * BH, 16))


def split_mega(part_bins, part_ghi, scalars, *, num_bins: int,
               num_groups: int, move: bool = True, absmax=None):
    """Partition the leaf of ``scalars`` in place and return
    ``(left_count, hist)`` (see module doc; the CPU's plain version does
    not use ``absmax``)."""
    kw = dict(num_bins=num_bins, num_groups=num_groups, move=move)
    if part_bins.device.type == "cpu":
        return split_mega_plain(part_bins, part_ghi, scalars, **kw)
    return split_mega_cuda(part_bins, part_ghi, scalars, absmax=absmax, **kw)


def split_mega_cuda(part_bins, part_ghi, scalars, *, num_bins, num_groups,
                    move=True, absmax=None):
    global launches
    R, Np = part_bins.shape
    G = num_groups
    BH, Bp = hist_geometry(num_bins)
    start, cnt, col = scalars_start(scalars), scalars[S_CNT], scalars[S_COL]
    check_rows(part_bins, part_ghi, start, cnt, col, "split_mega")
    if not (0 < G <= R and Bp <= 256):
        raise ValueError(f"split_mega: bad geometry G={G} R={R} "
                         f"num_bins={num_bins}")
    dev = part_bins.device
    if absmax is None:
        absmax = leaf_absmax(part_ghi, start, cnt)
    kernels.require_cuda(absmax, torch.float32, "absmax", (2,))
    ws = workspace(dev)
    acc = ws.buffer("acc", G * 4 * Bp, torch.int64, zero=True)
    done = ws.buffer("done", G, torch.int32, zero=True)
    nl = torch.empty(1, dtype=torch.int32, device=dev)
    hist = torch.empty((G, 4 * BH, 16), dtype=torch.float32, device=dev)
    fn = kernels.load("split_mega").split_mega_launch
    fn.restype = ctypes.c_int
    fn.argtypes = PART_ARGTYPES + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    err = fn(*part_launch_args(part_bins, part_ghi, nl, scalars, move),
             kernels.ptr(absmax), kernels.ptr(acc), kernels.ptr(done),
             kernels.ptr(hist), G, Bp, int(bool(move)),
             kernels.stream_ptr(dev))
    kernels.check(err, "split_mega_launch")
    launches += 1
    return nl, hist
