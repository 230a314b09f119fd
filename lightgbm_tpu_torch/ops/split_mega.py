"""Kernel 2: the split mega-kernel -- partition a leaf and build both
children's histograms from one split decision.

Counterpart of the TPU kernel ``split_megakernel_pallas``
(lightgbm_tpu/ops/split_megakernel_pallas.py).  ``split_mega``
dispatches on the device of its inputs: CPU tensors run
``split_mega_plain`` (plain PyTorch: the ``both_children_hist_xla``
histogram math plus ``ops/partition.py:partition_leaf_plain``), CUDA
tensors launch the
hand-written kernel ``csrc/split_mega.cu`` or raise.

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
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .partition import (GHI_ROWS, S_CNT, S_COL, TILE_ROWS, leaf_decisions,
                        partition_leaf_plain, scalars_start)

MIN_CHUNK_ROWS = 4096       # rows per histogram block, at least
MAX_CHUNKS = 128            # histogram chunks per leaf, at most

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


def hist_chunks(cnt: int):
    """(chunk_rows, nchunks) of the histogram grid for a leaf of cnt rows."""
    per = -(-cnt // MAX_CHUNKS)
    chunk = max(MIN_CHUNK_ROWS, -(-per // 256) * 256)
    return chunk, max(1, -(-cnt // chunk))


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


def split_mega(part_bins, part_ghi, scalars, *, num_bins: int,
               num_groups: int, move: bool = True):
    """Partition the leaf of ``scalars`` in place and return
    ``(left_count, hist)`` (see module doc)."""
    kw = dict(num_bins=num_bins, num_groups=num_groups, move=move)
    if part_bins.device.type == "cpu":
        return split_mega_plain(part_bins, part_ghi, scalars, **kw)
    return split_mega_cuda(part_bins, part_ghi, scalars, **kw)


def split_mega_cuda(part_bins, part_ghi, scalars, *, num_bins, num_groups,
                    move=True):
    global launches
    R, Np = part_bins.shape
    G = num_groups
    BH, Bp = hist_geometry(num_bins)
    start, cnt, col = scalars_start(scalars), scalars[S_CNT], scalars[S_COL]
    kernels.require_cuda(part_bins, torch.uint8, "part_bins")
    kernels.require_cuda(part_ghi, torch.float32, "part_ghi", (GHI_ROWS, Np))
    if not (0 < G <= R and 0 <= col < R and Bp <= 256):
        raise ValueError(f"split_mega: bad geometry G={G} R={R} col={col} "
                         f"num_bins={num_bins}")
    if not (0 <= start and 0 <= cnt < (1 << 24) and start + cnt <= Np):
        raise ValueError(f"split_mega: range [{start}, {start + cnt}) "
                         f"outside [0, {Np}) or over 2^24 rows")
    dev = part_bins.device
    chunk, nchunks = hist_chunks(cnt)
    ntiles = max(1, -(-cnt // TILE_ROWS))
    partials = torch.empty(nchunks * G * 4 * Bp, dtype=torch.float32,
                           device=dev)
    tiles = torch.empty(ntiles, dtype=torch.int32, device=dev)
    nl = torch.empty(1, dtype=torch.int32, device=dev)
    hist = torch.empty((G, 4 * BH, 16), dtype=torch.float32, device=dev)
    scap = cnt if (move and cnt > 0) else 1
    sbins = torch.empty((R, scap), dtype=torch.uint8, device=dev)
    sghi = torch.empty((GHI_ROWS, scap), dtype=torch.int32, device=dev)
    fn = kernels.load("split_mega").split_mega_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    err = fn(kernels.ptr(part_bins), R, Np, kernels.ptr(part_ghi),
             kernels.ptr(partials), chunk, nchunks, kernels.ptr(tiles),
             ntiles, kernels.ptr(nl), kernels.ptr(sbins), kernels.ptr(sghi),
             scap, kernels.ptr(hist), start, *scalars[S_CNT:], G, Bp,
             int(bool(move)), kernels.stream_ptr(dev))
    kernels.check(err, "split_mega_launch")
    launches += 1
    return nl, hist
