"""Kernel 3: the leaf partition, and its contract shared by the split
mega-kernel.

Counterpart of the TPU kernel ``partition_leaf_pallas``
(lightgbm_tpu/ops/partition_pallas.py), without its TPU mechanism
(packed payload, roll-network compaction, aligned window DMAs): the
scalar layout (``S_*``, ``make_scalars``), the numerical split decision
``decide_left`` and the partition itself.  The same decision is the
``__device__`` function ``decide_left`` in ``csrc/partition.cuh``; the
two must agree for the partition to be bit-identical.
``partition_leaf`` dispatches on the device of its inputs: CPU tensors
run ``partition_leaf_plain``, CUDA tensors launch the hand-written
kernel ``csrc/partition.cu`` or raise.

The contract: a stable two-way partition of the leaf range
``[start, start + cnt)`` -- rows going left first, then rows going
right, each in their original order -- of the (R, N_pad) uint8 bin rows
and of all 8 (8, N_pad) payload rows (moved as raw 32-bit words: row 2
holds row ids, rows 3.. the fused step's score and objective rows; the
JAX kernel's ``ghi_live`` keeps only its first rows), in place, with
the left count returned as a (1,) int32 tensor on the buffers' device
and every row outside the range untouched.  ``cnt == 0`` moves nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

GHI_ROWS = 8
TILE_ROWS = 2048            # rows per partition tile (csrc/partition.cuh)

# launches of the CUDA kernel (the plain version is not counted)
launches = 0

# scalar layout (lightgbm_tpu/ops/partition_pallas.py S_*)
S_A0B = 0       # start >> 7
S_REM = 1       # start & 127
S_CNT = 2       # rows in the leaf range
S_COL = 3       # group row of the split feature
S_BSTART = 4    # bundled bin offset
S_ISB = 5       # feature is bundled (0/1)
S_NB = 6        # feature num_bin
S_DBIN = 7      # feature default bin
S_MTYPE = 8     # missing type (0 none / 1 zero / 2 nan)
S_THR = 9       # split threshold (bin)
S_DL = 10       # default_left (0/1)
N_SCALARS = 11


def make_scalars(start, cnt, col, bstart, isb, nb, dbin, mtype, thr, dl):
    """The scalar operand as a host list of ints."""
    start = int(start)
    return [start >> 7, start & 127, int(cnt), int(col), int(bstart),
            int(isb), int(nb), int(dbin), int(mtype), int(thr), int(dl)]


def scalars_start(sc) -> int:
    return (sc[S_A0B] << 7) + sc[S_REM]


def decide_left(colv: torch.Tensor, bstart: int, isb: int, nb: int,
                dbin: int, mtype: int, thr: int, dl: int) -> torch.Tensor:
    """Per-row goes-left decision (bool) from raw group-column bins:
    bundled bin offset, missing none/zero/NaN, default bin, threshold
    and default_left (reference: DenseBin::Split)."""
    colv = colv.to(torch.int32)
    fb_raw = colv - bstart
    in_rb = (fb_raw >= 1) & (fb_raw <= nb - 1)
    fb = torch.where(in_rb, fb_raw, dbin) if isb == 1 else colv
    if mtype == 1:
        miss = fb == dbin
    elif mtype == 2:
        miss = fb == nb - 1
    else:
        miss = torch.zeros_like(fb, dtype=torch.bool)
    return torch.where(miss, bool(dl), fb <= thr)


def leaf_decisions(part_bins, scalars):
    """(start, cnt, goes-left flags of the leaf's rows)."""
    start, cnt = scalars_start(scalars), scalars[S_CNT]
    colv = part_bins[scalars[S_COL], start:start + cnt]
    return start, cnt, decide_left(colv, *scalars[S_COL + 1:])


def partition_leaf_plain(part_bins, part_ghi, scalars) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract)."""
    start, cnt, gl = leaf_decisions(part_bins, scalars)
    if cnt == 0:
        return torch.zeros(1, dtype=torch.int32, device=part_bins.device)
    s, e = start, start + cnt
    order = torch.cat([torch.nonzero(gl)[:, 0], torch.nonzero(~gl)[:, 0]])
    part_bins[:, s:e] = part_bins[:, s:e][:, order]
    words = part_ghi.view(torch.int32)
    words[:, s:e] = words[:, s:e][:, order]
    return gl.sum().to(torch.int32).reshape(1)


def partition_leaf(part_bins, part_ghi, scalars) -> torch.Tensor:
    """Partition the leaf of ``scalars`` in place; returns the (1,)
    int32 left count on the buffers' device (see module doc)."""
    if part_bins.device.type == "cpu":
        return partition_leaf_plain(part_bins, part_ghi, scalars)
    return partition_leaf_cuda(part_bins, part_ghi, scalars)


def partition_leaf_cuda(part_bins, part_ghi, scalars) -> torch.Tensor:
    global launches
    R, Np = part_bins.shape
    start, cnt, col = scalars_start(scalars), scalars[S_CNT], scalars[S_COL]
    kernels.require_cuda(part_bins, torch.uint8, "part_bins")
    kernels.require_cuda(part_ghi, torch.float32, "part_ghi", (GHI_ROWS, Np))
    if not 0 <= col < R:
        raise ValueError(f"partition_leaf: column {col} outside [0, {R})")
    if not (0 <= start and 0 <= cnt < (1 << 24) and start + cnt <= Np):
        raise ValueError(f"partition_leaf: range [{start}, {start + cnt}) "
                         f"outside [0, {Np}) or over 2^24 rows")
    dev = part_bins.device
    ntiles = max(1, -(-cnt // TILE_ROWS))
    scap = max(cnt, 1)
    tiles = torch.empty(ntiles, dtype=torch.int32, device=dev)
    nl = torch.empty(1, dtype=torch.int32, device=dev)
    sbins = torch.empty((R, scap), dtype=torch.uint8, device=dev)
    sghi = torch.empty((GHI_ROWS, scap), dtype=torch.int32, device=dev)
    fn = kernels.load("partition").partition_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    err = fn(kernels.ptr(part_bins), R, Np, kernels.ptr(part_ghi),
             kernels.ptr(tiles), ntiles, kernels.ptr(nl), kernels.ptr(sbins),
             kernels.ptr(sghi), scap, start, *scalars[S_CNT:],
             kernels.stream_ptr(dev))
    kernels.check(err, "partition_launch")
    launches += 1
    return nl
