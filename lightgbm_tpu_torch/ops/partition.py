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
    check_rows(part_bins, part_ghi, start, cnt, col, "partition_leaf")
    nl = torch.empty(1, dtype=torch.int32, device=part_bins.device)
    fn = kernels.load("partition").partition_launch
    fn.restype = ctypes.c_int
    fn.argtypes = PART_ARGTYPES + [ctypes.c_void_p]
    err = fn(*part_launch_args(part_bins, part_ghi, nl, scalars),
             kernels.stream_ptr(part_bins.device))
    kernels.check(err, "partition_launch")
    launches += 1
    return nl


def check_rows(part_bins, part_ghi, start, cnt, col, what) -> None:
    """Wrapper-side checks of the row buffers and the leaf range shared by
    the partition, the split mega-kernel and the leaf histogram: the
    kernels read rows with 16-byte copies, so N_pad is a multiple of 16
    and both buffers start 16-byte aligned."""
    R, Np = part_bins.shape
    kernels.require_cuda(part_bins, torch.uint8, "part_bins")
    kernels.require_cuda(part_ghi, torch.float32, "part_ghi", (GHI_ROWS, Np))
    if not 0 <= col < R:
        raise ValueError(f"{what}: column {col} outside [0, {R})")
    if not (0 <= start and 0 <= cnt < (1 << 24) and start + cnt <= Np):
        raise ValueError(f"{what}: range [{start}, {start + cnt}) outside "
                         f"[0, {Np}) or over 2^24 rows")
    if Np % 16 or (part_bins.data_ptr() | part_ghi.data_ptr()) % 16:
        raise ValueError(f"{what}: N_pad {Np} is not a multiple of 16 or a "
                         f"buffer is not 16-byte aligned")


# (bins, R, Np, ghi, nl_out, status, ticket, epoch, T, ntiles, sbins,
#  sghi, scap, start, cnt, col, bstart, isb, nb, dbin, mtype, thr, dl):
# the leading arguments of partition_launch and split_mega_launch
PART_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_longlong] + [ctypes.c_int] * 9)


def part_launch_args(part_bins, part_ghi, nl, scalars, move=True) -> list:
    """The PART_ARGTYPES values of one launch; with ``move`` the tile
    status words, ticket and right-side scratch come from the device's
    workspace and the launch takes a fresh epoch."""
    R, Np = part_bins.shape
    start, cnt = scalars_start(scalars), scalars[S_CNT]
    ws = workspace(part_bins.device)
    T = tile_rows(R)
    ntiles = max(1, -(-(start + cnt - (start & ~15)) // T))
    scap = -(-cnt // 16) * 16 + 16
    if move and cnt > 0:
        status, epoch = ws.status(ntiles)
        sbins = ws.buffer("sbins", R * scap, torch.uint8)
        sghi = ws.buffer("sghi", GHI_ROWS * scap, torch.int32)
    else:
        status, epoch, sbins, sghi = ws.ticket, 1, ws.ticket, ws.ticket
    return [kernels.ptr(part_bins), R, Np, kernels.ptr(part_ghi),
            kernels.ptr(nl), kernels.ptr(status), kernels.ptr(ws.ticket),
            epoch, T, ntiles, kernels.ptr(sbins), kernels.ptr(sghi), scap,
            start, *scalars[S_CNT:]]


PART_SMEM = 72 * 1024       # shared memory of one tile: three fit an SM


def part_smem_bytes(R: int, T: int) -> int:
    """Shared memory of a tile of T rows (csrc/partition.cuh)."""
    return 32 * T + ((R * T + 15) & ~15) + 4 * T


def tile_rows(R: int) -> int:
    """Rows per partition tile for R bin rows: the largest of 1024, 512,
    ..., 32 whose staged tile fits PART_SMEM."""
    for T in (1024, 512, 256, 128, 64, 32):
        if part_smem_bytes(R, T) <= PART_SMEM:
            return T
    raise ValueError(f"partition: {R} bin rows do not fit a 32-row tile")


class Workspace:
    """Device scratch of the partition, the split mega-kernel and the leaf
    histogram, kept between launches instead of allocated per call.  The
    ticket counter and the histograms' accumulators and done counters
    (``acc`` / ``done`` of the mega-kernel, ``leaf_acc`` / ``leaf_done``
    of the leaf histogram) are zero between launches (each launch leaves
    them so); the tile status words carry the launch's epoch, so a word
    left by an earlier launch reads as not yet published.  Launches on
    one device run in the order of its current stream, which the
    workspace relies on."""

    def __init__(self, device):
        self.device = device
        self._bufs = {}
        self._epoch = 0
        self.ticket = self.buffer("ticket", 4, torch.int32, zero=True)

    def buffer(self, name, numel, dtype, zero=False):
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < numel:
            make = torch.zeros if zero else torch.empty
            buf = make(max(numel, 1), dtype=dtype, device=self.device)
            self._bufs[name] = buf
        return buf

    def status(self, ntiles):
        """(status words, epoch) for a partition launch of ntiles tiles;
        fresh zero words whenever they grow or the epoch would wrap."""
        words = self._bufs.get("status")
        if (words is None or words.numel() < ntiles
                or self._epoch >= (1 << 32) - 1):
            words = torch.zeros(ntiles, dtype=torch.int64, device=self.device)
            self._bufs["status"] = words
            self._epoch = 0
        self._epoch += 1
        return words, self._epoch


_workspaces = {}


def workspace(device) -> Workspace:
    ws = _workspaces.get(device)
    if ws is None:
        ws = _workspaces[device] = Workspace(device)
    return ws
