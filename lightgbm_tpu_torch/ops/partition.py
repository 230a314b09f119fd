"""Kernel 3: the leaf partition, and its contract shared by the split
mega-kernel.

Counterpart of the TPU kernel ``partition_leaf_pallas``
(lightgbm_tpu/ops/partition_pallas.py), without its TPU mechanism
(packed payload, roll-network compaction, aligned window DMAs): the
scalar layout (``S_*``, ``make_scalars``), the split decision
``decide_left`` (numerical, or a categorical node's set membership, JAX
learner.py ``_goes_left``) and the partition itself.  The same decision is the
``__device__`` function ``decide_left`` in ``csrc/partition.cuh``; the
two must agree for the partition to be bit-identical.
``partition_leaf`` dispatches on the device of its inputs: CPU tensors
run ``partition_leaf_plain``, CUDA tensors launch the hand-written
kernel ``csrc/partition.cu`` or raise.

The contract: a stable two-way partition of the leaf range
``[start, start + cnt)`` -- rows going left first, then rows going
right, each in their original order -- of the (R, N_pad) uint8 or uint16
bin rows (the dataset's bin dtype: uint16 once a group has more than 256
bins) and of all 8 (8, N_pad) payload rows (moved as raw 32-bit words: row 2
holds row ids, rows 3.. the fused step's score and objective rows; the
JAX kernel's ``ghi_live`` keeps only its first rows), in place, with
the left count returned as a (1,) int32 tensor on the buffers' device
and every row outside the range untouched.  ``cnt == 0`` moves nothing.

The kernels take their leaf from a step block on the device (``SB_*``,
``step_block``): ``partition_step`` is the entry that the learner's tree
loop uses, with the grids and scratch sized for ``bound`` rows, the most
a step may hold.  ``partition_leaf`` takes host ints, as before, and
fills a step block for one call.  The plain version reads host scalars
or a step block.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

GHI_ROWS = 8

# launches of the CUDA kernel by this wrapper, a launch recorded into a
# CUDA graph under capture included (a replay launches without the
# wrapper and is not counted; nor is the plain version)
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
S_ISCAT = 11    # categorical split (0/1): left iff the bin is in the set
S_CAT = 12      # the set: W words of bins (bit b & 31 of word b >> 5)
# the words of a set at the least: 256 bins, every uint8 dataset
CAT_WORDS = 8


def cat_words(width: int) -> int:
    """W, the words of a category set over bins [0, width): CAT_WORDS, or
    ceil(width / 32) past 256 bins (uint16 data)."""
    return max(CAT_WORDS, -(-int(width) // 32))


# the step block (csrc/step.cuh SB_*): one small int32 tensor on the
# buffers' device from which the kernels read their leaf, so that a
# captured CUDA graph replays a tree while ops/tree_step.py writes each
# step's block on the device.  A step with cnt == 0 writes no row, no
# histogram-state slot and no tree column.
(SB_START, SB_CNT, SB_COL, SB_BSTART, SB_ISB, SB_NB, SB_DBIN, SB_MTYPE,
 SB_THR, SB_DL, SB_PARENT, SB_WA, SB_WB, SB_SIL, SB_SIDE, SB_VALID, SB_S,
 SB_LEAF, SB_NEW, SB_PEND, SB_DONE, SB_ERR) = range(22)
# the frontier's record 0 after its final step: splits made (pruned ones
# included), steps run
SB_MADE, SB_STEPS = 22, 23
# a categorical split: the flag and its set's W words, which end the
# block: a step block is SB_CAT + W words, STEP_WORDS at W = CAT_WORDS
SB_ISCAT, SB_CAT = 24, 25
STEP_WORDS = SB_CAT + CAT_WORDS
# SB_ERR bits: a range or column outside the launch's bound, a state slot
# outside the state, a leaf or feature out of range in tree_step
ERR_RANGE, ERR_STATE, ERR_STEP = 1, 2, 4


def make_scalars(start, cnt, col, bstart, isb, nb, dbin, mtype, thr, dl,
                 iscat=0, cat=(0,) * CAT_WORDS):
    """The scalar operand as a host list of ints; a categorical split
    (``iscat``) sends a row left when its bin is in the bitset ``cat``."""
    start = int(start)
    return [start >> 7, start & 127, int(cnt), int(col), int(bstart),
            int(isb), int(nb), int(dbin), int(mtype), int(thr), int(dl),
            int(iscat)] + [int(v) for v in cat]


def scalars_start(sc) -> int:
    return (sc[S_A0B] << 7) + sc[S_REM]


def step_len(words: int = CAT_WORDS) -> int:
    """Ints of a step block whose sets have ``words`` words."""
    return SB_CAT + words


def step_words(scalars, idx=(-1, 0, 0, 0), side=0) -> list:
    """The ints of a step block for host ``scalars`` (SB_CAT plus the
    words of their set), the histogram-state slots ``idx = (parent, wa,
    wb, small_is_left)`` and the side histogrammed (0 the range, 1 the
    left child, 2 the right)."""
    cat = scalars[S_CAT:]
    w = [0] * step_len(len(cat))
    w[SB_START] = scalars_start(scalars)
    w[SB_CNT:SB_DL + 1] = scalars[S_CNT:S_DL + 1]
    w[SB_ISCAT] = scalars[S_ISCAT]
    w[SB_CAT:] = cat
    w[SB_PARENT:SB_SIL + 1] = [int(v) for v in idx]
    w[SB_SIDE] = int(side)
    w[SB_VALID] = int(scalars[S_CNT] > 0)
    return w


def step_block(scalars, device, idx=(-1, 0, 0, 0), side=0) -> torch.Tensor:
    """A (SB_CAT + W,) int32 step block on ``device`` (see step_words)."""
    return torch.tensor(step_words(scalars, idx, side), dtype=torch.int32,
                        device=device)


def step_fields(step):
    """(scalars, idx, side) of a step block (on the CPU, reading it is no
    sync)."""
    w = step.tolist()
    return (make_scalars(w[SB_START], *w[SB_CNT:SB_DL + 1], w[SB_ISCAT],
                         w[SB_CAT:]),
            tuple(w[SB_PARENT:SB_SIL + 1]), w[SB_SIDE])


def as_scalars(sc) -> list:
    """Host scalars from host scalars or from a step block."""
    return step_fields(sc)[0] if isinstance(sc, torch.Tensor) else sc


def bin_values(bins: torch.Tensor) -> torch.Tensor:
    """Bins as int32; uint16 bins through their int16 bits, which every
    device's PyTorch converts and indexes (not every op takes uint16)."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16).to(torch.int32) & 0xFFFF
    return bins.to(torch.int32)


def bin_words(bins: torch.Tensor) -> torch.Tensor:
    """The bins as raw words to move: uint16 as int16 (see bin_values)."""
    return bins.view(torch.int16) if bins.dtype == torch.uint16 else bins


def decide_left(colv: torch.Tensor, bstart, isb, nb, dbin, mtype, thr,
                dl, iscat=0, *cat) -> torch.Tensor:
    """Per-row goes-left decision (bool) from raw group-column bins:
    bundled bin offset, missing none/zero/NaN, default bin, threshold
    and default_left (reference: DenseBin::Split), or for a categorical
    split (``iscat``) whether the decoded bin is in the W-word bitset
    ``cat`` (reference: DenseBin::Split's categorical arm).  The split's
    fields are host ints (one split for every row) or int tensors shaped
    like ``colv`` (each row's own node: the traversal of ops/predict.py)."""
    colv = bin_values(colv)
    isb, mtype, dl = (torch.as_tensor(v, device=colv.device)
                      for v in (isb, mtype, dl))
    fb_raw = colv - bstart
    in_rb = (fb_raw >= 1) & (fb_raw <= nb - 1)
    fb = torch.where(isb == 1, torch.where(in_rb, fb_raw, dbin), colv)
    miss = torch.where(mtype == 1, fb == dbin,
                       (mtype == 2) & (fb == nb - 1))
    num_left = torch.where(miss, dl != 0, fb <= thr)
    if isinstance(iscat, int) and not iscat:
        return num_left
    words = torch.stack([torch.as_tensor(v, dtype=torch.int32,
                                         device=colv.device).expand_as(colv)
                         for v in cat])
    nbit = 32 * len(cat)
    ok = (fb >= 0) & (fb < nbit)
    w = torch.gather(words, 0, (torch.clamp(fb, 0, nbit - 1)
                                >> 5)[None].long())[0]
    cat_left = ok & (((w >> (fb & 31)) & 1) != 0)
    return torch.where(torch.as_tensor(iscat, device=colv.device) != 0,
                       cat_left, num_left)


def leaf_decisions(part_bins, scalars):
    """(start, cnt, goes-left flags of the leaf's rows)."""
    scalars = as_scalars(scalars)
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
    raw = bin_words(part_bins)
    raw[:, s:e] = raw[:, s:e][:, order]
    words = part_ghi.view(torch.int32)
    words[:, s:e] = words[:, s:e][:, order]
    return gl.sum().to(torch.int32).reshape(1)


def partition_leaf(part_bins, part_ghi, scalars) -> torch.Tensor:
    """Partition the leaf of ``scalars`` in place; returns the (1,)
    int32 left count on the buffers' device (see module doc)."""
    if part_bins.device.type == "cpu":
        return partition_leaf_plain(part_bins, part_ghi, scalars)
    start, cnt, col = scalars_start(scalars), scalars[S_CNT], scalars[S_COL]
    check_rows(part_bins, part_ghi, start, cnt, col, "partition_leaf")
    nl = torch.empty(1, dtype=torch.int32, device=part_bins.device)
    partition_step(part_bins, part_ghi,
                   step_block(scalars, part_bins.device), nl, bound=cnt)
    return nl


def partition_step(part_bins, part_ghi, step, nl_out, *, bound: int,
                   ws=None) -> None:
    """Partition the leaf named by the step block ``step`` in place and
    write its left count to ``nl_out``: the plain version for CPU
    tensors, csrc/partition.cu for CUDA tensors (its uint8 or uint16
    instantiation, by the bins' dtype).  ``bound`` is the most rows a
    step may hold (the launch's grids and scratch); ``ws`` the workspace
    (default: the device's)."""
    if part_bins.device.type == "cpu":
        nl_out.copy_(partition_leaf_plain(part_bins, part_ghi, step))
        return
    global launches
    ws = ws or workspace(part_bins.device)
    check_step(part_bins, part_ghi, step, nl_out, bound, "partition")
    fn = kernels.load("partition").partition_launch
    fn.restype = ctypes.c_int
    fn.argtypes = PART_ARGTYPES + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    err = fn(*part_launch_args(part_bins, part_ghi, step, nl_out, bound, ws),
             part_bins.element_size(), step.numel() - SB_CAT,
             kernels.stream_ptr(part_bins.device))
    kernels.check(err, "partition_launch")
    launches += 1


BIN_DTYPES = (torch.uint8, torch.uint16)


def require_uint8(part_bins, what) -> None:
    """The kernels that read bins as bytes (the split mega-kernel, the
    frontier's undo: the JAX package's mega kernel and frontier take
    uint8 data only) raise on a uint16 bin tensor, on either device."""
    if part_bins.dtype != torch.uint8:
        raise ValueError(f"{what} takes uint8 bins only (wider data takes "
                         f"the histogram-subtraction body), got "
                         f"{part_bins.dtype}")


def check_bufs(part_bins, part_ghi, what) -> None:
    """Wrapper-side checks of the row buffers shared by the partition, the
    split mega-kernel and the leaf histogram: uint8 or uint16 bins (the
    kernels that read bytes call require_uint8 first); the kernels read
    rows with 16-byte copies, so N_pad is a multiple of 16 and both
    buffers start 16-byte aligned."""
    R, Np = part_bins.shape
    kernels.require_cuda(part_bins, part_bins.dtype, "part_bins")
    if part_bins.dtype not in BIN_DTYPES:
        raise ValueError(f"{what}: bins must be uint8 or uint16, got "
                         f"{part_bins.dtype}")
    kernels.require_cuda(part_ghi, torch.float32, "part_ghi", (GHI_ROWS, Np))
    if Np % 16 or (part_bins.data_ptr() | part_ghi.data_ptr()) % 16:
        raise ValueError(f"{what}: N_pad {Np} is not a multiple of 16 or a "
                         f"buffer is not 16-byte aligned")


def check_rows(part_bins, part_ghi, start, cnt, col, what) -> None:
    """check_bufs, and the host-int call's range and column."""
    R, Np = part_bins.shape
    check_bufs(part_bins, part_ghi, what)
    if not 0 <= col < R:
        raise ValueError(f"{what}: column {col} outside [0, {R})")
    if not (0 <= start and 0 <= cnt < (1 << 24) and start + cnt <= Np):
        raise ValueError(f"{what}: range [{start}, {start + cnt}) outside "
                         f"[0, {Np}) or over 2^24 rows")


def check_step_block(step, what="step block") -> None:
    """A step block on the card: int32, SB_CAT plus at least CAT_WORDS set
    words."""
    kernels.require_cuda(step, torch.int32, what)
    if step.dim() != 1 or step.numel() < STEP_WORDS:
        raise ValueError(f"{what} must be ({STEP_WORDS} + k,) int32, got "
                         f"{tuple(step.shape)}")


def check_step(part_bins, part_ghi, step, nl, bound, what) -> None:
    """The host-known bounds of a step launch: the buffers, the step block
    and left count, and the bound on a step's rows.  The step's own range
    is checked on the device, into its SB_ERR word."""
    check_bufs(part_bins, part_ghi, what)
    check_step_block(step)
    if nl is not None:
        kernels.require_cuda(nl, torch.int32, "left count", (1,))
    if not 0 <= bound <= min(part_bins.shape[1], (1 << 24) - 1):
        raise ValueError(f"{what}: bound {bound} outside [0, "
                         f"min(N_pad, 2^24))")


# (bins, R, Np, ghi, step, bound, nl_out, status, ticket, epoch, T, sbins,
#  sghi, scap): the leading arguments of partition_launch and
#  split_mega_launch
PART_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                 + [ctypes.c_void_p] * 4
                 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong])


def scratch_rows(bound: int) -> int:
    """Columns of the right-side scratch for steps of up to bound rows."""
    return -(-bound // 16) * 16 + 16


def part_launch_args(part_bins, part_ghi, step, nl, bound, ws,
                     move=True) -> list:
    """The PART_ARGTYPES values of one launch; with ``move`` the tile
    status words and the right-side scratch come from the workspace,
    sized for ``bound`` rows."""
    R, Np = part_bins.shape
    T = tile_rows(R, part_bins.element_size())
    scap = scratch_rows(bound)
    if move:
        status = ws.buffer("status", -(-(bound + 15) // T), torch.int64,
                           zero=True)
        sbins = ws.buffer("sbins", R * scap * part_bins.element_size(),
                          torch.uint8)
        sghi = ws.buffer("sghi", GHI_ROWS * scap, torch.int32)
    else:
        status = sbins = sghi = ws.ticket
    return [kernels.ptr(part_bins), R, Np, kernels.ptr(part_ghi),
            kernels.ptr(step), bound, kernels.ptr(nl), kernels.ptr(status),
            kernels.ptr(ws.ticket), kernels.ptr(ws.epoch), T,
            kernels.ptr(sbins), kernels.ptr(sghi), scap]


PART_SMEM = 72 * 1024       # shared memory of one tile: three fit an SM


def part_smem_bytes(R: int, T: int, bin_bytes: int = 1) -> int:
    """Shared memory of a tile of T rows of R bin rows of ``bin_bytes``
    each (csrc/partition.cuh)."""
    return 32 * T + ((R * T * bin_bytes + 15) & ~15) + 4 * T


def tile_rows(R: int, bin_bytes: int = 1) -> int:
    """Rows per partition tile for R bin rows of ``bin_bytes``: the
    largest of 1024, 512, ..., 32 whose staged tile fits PART_SMEM."""
    for T in (1024, 512, 256, 128, 64, 32):
        if part_smem_bytes(R, T, bin_bytes) <= PART_SMEM:
            return T
    raise ValueError(f"partition: {R} bin rows do not fit a 32-row tile")


class Workspace:
    """Device scratch of the partition, the split mega-kernel and the leaf
    histogram, kept between launches instead of allocated per call.  The
    ticket counter and the histograms' accumulators and done counters
    (``acc`` / ``done`` of the mega-kernel, ``leaf_acc`` / ``leaf_done``
    of the leaf histogram) are zero between launches (each launch leaves
    them so); the tile status words carry the partition's epoch, a device
    word that each partition moves on, so a word left by an earlier
    launch reads as not yet published.  Launches on one device run in
    the order of its current stream, which the workspace relies on.  The
    learner keeps a workspace of its own, sized once for the root's rows
    and then frozen: a captured CUDA graph holds its addresses, so a
    frozen workspace raises instead of growing."""

    def __init__(self, device):
        self.device = device
        self._bufs = {}
        self.frozen = False
        self.ticket = self.buffer("ticket", 4, torch.int32, zero=True)
        self.epoch = self.buffer("epoch", 1, torch.int32, zero=True)
        self.epoch.fill_(1)

    def buffer(self, name, numel, dtype, zero=False):
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < numel:
            if self.frozen:
                raise RuntimeError(f"workspace buffer {name!r} would grow to "
                                   f"{numel} after the workspace was frozen")
            make = torch.zeros if zero else torch.empty
            buf = make(max(numel, 1), dtype=dtype, device=self.device)
            self._bufs[name] = buf
        return buf


_workspaces = {}


def workspace(device) -> Workspace:
    ws = _workspaces.get(device)
    if ws is None:
        ws = _workspaces[device] = Workspace(device)
    return ws
