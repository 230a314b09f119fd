"""The leaf-partition contract shared by the split mega-kernel.

Port of the contract of lightgbm_tpu/ops/partition_pallas.py, without
its TPU mechanism (packed payload, roll-network compaction, aligned
window DMAs): the scalar layout (``S_*``, ``make_scalars``) and the
numerical split decision ``decide_left``.  The same decision is the
``__device__`` function ``decide_left`` in ``csrc/partition.cuh``; the
two must agree for the partition to be bit-identical.

The contract: a stable two-way partition of the leaf range
``[start, start + cnt)`` -- rows going left first, then rows going
right, each in their original order -- of the bin rows and of every
payload row, with the left count returned and every row outside the
range untouched.
"""

from __future__ import annotations

import torch

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
