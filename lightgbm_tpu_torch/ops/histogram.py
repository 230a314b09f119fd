"""Kernel 4: the leaf histogram -- per (group, bin) sums of grad and hess
over one leaf's contiguous rows.

Counterpart of the TPU kernel ``leaf_hist_pallas`` and its XLA form
``leaf_hist_slice`` (lightgbm_tpu/ops/histogram.py), which share one
contract: the (G, B, 2) grad/hess histogram of the partitioned rows
``[start, start + cnt)`` of the (R, N_pad) uint8 bin rows, grad and hess
from payload rows 0 and 1 of the (8, N_pad) f32 payload.  ``leaf_hist``
dispatches on the device of its inputs: CPU tensors run
``leaf_hist_plain``, CUDA tensors launch the hand-written kernel
``csrc/leaf_hist.cu`` or raise.

Two options serve the histogram-subtraction split path
(models/learner.py):
  * ``child=(nl, side)``: the rows are the child (side 0 left, 1 right)
    of the partition of ``[start, start + cnt)`` whose left count is the
    (1,) int32 tensor ``nl`` on the buffers' device -- the kernel reads
    the child's range on the device, so the learner needs no host sync
    between the partition and the histogram;
  * ``planes=True`` returns the (2, G, Bp) planes the kernel writes
    (grad plane, hess plane; bin b at column b, Bp = 16 * ceil(B / 16),
    columns past a feature's bins zero) -- the histogram-state slot of
    ops/hist_state.py.  Otherwise the result is the (G, B, 2) view of
    those planes, the JAX functions' layout.

The plain version sums in f64 and rounds to f32 once, so it is the
correctly rounded sum; ``leaf_hist_reference`` returns those f64 sums
with each bin's absolute mass, the yardstick any f32 order of summation
is held to: ``|h - ref| <= rtol * |ref| + atol * mass``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernels
from .partition import GHI_ROWS
from .split_mega import hist_geometry

MIN_CHUNK_ROWS = 4096       # rows per histogram block, at least
MAX_CHUNKS = 128            # histogram chunks per leaf, at most

# launches of the CUDA kernel (the plain version is not counted)
launches = 0


def hist_chunks(cnt: int):
    """(chunk_rows, nchunks) of the histogram grid for a leaf of cnt rows."""
    per = -(-cnt // MAX_CHUNKS)
    chunk = max(MIN_CHUNK_ROWS, -(-per // 256) * 256)
    return chunk, max(1, -(-cnt // chunk))


def as_gb2(planes: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(2, G, Bp) planes -> the (G, B, 2) view of the JAX contract."""
    return planes.permute(1, 2, 0)[:, :num_bins]


def child_range(start: int, cnt: int, child) -> Tuple[int, int]:
    """(start, count) of the rows a call covers, on the host."""
    if child is None:
        return start, cnt
    nl = int(child[0][0])
    return (start, nl) if child[1] == 0 else (start + nl, cnt - nl)


def _planes64(part_bins, part_ghi, s: int, c: int, G: int, Bp: int,
              absolute: bool) -> torch.Tensor:
    """f64 (2, G, Bp) sums of grad / hess (or of their absolute values)
    over the rows [s, s + c)."""
    dev = part_bins.device
    idx = (part_bins[:G, s:s + c].long()
           + (torch.arange(G, device=dev) * Bp)[:, None]).reshape(-1)
    out = torch.zeros((2, G * Bp), dtype=torch.float64, device=dev)
    for p in range(2):
        v = part_ghi[p, s:s + c].double()
        v = v.abs() if absolute else v
        out[p].index_add_(0, idx, v.expand(G, c).reshape(-1))
    return out.view(2, G, Bp)


def leaf_hist_reference(part_bins, part_ghi, start: int, cnt: int, *,
                        num_bins: int, num_groups: int, child=None):
    """f64 (2, G, Bp) planes of the histogram and of each bin's absolute
    mass (the sum of |grad| or |hess| over its rows)."""
    _, Bp = hist_geometry(num_bins)
    s, c = child_range(start, cnt, child)
    return (_planes64(part_bins, part_ghi, s, c, num_groups, Bp, False),
            _planes64(part_bins, part_ghi, s, c, num_groups, Bp, True))


def leaf_hist_plain(part_bins, part_ghi, start: int, cnt: int, *,
                    num_bins: int, num_groups: int, child=None,
                    planes: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract)."""
    _, Bp = hist_geometry(num_bins)
    s, c = child_range(start, cnt, child)
    h = _planes64(part_bins, part_ghi, s, c, num_groups, Bp, False).float()
    return h if planes else as_gb2(h, num_bins)


def leaf_hist(part_bins, part_ghi, start: int, cnt: int, *, num_bins: int,
              num_groups: int,
              child: Optional[Tuple[torch.Tensor, int]] = None,
              planes: bool = False) -> torch.Tensor:
    """The leaf's histogram (see module doc)."""
    kw = dict(num_bins=num_bins, num_groups=num_groups, child=child,
              planes=planes)
    if part_bins.device.type == "cpu":
        return leaf_hist_plain(part_bins, part_ghi, start, cnt, **kw)
    return leaf_hist_cuda(part_bins, part_ghi, start, cnt, **kw)


def leaf_hist_cuda(part_bins, part_ghi, start, cnt, *, num_bins, num_groups,
                   child=None, planes=False) -> torch.Tensor:
    global launches
    R, Np = part_bins.shape
    G = num_groups
    _, Bp = hist_geometry(num_bins)
    kernels.require_cuda(part_bins, torch.uint8, "part_bins")
    kernels.require_cuda(part_ghi, torch.float32, "part_ghi", (GHI_ROWS, Np))
    if not (0 < G <= R and Bp <= 256):
        raise ValueError(f"leaf_hist: bad geometry G={G} R={R} "
                         f"num_bins={num_bins}")
    if not (0 <= start and 0 <= cnt < (1 << 24) and start + cnt <= Np):
        raise ValueError(f"leaf_hist: range [{start}, {start + cnt}) "
                         f"outside [0, {Np}) or over 2^24 rows")
    nl, side = None, 0
    if child is not None:
        nl, side = child[0], int(child[1]) + 1
        kernels.require_cuda(nl, torch.int32, "child left count", (1,))
        if side not in (1, 2):
            raise ValueError(f"leaf_hist: child side {child[1]} not 0 or 1")
    dev = part_bins.device
    chunk, nchunks = hist_chunks(cnt)
    partials = torch.empty(nchunks * G * 2 * Bp, dtype=torch.float32,
                           device=dev)
    hist = torch.empty((2, G, Bp), dtype=torch.float32, device=dev)
    fn = kernels.load("leaf_hist").leaf_hist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    err = fn(kernels.ptr(part_bins), R, Np, kernels.ptr(part_ghi), start,
             cnt, None if nl is None else kernels.ptr(nl), side,
             kernels.ptr(partials), chunk, nchunks, G, Bp, kernels.ptr(hist),
             kernels.stream_ptr(dev))
    kernels.check(err, "leaf_hist_launch")
    launches += 1
    return hist if planes else as_gb2(hist, num_bins)
