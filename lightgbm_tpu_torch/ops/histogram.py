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

The two versions sum differently.  The plain version, which the CPU
runs, sums in f64 and rounds to f32 once, so it is the correctly rounded
sum, and the JAX parity tests keep their fixtures and bars.  The kernel
sums exactly in 64-bit fixed point, as the split mega-kernel's histogram
does (ops/split_mega.py): each grad (hess) becomes round(v * 2^k), k =
``fixed_exponent`` of a bound on |grad| (|hess|) and the count of rows
the call sums (a child's count is read on the device), and each bin's
integer sum is converted once to f32.  ``leaf_hist_fixed_plain`` is that
arithmetic in plain PyTorch, bit-identical to the kernel.  The bound is
``absmax``, a (2,) f32 tensor of max|grad| and max|hess| on the
buffers' device over at least the rows summed (the learner passes one
per tree); without it the kernel's wrapper takes it over
``[start, start + cnt)``, a child's parent included, and so does
``leaf_hist_fixed_plain``.  The CUDA kernel needs N_pad a multiple of
16 and 16-byte aligned buffers.

``leaf_hist_reference`` returns the f64 sums with each bin's absolute
mass, the yardstick any f32 rounding of the sums is held to:
``|h - ref| <= rtol * |ref| + atol * mass``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernels
from .partition import check_rows, workspace
from .split_mega import fixed_rows, hist_geometry, leaf_absmax

# launches of the CUDA kernel (the plain version is not counted)
launches = 0


def as_gb2(planes: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(2, G, Bp) planes -> the (G, B, 2) view of the JAX contract."""
    return planes.permute(1, 2, 0)[:, :num_bins]


def child_range(start: int, cnt: int, child) -> Tuple[int, int]:
    """(start, count) of the rows a call covers, on the host."""
    if child is None:
        return start, cnt
    nl = int(child[0][0])
    return (start, nl) if child[1] == 0 else (start + nl, cnt - nl)


def _planes(part_bins, vals, s: int, c: int, G: int, Bp: int):
    """(2, G, Bp) sums of the two (c,) value rows ``vals`` (grad-like,
    hess-like; their dtype) over the bins of the rows [s, s + c)."""
    dev = part_bins.device
    idx = (part_bins[:G, s:s + c].long()
           + (torch.arange(G, device=dev) * Bp)[:, None]).reshape(-1)
    out = torch.zeros((2, G * Bp), dtype=vals[0].dtype, device=dev)
    for p in range(2):
        out[p].index_add_(0, idx, vals[p].expand(G, c).reshape(-1))
    return out.view(2, G, Bp)


def _planes64(part_bins, part_ghi, s: int, c: int, G: int, Bp: int,
              absolute: bool) -> torch.Tensor:
    """f64 (2, G, Bp) sums of grad / hess (or of their absolute values)
    over the rows [s, s + c)."""
    vals = [part_ghi[p, s:s + c].double() for p in range(2)]
    return _planes(part_bins, [v.abs() if absolute else v for v in vals],
                   s, c, G, Bp)


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


def leaf_hist_fixed_plain(part_bins, part_ghi, start: int, cnt: int, *,
                          num_bins: int, num_groups: int, child=None,
                          planes: bool = False, absmax=None):
    """The kernel's arithmetic in plain PyTorch, bit for bit:
    ``split_mega.fixed_rows`` of the rows summed (k from ``absmax`` and
    their count), ``index_add_`` in int64, then (int64 -> double) * 2^-k
    -> f32.  ``absmax`` as for the kernel (default: over
    ``[start, start + cnt)``)."""
    _, Bp = hist_geometry(num_bins)
    if absmax is None:
        absmax = leaf_absmax(part_ghi, start, cnt)
    s, c = child_range(start, cnt, child)
    vals, inv = fixed_rows(part_ghi, s, c, absmax)
    acc = _planes(part_bins, vals, s, c, num_groups, Bp)
    h = (acc.double() * inv[:, None, None]).float()
    return h if planes else as_gb2(h, num_bins)


def leaf_hist(part_bins, part_ghi, start: int, cnt: int, *, num_bins: int,
              num_groups: int,
              child: Optional[Tuple[torch.Tensor, int]] = None,
              planes: bool = False, absmax=None) -> torch.Tensor:
    """The leaf's histogram (see module doc; the CPU's plain version does
    not use ``absmax``)."""
    kw = dict(num_bins=num_bins, num_groups=num_groups, child=child,
              planes=planes)
    if part_bins.device.type == "cpu":
        return leaf_hist_plain(part_bins, part_ghi, start, cnt, **kw)
    return leaf_hist_cuda(part_bins, part_ghi, start, cnt, absmax=absmax,
                          **kw)


def leaf_hist_cuda(part_bins, part_ghi, start, cnt, *, num_bins, num_groups,
                   child=None, planes=False, absmax=None) -> torch.Tensor:
    global launches
    R, Np = part_bins.shape
    G = num_groups
    _, Bp = hist_geometry(num_bins)
    check_rows(part_bins, part_ghi, start, cnt, 0, "leaf_hist")
    if not (0 < G <= R and Bp <= 256):
        raise ValueError(f"leaf_hist: bad geometry G={G} R={R} "
                         f"num_bins={num_bins}")
    nl, side = None, 0
    if child is not None:
        nl, side = child[0], int(child[1]) + 1
        kernels.require_cuda(nl, torch.int32, "child left count", (1,))
        if side not in (1, 2):
            raise ValueError(f"leaf_hist: child side {child[1]} not 0 or 1")
    dev = part_bins.device
    if absmax is None:
        absmax = leaf_absmax(part_ghi, start, cnt)
    kernels.require_cuda(absmax, torch.float32, "absmax", (2,))
    ws = workspace(dev)
    acc = ws.buffer("leaf_acc", G * 2 * Bp, torch.int64, zero=True)
    done = ws.buffer("leaf_done", G, torch.int32, zero=True)
    hist = torch.empty((2, G, Bp), dtype=torch.float32, device=dev)
    fn = kernels.load("leaf_hist").leaf_hist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    err = fn(kernels.ptr(part_bins), R, Np, kernels.ptr(part_ghi), start,
             cnt, None if nl is None else kernels.ptr(nl), side,
             kernels.ptr(absmax), kernels.ptr(acc), kernels.ptr(done), G, Bp,
             kernels.ptr(hist), kernels.stream_ptr(dev))
    kernels.check(err, "leaf_hist_launch")
    launches += 1
    return hist if planes else as_gb2(hist, num_bins)
