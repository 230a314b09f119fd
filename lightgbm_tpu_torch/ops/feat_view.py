"""The per-feature histogram view of EFB-bundled data (FixHistogram).

Port of ``_feat_view`` of lightgbm_tpu/models/learner.py (reference:
FixHistogram, cuda_histogram_constructor.cu).  No TPU kernel corresponds
to it: the JAX package gathers in XLA.  With EFB bundles the histograms
are per group (G rows of Bp bins) and the pair search reads one row a
feature (F rows): a feature alone in its group reads its group's row; a
bundled feature's bin b >= 1 lives at column ``bin_start + b`` of its
group's row, and its default bin 0 -- which no row of the bundle's
column records for it -- is the leaf's total minus the feature's other
bins.  Bins at or past a feature's ``num_bin`` are 0.

``feat_view`` takes the children of a split, (2, 2, G, Bp) = (plane,
child, G, Bp), and writes their (2, 2, F, Bp) view, the pair search's
grad and hess inputs (ops/split_pair.py).  It dispatches on the device:

  * CPU tensors run ``feat_view_plain``, the JAX package's arithmetic:
    the f32 children planes, the leaf totals from the pair search's info
    rows (the sums the parent's split recorded), the fix in f32;
  * CUDA tensors launch ``csrc/feat_view.cu``, which reads the children
    from the int64 histogram state of the subtraction path (slots
    ``SB_WA`` / ``SB_WB`` of the step block, ops/hist_state.py) and forms
    the fix in exact int64 -- the group's total minus the feature's
    other bins -- before converting every bin, (int64 -> double) * 2^-k
    -> f32, as the state's f32 children are.  ``feat_view_fixed_plain``
    is its arithmetic in plain PyTorch, bit for bit.

Quantized training (``scale``, the (2,) f32 device word of
ops/quantize.py): the kernel multiplies each f32 value by its plane's
scale, one f32 product (the scale arm), as ``feat_view_fixed_plain``
does; the CPU's view reads children and totals that are scaled already,
as JAX's ``_feat_view`` reads the scaled histogram.

A bin that is empty in exact arithmetic is exactly 0 on the card; the
CPU's f32 fix may leave a rounding residue there, as JAX's does (its
f32 sums in another order), so the CPU view matches JAX's to f32
rounding (tests/test_torch_efb.py states the tolerance).  A step of no
rows (``cnt == 0``) gives zeros.  Any width: a uint16 dataset's groups
(Bp past 256) take the kernel's striding arm.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import kernels
from .partition import SB_CNT, SB_WA, SB_WB, check_step_block
from .quantize import scale_planes
from .split_mega import fixed_exponent

# launches of the CUDA kernel by this wrapper, a launch recorded into a
# CUDA graph under capture included (a replay is not counted; nor are the
# plain versions)
launches = 0


class View:
    """A dataset's feature view: per feature (F,) int32 ``group``,
    ``bin_start``, ``is_bundled`` and ``num_bin`` on ``device``, and the
    (F, Bp) gather index into the flattened (G * Bp + 1) group row whose
    last entry is a zero (JAX learner.py ``feat_gather``)."""

    def __init__(self, group, bin_start, is_bundled, num_bin, G: int,
                 Bp: int, device):
        F = len(group)
        gather = np.full((F, Bp), G * Bp, np.int64)
        for i in range(F):
            g, nb, bs = int(group[i]), int(num_bin[i]), int(bin_start[i])
            if is_bundled[i]:
                gather[i, 1:nb] = g * Bp + bs + np.arange(1, nb)
            else:
                gather[i, :nb] = g * Bp + np.arange(nb)
        self.F, self.G, self.Bp = F, G, Bp
        dev = torch.device(device)
        self.meta = torch.as_tensor(np.stack([
            group, bin_start, is_bundled, num_bin]).astype(np.int32),
            device=dev)
        self.gather = torch.as_tensor(gather, device=dev)
        self.fix = torch.as_tensor(np.asarray(is_bundled) != 0, device=dev)

    def to(self, device) -> "View":
        v = object.__new__(View)
        v.__dict__.update(self.__dict__)
        for n in ("meta", "gather", "fix"):
            setattr(v, n, getattr(self, n).to(device))
        return v


def _gather(planes, view: View):
    """(P, C, G, Bp) -> (P, C, F, Bp) gathered through ``view``, the
    padding entries 0."""
    P, C = planes.shape[:2]
    flat = torch.cat([planes.reshape(P, C, -1),
                      planes.new_zeros((P, C, 1))], dim=2)
    return flat[:, :, view.gather]


def feat_view_plain(children, info, view: View) -> torch.Tensor:
    """The CPU's view (see module doc): ``children`` (2, C, G, Bp) f32
    (C = 2: a split's children), ``info`` the pair search's (C F, 8) rows
    (each child's sums in columns 0 and 1)."""
    F = view.F
    feat = _gather(children, view)
    known = feat.sum(dim=3)                                   # (2, C, F)
    tot = info.view(-1, F, 8)[:, 0, :2].t()                   # (plane, child)
    fix = torch.where(view.fix, tot[:, :, None] - known, 0.0)
    feat[:, :, :, 0] += fix
    return feat


def scale_inverse(absmax, kcnt: int) -> torch.Tensor:
    """(2,) f64 2^-k of the two planes at the tree's scale (the histogram
    state's: ops/histogram.py, ``kcnt`` the root's row count)."""
    return torch.tensor([math.ldexp(1.0, -fixed_exponent(a, kcnt))
                         for a in absmax.tolist()], dtype=torch.float64)


def feat_view_fixed_plain(state, step, absmax, kcnt: int, view: View,
                          scale=None) -> torch.Tensor:
    """The card's view in plain PyTorch, bit for bit: the children's
    exact int64 sums from the state slots of ``step``, the fix in int64,
    then (int64 -> double) * 2^-k -> f32, times ``scale`` when given."""
    w = step.tolist()
    out = torch.zeros((2, 2, view.F, view.Bp), dtype=torch.float32,
                      device=state.device)
    if w[SB_CNT] == 0:
        return out
    ch = torch.stack([state[w[SB_WA]], state[w[SB_WB]]], dim=1)
    feat = _gather(ch, view)                                  # int64
    total = ch.sum(dim=3)[:, :, view.meta[0].long()]          # (2, 2, F)
    fix = torch.where(view.fix, total - feat.sum(dim=3), 0)
    feat[:, :, :, 0] += fix
    inv = scale_inverse(absmax, kcnt).to(state.device)
    return scale_planes((feat.double() * inv[:, None, None, None]).float(),
                        scale, 0)


def feat_view(children, info, state, step, absmax, *, kcnt: int,
              view: View, out, scale=None) -> None:
    """The (2, 2, F, Bp) view of the split's children into ``out`` (see
    module doc): CPU tensors run ``feat_view_plain`` on ``children`` and
    ``info``; CUDA tensors launch the kernel on ``state``, ``step``,
    ``absmax`` and ``kcnt``, or raise."""
    if out.device.type == "cpu":
        out.copy_(feat_view_plain(children, info, view))
        return
    feat_view_cuda(state, step, absmax, kcnt=kcnt, view=view, out=out,
                   scale=scale)


def feat_view_cuda(state, step, absmax, *, kcnt: int, view: View,
                   out, scale=None) -> None:
    global launches
    F, G, Bp = view.F, view.G, view.Bp
    if state.dim() != 4 or tuple(state.shape[1:]) != (2, G, Bp):
        raise ValueError(f"feat_view: state must be (slots, 2, {G}, {Bp}), "
                         f"got {tuple(state.shape)}")
    if not (0 < kcnt < (1 << 24) and 0 < Bp and F > 0):
        raise ValueError(f"feat_view: kcnt {kcnt}, Bp {Bp}, F {F}")
    check_step_block(step)
    for t, dtype, name, shape in (
            (state, torch.int64, "state", None),
            (absmax, torch.float32, "absmax", (2,)),
            (view.meta, torch.int32, "view", (4, F)),
            (out, torch.float32, "out", (2, 2, F, Bp))):
        kernels.require_cuda(t, dtype, name, shape)
    if scale is not None:
        kernels.require_cuda(scale, torch.float32, "scale", (2,))
    fn = kernels.load("feat_view").feat_view_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 3
    err = fn(kernels.ptr(state), kernels.ptr(step), kernels.ptr(absmax),
             kernels.ptr(view.meta), int(state.shape[0]), G, F, Bp,
             int(kcnt), None if scale is None else kernels.ptr(scale),
             kernels.ptr(out), kernels.stream_ptr(out.device))
    kernels.check(err, "feat_view_launch")
    launches += 1
