"""Quantized-gradient training: the discretizer as one pass over the
payload, and the scale arm of the histograms.

Port of the JAX package's discretizer (lightgbm_tpu/models/boosting.py:
the in-program one of ``_setup_fused_phys`` and the eager
``_discretize_gradients``; reference: GradientDiscretizer).  No TPU
kernel corresponds to it: the JAX package discretizes in XLA.  The port
runs it as the hand-written kernel ``csrc/quantize.cu``, one launch a
tree; ``quantize`` dispatches on the device of the payload: CPU tensors
run ``quantize_plain``, CUDA tensors launch the kernel or raise.  The two
agree bit for bit: the draw is integer arithmetic (utils/random.py's
Threefry-2x32), the rest single f32 operations.

The payload ``ghi`` (R, Npad) holds this iteration's grad and hess in
rows 0 and 1 (after sampling; zero on pad rows) and each row's original
id in row 2 (int32 bits; pad rows hold N); ``absmax`` is the (2,) f32
max|grad|, max|hess| over it.  In place, rows 0 and 1 become the integer
carriers

  gs = max(max|g| / (bins / 2), 1e-30)
  hs = max(max|h| if const_h else max|h| / bins, 1e-30)
  g  = trunc(g / gs + (u_g if g >= 0 else -u_g)) * vf
  h  = (1 if const_h else trunc(h / hs + u_h)) * vf

(vf 0 on pad rows), and ``scale`` (2,) f32 on the device gets (gs, hs).
``keys`` = (key_g, key_h), two uint32 pairs, draw ``u`` as JAX's uniform
at the row's physical position (``by_rowid=False``: the fused
iteration's draw over the padded width) or at its original id (the eager
iteration's draw over the N rows in original order); ``keys=None`` is
round-to-nearest (u = 0.5, ``stochastic_rounding=false``).  With
``renew_rows=(tg, th)`` the true grad and hess are first copied into
payload rows tg and th, which ride the partition to the quantized leaf
renewal.

The histograms then sum exact integers, and the scale reaches the split
search through each histogram kernel's scale arm (``scale_planes``): the
f32 value of the exact integer sum, then one f32 product with the
plane's scale, as the JAX package's ``_scale_hist`` rounds.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from ..utils.random import torch_uniform_at

# launches of the CUDA kernel by this wrapper (the plain version is not
# counted)
launches = 0


def scale_planes(h: torch.Tensor, scale: Optional[torch.Tensor],
                 dim: int) -> torch.Tensor:
    """The plain scale arm: f32 histogram planes ``h`` whose axis ``dim``
    alternates grad, hess (index % 2) times the (2,) ``scale``; ``h``
    itself when ``scale`` is None.  One f32 product an entry (JAX
    learner.py ``_scale_hist``)."""
    if scale is None:
        return h
    n = h.shape[dim]
    shape = [1] * h.dim()
    shape[dim] = n
    s = scale.to(h.device).repeat((n + 1) // 2)[:n].view(shape)
    return h * s


def _max_nan(x: torch.Tensor, lo: float) -> torch.Tensor:
    return torch.maximum(x, torch.tensor(np.float32(lo), device=x.device))


def quantize_plain(ghi, absmax, scale, *, N: int, bins: int, const_h: bool,
                   keys=None, by_rowid: bool = False,
                   renew_rows: Optional[Sequence[int]] = None) -> None:
    """Plain version of the kernel, in place (see module doc)."""
    f32 = np.float32
    dev = ghi.device
    absmax = absmax.to(dev)
    gs = _max_nan(absmax[0] / f32(bins / 2.0), 1e-30)
    hs = _max_nan(absmax[1] if const_h else absmax[1] / f32(bins), 1e-30)
    rowid = ghi[2].view(torch.int32)
    vf = (rowid != N).to(torch.float32)
    g, h = ghi[0].clone(), ghi[1].clone()
    if renew_rows is not None:
        ghi[renew_rows[0]] = g
        ghi[renew_rows[1]] = h
    if keys is not None:
        idx = (torch.where(rowid >= 0, rowid, 0).long() if by_rowid
               else torch.arange(ghi.shape[1], device=dev))
        rg = torch_uniform_at(keys[0], idx)
        rh = torch_uniform_at(keys[1], idx)
    else:
        rg = rh = torch.full_like(g, 0.5)
    ig = torch.trunc(g / gs + torch.where(g >= 0, rg, -rg))
    ih = torch.ones_like(h) if const_h else torch.trunc(h / hs + rh)
    ghi[0] = ig * vf
    ghi[1] = ih * vf
    scale.copy_(torch.stack([gs, hs]).to(scale.device))


def quantize(ghi, absmax, scale, **kw) -> None:
    """One discretizer pass in place (see module doc)."""
    if ghi.device.type == "cpu":
        return quantize_plain(ghi, absmax, scale, **kw)
    return quantize_cuda(ghi, absmax, scale, **kw)


def quantize_cuda(ghi, absmax, scale, *, N: int, bins: int, const_h: bool,
                  keys=None, by_rowid: bool = False,
                  renew_rows: Optional[Sequence[int]] = None) -> None:
    global launches
    R, Np = ghi.shape
    if not (3 <= R and 0 <= N < Np < (1 << 31) and bins >= 1):
        raise ValueError(f"quantize: payload {tuple(ghi.shape)}, N {N}, "
                         f"bins {bins}")
    tg, th = (-1, -1) if renew_rows is None else (int(v) for v in renew_rows)
    if renew_rows is not None and not (3 <= tg < R and 3 <= th < R
                                       and tg != th):
        raise ValueError(f"quantize: renewal rows {tuple(renew_rows)} "
                         f"outside payload rows 3..{R - 1}")
    kernels.require_cuda(ghi, torch.float32, "payload")
    kernels.require_cuda(absmax, torch.float32, "absmax", (2,))
    kernels.require_cuda(scale, torch.float32, "scale", (2,))
    kg, kh = _key_words(keys)
    fn = kernels.load("quantize").quantize_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_uint] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    err = fn(kernels.ptr(ghi), int(R), int(Np), int(N), kernels.ptr(absmax),
             kernels.ptr(scale), int(bins), int(bool(const_h)),
             int(keys is not None), int(bool(by_rowid)), *kg, *kh, tg, th,
             kernels.stream_ptr(ghi.device))
    kernels.check(err, "quantize_launch")
    launches += 1


def _key_words(keys) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if keys is None:
        return (0, 0), (0, 0)
    return tuple(tuple(int(w) & 0xFFFFFFFF for w in k[:2])
                 for k in keys[:2])
