"""Row sampling of the fused iteration: bagging, balanced bagging and GOSS
as one pass over the payload.

Port of the in-program sampling of ``_setup_fused_phys``
(lightgbm_tpu/models/boosting.py).  No TPU kernel corresponds to it: the
JAX package draws and masks in XLA.  The port runs it as the
hand-written kernel ``csrc/sample.cu``, one launch an iteration;
``sample`` dispatches on the device of the payload: CPU tensors run
``sample_plain``, CUDA tensors launch the kernel or raise.  The two agree
bit for bit: the draw is integer arithmetic (utils/random.py's
Threefry-2x32), then f32 comparisons and products.

The payload ``ghi`` (8, Npad) holds this iteration's grad and hess in
rows 0 and 1 (zero on pad rows) and each row's original id in row 2
(int32 bits; pad rows hold N).  By ``mode``, for the host key ``key``
(two uint32):

  * ``MODE_BAG``: ``u`` = the uniform draw of ``key`` at the row's
    original id (JAX: ``uniform(key, (N + 1,))[rowid]``); a real row is
    in the bag when ``u < frac``;
  * ``MODE_BALANCED``: the same draw against ``pos_frac`` where payload
    row ``sign_row`` is > 0 and ``neg_frac`` elsewhere;
  * ``MODE_GOSS``: ``imp = |g h|``; a real row with ``imp >= thr`` is a
    top row; the others are kept when the draw at their physical
    position (JAX: ``uniform(key, (Npad,))``) is below ``other_k /
    max(N - n_top, 1)`` in f32, and scaled by ``mult``.  ``thr`` (the
    ``top_k``-th largest ``imp``) and ``n_top`` (the top rows) are device
    words from ``goss_threshold``, which uses ``torch.topk`` as the JAX
    package uses ``lax.top_k``.

Rows 0 and 1 keep their value in the bag and become +0 out of it
(bagging: the JAX package's ``g * mask`` compiles to a select), or are
multiplied by the GOSS scale 1 / ``mult`` / 0, and the count of
sampled rows goes to the device word ``bag`` (1,) int32, which the tree
loop's bookkeeping reads (models/learner.py): no host read of the
count, and one captured graph serves every draw.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from ..utils.random import torch_uniform_at

MODE_BAG, MODE_BALANCED, MODE_GOSS = 0, 1, 2

# launches of the CUDA kernel by this wrapper (the plain version and
# goss_threshold's library calls are not counted)
launches = 0


def goss_threshold(ghi, N: int, top_k: int):
    """(thr (1,) f32, n_top (1,) int32) on the payload's device: the
    ``top_k``-th largest ``|g h|`` over all Npad rows (pad rows count as
    0) and the count of real rows at or above it."""
    imp = (ghi[0] * ghi[1]).abs()
    thr = torch.topk(imp, top_k, sorted=False).values.min().reshape(1)
    real = ghi[2].view(torch.int32) != N
    n_top = ((imp >= thr) & real).sum().to(torch.int32).reshape(1)
    return thr, n_top


def sample_plain(ghi, bag, mode: int, *, N: int, key, frac: float = 1.0,
                 pos_frac: float = 1.0, neg_frac: float = 1.0,
                 sign_row: int = 4, thr=None, n_top=None, other_k: int = 1,
                 mult: float = 1.0) -> None:
    """Plain version of the kernel, in place (see module doc)."""
    f32 = np.float32
    rowid = ghi[2].view(torch.int32).long()
    real = rowid != N
    g, h = ghi[0], ghi[1]
    if mode == MODE_GOSS:
        idx = torch.arange(ghi.shape[1], device=ghi.device)
        u = torch_uniform_at(key, idx)
        top = ((g * h).abs() >= thr) & real
        rest = torch.clamp_min(N - n_top, 1).to(torch.float32)
        prob = torch.tensor(f32(other_k), device=ghi.device) / rest
        keep = ~top & real & (u < prob)
        scale = torch.where(top, 1.0, torch.where(
            keep, torch.tensor(f32(mult), device=ghi.device), 0.0))
        sel = top | keep
    else:
        u = torch_uniform_at(key, torch.where(real, rowid, N))
        if mode == MODE_BAG:
            sel = u < f32(frac)
        else:
            sel = torch.where(ghi[sign_row] > 0, u < f32(pos_frac),
                              u < f32(neg_frac))
        sel = sel & real
        g, h = torch.where(sel, g, 0.0), torch.where(sel, h, 0.0)
    if mode == MODE_GOSS:
        g, h = g * scale, h * scale
    ghi[0] = g
    ghi[1] = h
    bag.copy_(sel.sum().to(torch.int32).reshape(1))


def sample(ghi, bag, mode: int, **kw) -> None:
    """One sampling pass in place (see module doc)."""
    if ghi.device.type == "cpu":
        return sample_plain(ghi, bag, mode, **kw)
    return sample_cuda(ghi, bag, mode, **kw)


def sample_cuda(ghi, bag, mode: int, *, N: int, key, frac: float = 1.0,
                pos_frac: float = 1.0, neg_frac: float = 1.0,
                sign_row: int = 4, thr=None, n_top=None, other_k: int = 1,
                mult: float = 1.0) -> None:
    global launches
    R, Np = ghi.shape
    if mode not in (MODE_BAG, MODE_BALANCED, MODE_GOSS):
        raise ValueError(f"sample: mode {mode}")
    if not (3 <= R and 0 <= N < Np < (1 << 31) and 0 <= sign_row < R):
        raise ValueError(f"sample: payload {tuple(ghi.shape)}, N {N}, "
                         f"sign row {sign_row}")
    kernels.require_cuda(ghi, torch.float32, "payload")
    kernels.require_cuda(bag, torch.int32, "bag count", (1,))
    if mode == MODE_GOSS:
        kernels.require_cuda(thr, torch.float32, "threshold", (1,))
        kernels.require_cuda(n_top, torch.int32, "top count", (1,))
    fn = kernels.load("sample").sample_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_uint] * 2 + [ctypes.c_float] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    bag.zero_()
    none = ctypes.c_void_p(0)
    err = fn(kernels.ptr(ghi), kernels.ptr(bag),
             kernels.ptr(thr) if mode == MODE_GOSS else none,
             kernels.ptr(n_top) if mode == MODE_GOSS else none,
             int(Np), int(N), int(mode), int(sign_row),
             int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF,
             float(frac), float(pos_frac), float(neg_frac), float(mult),
             int(other_k), kernels.stream_ptr(ghi.device))
    kernels.check(err, "sample_launch")
    launches += 1
