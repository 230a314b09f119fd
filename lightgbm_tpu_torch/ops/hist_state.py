"""Kernel 5: the histogram-state read-modify-write of the
histogram-subtraction split path.

Counterpart of the TPU kernel ``hist_rmw_pallas``
(lightgbm_tpu/ops/hist_state_pallas.py).  The learner keeps one
histogram slot per leaf; per split it reads the parent's slot,
subtracts the freshly built smaller child's histogram, and writes both
children back (the reference's histogram-subtraction trick,
serial_tree_learner.cpp / FeatureHistogram::Subtract).  ``hist_rmw``
dispatches on the device of its inputs: CPU tensors run
``hist_rmw_plain``, CUDA tensors launch the hand-written kernel
``csrc/hist_rmw.cu`` or raise.

State layout: (slots, 2, G, Bp) f32, each slot a leaf's (2, G, Bp)
grad/hess planes as ops/histogram.py ``leaf_hist(..., planes=True)``
writes them.  The TPU kernel's lane-flattened (8, WL) slot is a TPU
tiling rule the card does not have.

``hist_rmw(state, small, idx)`` with ``idx = (parent, wa, wb,
small_is_left)`` (host ints) reads slot ``parent``, computes ``large =
parent - small`` in f32, and writes left to slot ``wa``, then right to
slot ``wb``, in place: ``wa == wb`` (a trash slot) ends holding the
right child, as the TPU kernel's serialized copies leave it.  It
returns both children as one (2, 2, G, Bp) tensor ``(plane, child, G,
Bp)``: ``children[:, 0]`` is the left child's planes and
``children[:, 1]`` the right's, and ``children[0]`` / ``children[1]``
viewed as (2G, Bp) are the pair search's grad / hess inputs
(ops/split_pair.py), the left child's rows first.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import kernels
from .split_mega import hist_geometry

# launches of the CUDA kernel (the plain version is not counted)
launches = 0


def new_state(slots: int, num_groups: int, num_bins: int,
              device) -> torch.Tensor:
    """A zeroed (slots, 2, G, Bp) histogram state."""
    _, Bp = hist_geometry(num_bins)
    return torch.zeros((slots, 2, num_groups, Bp), dtype=torch.float32,
                       device=device)


def hist_rmw_plain(state, small, idx: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract)."""
    parent, wa, wb, sil = (int(v) for v in idx)
    large = state[parent] - small
    left, right = (small, large) if sil else (large, small)
    children = torch.stack([left, right], dim=1)
    state[wa] = left
    state[wb] = right
    return children


def hist_rmw(state, small, idx: Sequence[int]) -> torch.Tensor:
    """Update ``state`` in place; returns the (2, 2, G, Bp) children
    (see module doc)."""
    if state.device.type == "cpu":
        return hist_rmw_plain(state, small, idx)
    return hist_rmw_cuda(state, small, idx)


def hist_rmw_cuda(state, small, idx: Sequence[int]) -> torch.Tensor:
    global launches
    if state.dim() != 4 or state.shape[1] != 2:
        raise ValueError(f"hist_rmw: state must be (slots, 2, G, Bp), got "
                         f"{tuple(state.shape)}")
    slots, _, G, Bp = state.shape
    kernels.require_cuda(state, torch.float32, "state")
    kernels.require_cuda(small, torch.float32, "small", (2, G, Bp))
    parent, wa, wb, sil = (int(v) for v in idx)
    if not (all(0 <= v < slots for v in (parent, wa, wb)) and sil in (0, 1)):
        raise ValueError(f"hist_rmw: idx {tuple(idx)} outside {slots} "
                         f"slots or small_is_left not 0/1")
    children = torch.empty((2, 2, G, Bp), dtype=torch.float32,
                           device=state.device)
    fn = kernels.load("hist_rmw").hist_rmw_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    err = fn(kernels.ptr(state), slots, kernels.ptr(small), G, Bp, parent,
             wa, wb, sil, kernels.ptr(children),
             kernels.stream_ptr(state.device))
    kernels.check(err, "hist_rmw_launch")
    launches += 1
    return children
