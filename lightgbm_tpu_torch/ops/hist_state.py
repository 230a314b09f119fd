"""Kernel 5: the histogram state of the histogram-subtraction split path
and its read-modify-write.

Counterpart of the TPU kernel ``hist_rmw_pallas``
(lightgbm_tpu/ops/hist_state_pallas.py).  The learner keeps one
histogram slot per leaf; per split it reads the parent's slot,
subtracts the freshly built smaller child's histogram, and writes both
children back (the reference's histogram-subtraction trick,
serial_tree_learner.cpp / FeatureHistogram::Subtract).

State layout: (slots, 2, G, Bp), each slot a leaf's (2, G, Bp)
grad/hess planes as ops/histogram.py ``leaf_hist(..., planes=True)``
writes them.  The TPU kernel's lane-flattened (8, WL) slot is a TPU
tiling rule the card does not have.  On the CPU the state is f32 and
holds what the f32 plain versions compute, the JAX package's contract.
On the card it is int64 and holds each leaf's exact fixed-point sums at
the tree's scale (ops/histogram.py: k from the per-tree bound and the
root's row count ``kcnt``): 2^k * max|v| * rows < 2^62 for every leaf,
so no sum or difference overflows, and parent minus smaller child is
exact -- the larger child's slot is bit-identical to a direct
fixed-point histogram of its own rows.

``hist_rmw_plain(state, small, idx)`` with ``idx = (parent, wa, wb,
small_is_left)`` (host ints) reads slot ``parent``, computes ``large =
parent - small`` in the state's dtype, and writes left to slot ``wa``,
then right to slot ``wb``, in place: ``wa == wb`` (a trash slot) ends
holding the right child, as the TPU kernel's serialized copies leave
it.  ``parent < 0`` means no parent (the root): slot ``wa`` gets
``small`` and both children are it.  It returns both children as one
(2, 2, G, Bp) tensor ``(plane, child, G, Bp)``: ``children[:, 0]`` is
the left child's planes and ``children[:, 1]`` the right's, and
``children[0]`` / ``children[1]`` viewed as (2G, Bp) are the pair
search's grad / hess inputs (ops/split_pair.py), the left child's rows
first.

The learner's entry is ``leaf_hist_rmw``: the smaller child's histogram
and the state update in one call.  It dispatches on the device of its
inputs: CPU tensors run ``leaf_hist_plain`` and then ``hist_rmw_plain``
on the f32 state; CUDA tensors launch csrc/leaf_hist.cu's state kernel,
whose last block of each group set subtracts its exact sums from the
parent slot and writes both slots and both f32 children (no launch of
its own for the update), or raise.  ``leaf_hist_rmw_fixed_plain`` is
the card's arithmetic in plain PyTorch, bit for bit.  ``hist_rmw``
alone runs on the CPU only: on the card the update exists only fused
into the histogram launch.

Quantized training (``scale``, the (2,) f32 device word of
ops/quantize.py): the state keeps the integer carriers' sums (exact on
both devices while they stay below 2^24 in f32), and only the children
handed to the search are multiplied by the plane's scale, one f32
product (the scale arm).

``leaf_hist_rmw_step`` is the entry of the learner's tree loop: the rows,
the child's side and the slots come from a step block on the device
(ops/partition.py ``SB_*``), the children go to a preallocated buffer,
and the grid is sized for ``bound`` rows.  A step of no rows writes no
slot and gives zero children (so do the plain versions).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import histogram, kernels
from .partition import S_CNT, scalars_start, step_fields
from .quantize import scale_planes
from .split_mega import hist_geometry

# launches of the CUDA kernel with the state epilogue (each is also a
# leaf_hist launch, counted in ops/histogram.py), a launch recorded into a
# CUDA graph under capture included (a replay is not counted; nor are the
# plain versions)
launches = 0


def new_state(slots: int, num_groups: int, num_bins: int,
              device) -> torch.Tensor:
    """A zeroed (slots, 2, G, Bp) histogram state: f32 on the CPU, int64
    on the card."""
    _, Bp = hist_geometry(num_bins)
    dtype = torch.float32 if torch.device(device).type == "cpu" \
        else torch.int64
    return torch.zeros((slots, 2, num_groups, Bp), dtype=dtype,
                       device=device)


def hist_rmw_plain(state, small, idx: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of the update, in the state's dtype (see
    module doc)."""
    parent, wa, wb, sil = (int(v) for v in idx)
    if parent < 0:
        state[wa] = small
        return torch.stack([small, small], dim=1)
    large = state[parent] - small
    left, right = (small, large) if sil else (large, small)
    children = torch.stack([left, right], dim=1)
    state[wa] = left
    state[wb] = right
    return children


def hist_rmw_fixed_plain(state, small, idx: Sequence[int], inv,
                         scale=None) -> torch.Tensor:
    """The card's update in plain PyTorch: ``hist_rmw_plain`` on the int64
    state and the smaller child's (2, G, Bp) int64 sums, then the
    children (int64 -> double) * 2^-k -> f32, with ``inv`` the (2,) f64
    factors 2^-k of the two planes, times ``scale`` when given."""
    children = hist_rmw_plain(state, small, idx)
    return scale_planes((children.double()
                         * inv[:, None, None, None]).float(), scale, 0)


def hist_rmw(state, small, idx: Sequence[int]) -> torch.Tensor:
    """Update a CPU ``state`` in place; returns the (2, 2, G, Bp)
    children (see module doc).  On the card the update runs only inside
    ``leaf_hist_rmw``."""
    if state.device.type == "cpu":
        return hist_rmw_plain(state, small, idx)
    raise ValueError("hist_rmw: the card's histogram state is updated by "
                     "leaf_hist_rmw (csrc/leaf_hist.cu's state epilogue), "
                     "not by a launch of its own")


def _no_children(num_groups, num_bins, state) -> torch.Tensor:
    _, Bp = hist_geometry(num_bins)
    return torch.zeros((2, 2, num_groups, Bp), dtype=torch.float32,
                       device=state.device)


def leaf_hist_rmw_plain(part_bins, part_ghi, start: int, cnt: int, *,
                        num_bins: int, num_groups: int, state,
                        idx: Sequence[int], child=None,
                        scale=None) -> torch.Tensor:
    """What the CPU runs: the f32 ``leaf_hist_plain`` of the rows, then
    ``hist_rmw_plain`` on the f32 state, the children times ``scale`` when
    given.  A range of no rows (a step that splits nothing) writes no slot
    and gives zero children."""
    if cnt == 0:
        return _no_children(num_groups, num_bins, state)
    small = histogram.leaf_hist_plain(part_bins, part_ghi, start, cnt,
                                      num_bins=num_bins,
                                      num_groups=num_groups, child=child,
                                      planes=True)
    return scale_planes(hist_rmw_plain(state, small, idx), scale, 0)


def leaf_hist_rmw_fixed_plain(part_bins, part_ghi, start: int, cnt: int, *,
                              num_bins: int, num_groups: int, state,
                              idx: Sequence[int], absmax, kcnt: int,
                              child=None, scale=None) -> torch.Tensor:
    """The card's arithmetic in plain PyTorch, bit for bit:
    ``leaf_hist_fixed_sums`` of the rows at the scale of ``absmax`` and
    ``kcnt``, then ``hist_rmw_fixed_plain`` on the int64 state.  A range
    of no rows writes no slot and gives zero children."""
    if cnt == 0:
        return _no_children(num_groups, num_bins, state)
    small, inv = histogram.leaf_hist_fixed_sums(
        part_bins, part_ghi, start, cnt, num_bins=num_bins,
        num_groups=num_groups, child=child, absmax=absmax, kcnt=kcnt)
    return hist_rmw_fixed_plain(state, small, idx, inv, scale)


def leaf_hist_rmw(part_bins, part_ghi, start: int, cnt: int, *,
                  num_bins: int, num_groups: int, state, idx: Sequence[int],
                  absmax, kcnt: int,
                  child: Optional[Tuple[torch.Tensor, int]] = None,
                  scale=None) -> torch.Tensor:
    """The histogram of the rows ``[start, start + cnt)`` (or of the child
    ``child=(nl, side)`` of their partition, as ops/histogram.py
    ``leaf_hist``), folded into ``state`` by ``idx``; returns the
    (2, 2, G, Bp) f32 children (see module doc).  ``absmax`` and
    ``kcnt`` (the tree's bound and root row count) set the card's scale;
    the CPU's f32 plain versions do not use them."""
    kw = dict(num_bins=num_bins, num_groups=num_groups, state=state,
              idx=idx, child=child, scale=scale)
    if part_bins.device.type == "cpu":
        return leaf_hist_rmw_plain(part_bins, part_ghi, start, cnt, **kw)
    return leaf_hist_rmw_cuda(part_bins, part_ghi, start, cnt, absmax=absmax,
                              kcnt=kcnt, **kw)


def leaf_hist_rmw_cuda(part_bins, part_ghi, start, cnt, *, num_bins,
                       num_groups, state, idx, absmax, kcnt,
                       child=None, scale=None) -> torch.Tensor:
    G = num_groups
    _, Bp = hist_geometry(num_bins)
    check_state(state, G, Bp)
    slots = state.shape[0]
    parent, wa, wb, sil = (int(v) for v in idx)
    if not (-1 <= parent < slots and 0 <= wa < slots and 0 <= wb < slots
            and sil in (0, 1)):
        raise ValueError(f"leaf_hist_rmw: idx {tuple(idx)} outside {slots} "
                         f"slots or small_is_left not 0/1")
    if kcnt is None or absmax is None:
        raise ValueError("leaf_hist_rmw: the card's state needs the tree's "
                         "scale: absmax and kcnt")
    children = torch.empty((2, 2, G, Bp), dtype=torch.float32,
                           device=state.device)
    histogram.host_launch(part_bins, part_ghi, start, cnt, num_bins=num_bins,
                          num_groups=G, child=child, absmax=absmax,
                          kcnt=kcnt, out=children, state=state,
                          idx=(parent, wa, wb, sil), scale=scale)
    _count()
    return children


def check_state(state, G: int, Bp: int) -> None:
    if state.dim() != 4 or tuple(state.shape[1:]) != (2, G, Bp):
        raise ValueError(f"leaf_hist_rmw: state must be (slots, 2, {G}, "
                         f"{Bp}), got {tuple(state.shape)}")
    kernels.require_cuda(state, torch.int64, "state")


def _count() -> None:
    global launches
    launches += 1


def leaf_hist_rmw_step(part_bins, part_ghi, step, nl, *, num_bins: int,
                       num_groups: int, state, absmax, kcnt: int, out,
                       bound: int, ws=None, scale=None) -> None:
    """``leaf_hist_rmw`` of the rows the step block ``step`` names (its
    range, or the child SB_SIDE of the partition whose left count is
    ``nl``), folded into ``state`` by its slots (SB_PARENT, SB_WA, SB_WB,
    SB_SIL), the (2, 2, G, Bp) f32 children written to ``out``.  CPU
    tensors run the plain versions (reading the step block is no sync
    there); CUDA tensors launch the state kernel, its grid sized for
    ``bound`` rows.  A step of no rows writes no slot."""
    if part_bins.device.type == "cpu":
        sc, idx, side = step_fields(step)
        child = None if side == 0 else (nl, side - 1)
        out.copy_(leaf_hist_rmw_plain(
            part_bins, part_ghi, scalars_start(sc), sc[S_CNT],
            num_bins=num_bins, num_groups=num_groups, state=state, idx=idx,
            child=child, scale=scale))
        return
    G = num_groups
    _, Bp = hist_geometry(num_bins)
    check_state(state, G, Bp)
    kernels.require_cuda(out, torch.float32, "children", (2, 2, G, Bp))
    histogram.launch(part_bins, part_ghi, step, num_bins=num_bins,
                     num_groups=G, nl=nl, absmax=absmax, kcnt=kcnt, out=out,
                     bound=bound, state=state, ws=ws, scale=scale)
    _count()
