"""Leaf renewal of the L1-family objectives (regression_l1, quantile, mape).

Port of ``_renew_leaves_percentile`` (lightgbm_tpu/models/boosting.py),
the device form of the reference's RenewTreeOutput with PercentileFun /
WeightedPercentileFun (regression_objective.hpp:18-88): after a tree,
each leaf's value becomes the (weighted) ``alpha``-percentile of
``label - score`` over the leaf's in-bag rows.

A leaf's rows are one contiguous physical range of the payload (its
leafmat ``LM_START`` and ``LM_CNT``), so one stable sort of an int64 key
-- the leaf's column in the high word, the residual's order-preserving
bits in the low word, out-of-bag rows above every residual -- lays each
leaf's in-bag residuals out in ascending order; the percentile then
reads one or two elements a leaf.  Plain PyTorch on the scores' device
with no host read: the JAX package runs it as XLA ops, not as a Pallas
kernel.  Unweighted, the arithmetic is the JAX function's f32 and the
result bit-identical on the card and on the CPU; weighted, the
cumulative weights are float64, as in ``_weighted_percentile_host``
(JAX keeps an f32 running sum over all rows).
"""

from __future__ import annotations

from typing import Optional

import torch

_OUT_OF_BAG = (1 << 32) - 1


def order_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) that order as the f32 values ``x`` do
    (-0.0 taken as +0.0)."""
    b = (x + 0.0).view(torch.int32).long()
    return torch.where(b >= 0, b + (1 << 31), -b - 1)


def renew_leaves(starts: torch.Tensor, cnts: torch.Tensor,
                 old: torch.Tensor, resid: torch.Tensor, sel: torch.Tensor,
                 weight: Optional[torch.Tensor], alpha: float
                 ) -> torch.Tensor:
    """The renewed (L,) f32 leaf values.

    ``starts`` / ``cnts``: each leaf column's first row and row count
    relative to ``resid`` (columns of no leaf have count 0); ``resid``,
    ``sel`` (in bag) and ``weight`` (None: unweighted): (N,) in the
    physical order the leaves tile.  A leaf with no in-bag row keeps its
    ``old`` value."""
    dev, N = resid.device, resid.numel()
    L = cnts.numel()
    cnts = cnts.long()
    col = torch.arange(L, device=dev)
    order = torch.argsort(starts.long(), stable=True)
    leaf_at = torch.repeat_interleave(col[order], cnts[order], output_size=N)
    key = torch.where(sel, order_bits(resid), _OUT_OF_BAG)
    _, idx = torch.sort((leaf_at << 32) | key, stable=True)
    r_s = resid[idx]
    off = torch.cumsum(cnts, 0) - cnts
    selc = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(sel.long(), 0)])
    s0 = starts.long().clamp(0, N)
    nb = selc[(s0 + cnts).clamp(0, N)] - selc[s0]
    last = off + torch.clamp_min(nb - 1, 0)
    top = N - 1

    def at(t, i):
        return t[i.clamp(0, top)]

    if weight is None:
        fp = (nb - 1).to(torch.float32) * alpha
        lo = torch.floor(fp)
        bias = fp - lo
        lo = lo.long()
        v1 = at(r_s, torch.minimum(off + torch.clamp_min(lo, 0), last))
        v2 = at(r_s, torch.minimum(off + torch.clamp_min(lo + 1, 0), last))
        v = torch.where(nb == 1, at(r_s, off), v1 + (v2 - v1) * bias)
    else:
        f64 = torch.float64
        w_s = torch.where(sel, weight, 0.0)[idx].to(f64)
        wc = torch.cumsum(w_s, 0)
        base = torch.where(off > 0, at(wc, off - 1), 0.0)
        sw = torch.where(nb > 0, at(wc, last) - base, 0.0)
        thr = alpha * sw
        leaf_s = leaf_at[idx]
        iota = torch.arange(N, device=dev)
        cum = wc - base[leaf_s]
        cond = (cum > thr[leaf_s]) & (iota - off[leaf_s] < nb[leaf_s])
        big = N + 1
        first = torch.full((L,), big, dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, leaf_s, torch.where(cond, iota, big),
                                     "amin")
        pos = torch.minimum(torch.maximum(
            torch.where(first < big, first, last), off), last)
        v2 = at(r_s, pos).to(f64)
        v1 = at(r_s, torch.maximum(pos - 1, off)).to(f64)
        w_next = at(w_s, torch.minimum(pos + 1, last))
        cdf_pos = at(wc, pos) - base
        interp = ((thr - cdf_pos) / torch.clamp_min(w_next, 1e-30)
                  * (v2 - v1) + v1)
        lpos = pos - off
        use = (lpos > 0) & (lpos < nb - 1) & (w_next >= 1.0)
        v = torch.where(use, interp, v2).to(torch.float32)
    return torch.where(nb > 0, v, old)
