"""Linear leaves (``linear_tree``): the leaf fits of ``linear_tree_mode``
refit and the linear score update, in plain PyTorch on the scores'
device, in f64.

Port of the JAX package's host numpy (lightgbm_tpu/models/boosting.py
``_fit_linear_leaves``, ``_linear_tree_deltas``; models/tree.py
``_linear_output``; reference: LinearTreeLearner::CalculateLinear,
linear_tree_learner.cpp:173).  Nothing here is a kernel of the TPU
package: the JAX package solves on the host and updates in numpy.

A tree's linear leaves travel as ``LinearLeaves``: per leaf the shrunk
constant, up to D shrunk coefficients over original feature ids (the
``active`` ones; the rest are 0), the shrunk constant leaf value that a
row with a NaN among its leaf's active features takes instead, and the
fit's outcome ``status``.

The fit (``fit_leaves``) works on a finished tree without reading it
back: each leaf's features are those on its path (``path_features``:
root first, each once, categorical splits skipped; JAX's stack order),
its rows are its physical range of the learner's payload, their raw
values gathered by the row ids of payload row 2.  Rows with a NaN among
the leaf's path features are dropped, then every column that is
constant over the rows left; a leaf keeps its constant value when no
column is left or it has fewer rows than columns + 1.  The normal
equations ``Xa' diag(h) Xa`` (Xa the columns and a ones column) get
``linear_lambda`` on the columns' diagonal, then ``_RIDGE_EPS * (1 +
diag)`` on the whole diagonal; ``-solve(XTHX, Xa' g)`` gives the
coefficients, the intercept last, unless the solve meets an exactly
singular matrix (``torch.linalg.solve_ex``'s ``info``; LAPACK's gesv
raises there in the JAX package) or a coefficient is not finite.  A
coefficient of magnitude at most 1e-35 is dropped.

The train rows' raw values are gathered whole into the physical order
once a tree (``physical_rows``), and the sums run over fixed-size tiles
of them: a leaf's range covers a run of tiles, each (leaf, tile) piece
takes its leaf's columns of the tile's rows and is one small batched
matrix product over the rows of its leaf, and the pieces add into their
leaf, in one pass (a constant column's products are dropped after).  A
tree has at most ``tiles + leaves`` pieces, so every shape is fixed by
N, the leaves and D and nothing is read back: the columns are padded to
D, the widest path the tree can have (the features, capped by the
depth), and a padded or dropped column is an identity row of the
system.  The train rows' linear outputs run over the same pieces
(``tile_output``); a validation set's and a prediction's over rows and
their leaves (``linear_output``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.tree_step import (LM_CNT, LM_PARENT, LM_START, ND_FEATURE,
                             ND_IS_CAT, ND_LEFT, ND_RIGHT)

# JAX boosting.py: the relative ridge on the normal equations' diagonal
_RIDGE_EPS = 1e-10
K_ZERO_THRESHOLD = 1e-35
# a leaf's fit: linear, or why it kept its constant value
(LIN_OK, LIN_NO_FEATURES, LIN_FEW_ROWS, LIN_SINGULAR,
 LIN_NOT_FINITE) = range(5)
# rows of a tile, and the (pieces x rows x columns) values a chunk of
# pieces gathers at once
TILE_ROWS = 1024
_CHUNK_VALUES = 1 << 26


class LinearLeaves(NamedTuple):
    """A tree's linear leaves on the device (see module doc)."""
    const: torch.Tensor      # (L,) f64
    coeff: torch.Tensor      # (L, D) f64
    feat: torch.Tensor       # (L, D) int64, original feature ids
    active: torch.Tensor     # (L, D) bool
    value: torch.Tensor      # (L,) f64, the NaN rows' value
    # (L,) int32: the fit's (None for a host tree's leaves)
    status: Optional[torch.Tensor] = None


def width(num_features: int, num_leaves: int, max_depth: int) -> int:
    """D: the most distinct features a leaf's path can hold."""
    depth = num_leaves - 1 if max_depth <= 0 else min(max_depth,
                                                      num_leaves - 1)
    return max(1, min(num_features, depth))


def path_features(leafmat, nodemat, s, num_features: int, D: int):
    """Each leaf's path features from the learner's tree matrices on the
    device: (L, D) int64 original ids, root first, each once, categorical
    splits skipped (JAX ``_fit_linear_leaves``' stack order), and the
    (L, D) bool of the columns that hold one.  ``s`` is the tree's
    (1,) int32 count of splits on the device; nothing is read back."""
    dev = leafmat.device
    L = leafmat.shape[1] - 1
    nodes = nodemat.shape[1] - 1
    ni = nodemat[:, :nodes].view(torch.int32)
    made = torch.arange(nodes, device=dev) < s.reshape(1).long()
    # each node's parent (a node is made after its parent)
    parent = torch.full((nodes + 1,), nodes, dtype=torch.int64, device=dev)
    src = torch.arange(nodes, device=dev)
    for row in (ND_LEFT, ND_RIGHT):
        child = ni[row].long()
        parent.scatter_(0, torch.where(made & (child >= 0), child, nodes),
                        src)
    parent = parent[:nodes]
    # ancestors or self, closed by squaring: up to 2^k steps after k
    anc = torch.eye(nodes, device=dev)
    anc.index_put_((src, parent.clamp(max=nodes - 1)),
                   (parent < nodes).to(torch.float32), accumulate=True)
    for _ in range(max(1, int(np.ceil(np.log2(max(nodes, 2)))))):
        anc = ((anc @ anc) > 0).to(torch.float32)
    anc = anc > 0
    depth = anc.sum(1) - 1
    lp = leafmat[LM_PARENT, :L].view(torch.int32).long()
    on_path = anc[lp.clamp(min=0)] & (lp >= 0)[:, None]       # (L, nodes)
    feat = ni[ND_FEATURE].long()
    num = made & (nodemat[ND_IS_CAT, :nodes] <= 0.5)
    big = nodes + 1
    mind = torch.full((L, num_features + 1), big, dtype=torch.int64,
                      device=dev)
    idx = torch.where(on_path & num, feat, num_features)
    mind.scatter_reduce_(1, idx, depth.expand(L, nodes), "amin")
    d_sorted, order = torch.sort(mind[:, :num_features], dim=1, stable=True)
    if order.shape[1] < D:
        pad = D - order.shape[1]
        order = torch.nn.functional.pad(order, (0, pad))
        d_sorted = torch.nn.functional.pad(d_sorted, (0, pad), value=big)
    ok = d_sorted[:, :D] < big
    return torch.where(ok, order[:, :D], 0), ok


def _pieces(start, cnt, N: int, R: int):
    """The (leaf, tile) pieces of leaves' row ranges: (P,) leaf (L for a
    padding piece) and (P,) tile, P = tiles + L."""
    dev = start.device
    L = start.shape[0]
    T = max(1, -(-N // R))
    end = start + cnt
    npc = torch.where(cnt > 0, (end - 1) // R - start // R + 1, 0)
    P = T + L
    reps = torch.cat([npc, (P - npc.sum()).reshape(1)])
    leaf = torch.repeat_interleave(torch.arange(L + 1, device=dev), reps,
                                   output_size=P)
    first = torch.cat([start // R, torch.zeros(1, dtype=start.dtype,
                                               device=dev)])
    off = torch.cumsum(reps, 0) - reps
    tile = torch.where(leaf < L, first[leaf] + torch.arange(P, device=dev)
                       - off[leaf], 0)
    return leaf, tile


def physical_rows(raw, rowid, tile: int = TILE_ROWS) -> torch.Tensor:
    """The raw rows of the physical order, whole rows gathered once a
    tree: (T tile, F) f32, T * tile the N rows rounded up (pad rows
    zero)."""
    N = rowid.shape[0]
    T = max(1, -(-N // tile))
    out = raw.new_zeros((T * tile, raw.shape[1]))
    out[:N] = raw[rowid]
    return out


def _piece_rows(rawp, pleaf, ptile, feat_ext, a, b, R):
    """Pieces ``a:b``'s leaves, rows (p, R) and raw values of their
    leaves' columns (p, R, D): a tile's whole rows, then each piece's
    columns."""
    lf = pleaf[a:b]
    tiles = rawp.view(-1, R, rawp.shape[1])[ptile[a:b]]
    cols = feat_ext[lf][:, None, :].expand(-1, R, -1)
    rows = ptile[a:b, None] * R + torch.arange(R, device=rawp.device)
    return lf, rows, torch.gather(tiles, 2, cols)


def fit_leaves(rawp, start, cnt, g, h, feat, ok, value, *,
               lam: float, shrinkage: float,
               tile: int = TILE_ROWS) -> LinearLeaves:
    """The refit of every leaf of a tree (see module doc), on the device.

    ``rawp`` the raw rows in the physical order (``physical_rows``);
    ``start`` / ``cnt`` (L,) int64 each leaf's physical range; ``g`` /
    ``h`` (N,) the true gradients in the physical order; ``feat`` /
    ``ok`` the path features (``path_features``); ``value`` (L,) f32 the
    leaves' constant values, unshrunk.  One pass over the pieces sums
    every path column's products; a constant column's row and column
    are dropped after (no other entry depends on them)."""
    dev = rawp.device
    f64 = torch.float64
    N = g.shape[0]
    L, D = feat.shape
    D1 = D + 1
    R = tile
    pleaf, ptile = _pieces(start, cnt, N, R)
    P = pleaf.shape[0]
    s_ext = torch.cat([start, start.new_zeros(1)])
    e_ext = torch.cat([start + cnt, start.new_zeros(1)])
    feat_ext = torch.cat([feat, feat.new_zeros((1, D))])
    ok_ext = torch.cat([ok, ok.new_zeros((1, D))])
    g = torch.nn.functional.pad(g, (0, rawp.shape[0] - N))
    h = torch.nn.functional.pad(h, (0, rawp.shape[0] - N))
    inf = torch.full((), float("inf"), device=dev)
    # per leaf: the rows its fit sees, each column's range over them, and
    # the normal equations' sums, a piece at a time into its leaf
    seen = torch.zeros(L + 1, dtype=torch.int64, device=dev)
    cmin = torch.full((L + 1, D), float("inf"), device=dev)
    cmax = torch.full((L + 1, D), float("-inf"), device=dev)
    A = torch.zeros((L + 1, D1, D1), dtype=f64, device=dev)
    rhs = torch.zeros((L + 1, D1), dtype=f64, device=dev)
    chunk = max(1, _CHUNK_VALUES // (R * D1))
    for a in range(0, P, chunk):
        b = min(P, a + chunk)
        lf, rows, x = _piece_rows(rawp, pleaf, ptile, feat_ext, a, b, R)
        oc = ok_ext[lf][:, None, :]
        m = ((rows >= s_ext[lf, None]) & (rows < e_ext[lf, None])
             & ~(torch.isnan(x) & oc).any(2))
        keep = m[..., None] & oc
        seen.index_add_(0, lf, m.sum(1))
        idx = lf[:, None].expand(-1, D)
        cmin.scatter_reduce_(0, idx, torch.where(keep, x, inf).amin(1),
                             "amin")
        cmax.scatter_reduce_(0, idx, torch.where(keep, x, -inf).amax(1),
                             "amax")
        xa = torch.cat([torch.where(keep, x.to(f64), 0.0),
                        m[..., None].to(f64)], dim=2)          # (p, R, D1)
        hw = torch.where(m, h[rows].to(f64), 0.0)
        gw = torch.where(m, g[rows].to(f64), 0.0)
        A.index_add_(0, lf, torch.bmm((xa * hw[..., None]).transpose(1, 2),
                                      xa))
        rhs.index_add_(0, lf, torch.bmm(xa.transpose(1, 2),
                                        gw[..., None])[..., 0])
    varying = ok & (cmax[:L] - cmin[:L] > 0)
    A, rhs = A[:L], rhs[:L]
    d = varying.sum(1)
    col = torch.cat([varying, torch.ones((L, 1), dtype=torch.bool,
                                         device=dev)], dim=1)
    A = torch.where(col[:, :, None] & col[:, None, :], A, 0.0)
    diag = A.diagonal(dim1=1, dim2=2)
    dg = diag + torch.cat([varying.to(f64) * lam,
                           torch.zeros((L, 1), dtype=f64, device=dev)], 1)
    dg = dg + _RIDGE_EPS * (1.0 + dg)
    diag.copy_(torch.where(col, dg, 1.0))
    rhs = torch.where(col, rhs, 0.0)
    sol, info = torch.linalg.solve_ex(A, rhs[..., None])
    coef = -sol[..., 0]                                          # (L, D1)
    finite = torch.where(col, torch.isfinite(coef), True).all(1)
    few = seen[:L] < d + 1
    status = torch.where(
        (cnt == 0) | ~ok.any(1) | (d == 0),
        LIN_NO_FEATURES, torch.where(
            few, LIN_FEW_ROWS, torch.where(
                info != 0, LIN_SINGULAR, torch.where(
                    ~finite, LIN_NOT_FINITE, LIN_OK)))).to(torch.int32)
    lin = status == LIN_OK
    active = lin[:, None] & varying & (coef[:, :D].abs() > K_ZERO_THRESHOLD)
    vshr = value.to(f64) * shrinkage
    return LinearLeaves(
        const=torch.where(lin, coef[:, D] * shrinkage, vshr),
        coeff=torch.where(active, coef[:, :D] * shrinkage, 0.0),
        feat=feat, active=active, value=vshr, status=status)


def linear_output(raw, leaf, lin: LinearLeaves, rows=None,
                  chunk: int = 1 << 22) -> torch.Tensor:
    """(n,) f64 each row's linear leaf output (JAX tree.py
    ``_linear_output``): its leaf's constant plus the coefficients times
    the row's raw values of the leaf's features, or the leaf's constant
    value where one of those is NaN.  Row i is ``raw[rows[i]]``
    (``raw[i]`` without ``rows``), in leaf ``leaf[i]``."""
    n = leaf.shape[0]
    out = torch.empty(n, dtype=torch.float64, device=raw.device)
    for a in range(0, n, chunk):
        lf = leaf[a:a + chunk]
        r = (torch.arange(a, a + lf.shape[0], device=raw.device)
             if rows is None else rows[a:a + chunk])
        act = lin.active[lf]
        x = raw[r[:, None], lin.feat[lf]].to(torch.float64)
        nan = (torch.isnan(x) & act).any(1)
        v = lin.const[lf] + (torch.where(act, x, 0.0)
                             * lin.coeff[lf]).sum(1)
        out[a:a + lf.shape[0]] = torch.where(nan, lin.value[lf], v)
    return out


def tile_output(rawp, start, cnt, lin: LinearLeaves, N: int,
                tile: int = TILE_ROWS) -> torch.Tensor:
    """(N,) f64 ``linear_output`` of the N physical rows of a tree's
    leaves (``start`` / ``cnt``; ``rawp`` from ``physical_rows``), over
    the same (leaf, tile) pieces as the fit: a tile's whole rows, each
    piece's columns, the rows of its leaf kept."""
    dev = rawp.device
    f64 = torch.float64
    R = tile
    D = lin.feat.shape[1]
    pleaf, ptile = _pieces(start, cnt, N, R)
    P = pleaf.shape[0]

    def ext(t, fill=0):
        return torch.cat([t, t.new_full((1,) + tuple(t.shape[1:]), fill)])
    s_ext, e_ext = ext(start), ext(start + cnt)
    feat_ext, act_ext = ext(lin.feat), ext(lin.active)
    coeff_ext, const_ext, value_ext = (ext(lin.coeff), ext(lin.const),
                                       ext(lin.value))
    out = torch.zeros(rawp.shape[0], dtype=f64, device=dev)
    chunk = max(1, _CHUNK_VALUES // (R * (D + 1)))
    for a in range(0, P, chunk):
        b = min(P, a + chunk)
        lf, rows, x = _piece_rows(rawp, pleaf, ptile, feat_ext, a, b, R)
        act = act_ext[lf][:, None, :]
        nan = (torch.isnan(x) & act).any(2)
        v = const_ext[lf][:, None] + (torch.where(act, x.to(f64), 0.0)
                                      * coeff_ext[lf][:, None, :]).sum(2)
        v = torch.where(nan, value_ext[lf][:, None], v)
        m = (rows >= s_ext[lf, None]) & (rows < e_ext[lf, None])
        out.index_add_(0, rows.reshape(-1),
                       torch.where(m, v, 0.0).reshape(-1))
    return out[:N]


def from_tree(tree, device, adjust: float = 0.0) -> LinearLeaves:
    """A host linear tree's leaves on ``device``, ``adjust`` taken off
    each constant and constant value (a first tree's folded init
    score)."""
    L = tree.num_leaves
    D = max(1, max((len(c) for c in tree.leaf_coeff[:L]), default=1))
    coeff = np.zeros((L, D))
    feat = np.zeros((L, D), np.int64)
    active = np.zeros((L, D), bool)
    for i in range(L):
        k = len(tree.leaf_coeff[i])
        coeff[i, :k] = tree.leaf_coeff[i]
        feat[i, :k] = tree.leaf_features[i]
        active[i, :k] = True
    value = np.asarray(tree.leaf_value[:L], np.float64)

    def t(a):
        return torch.as_tensor(a, device=device)

    return LinearLeaves(
        const=t(np.asarray(tree.leaf_const[:L], np.float64) - adjust),
        coeff=t(coeff), feat=t(feat), active=t(active),
        value=t(value - adjust))


def leaf_ranges(leafmat, row0: int, N: int):
    """(L,) int64 starts (relative to ``row0``) and counts of the
    learner's leaves, from leafmat on the device."""
    L = leafmat.shape[1] - 1
    lm = leafmat[:, :L]
    start = (lm[LM_START].view(torch.int32).long() - row0).clamp(0, N)
    return start, lm[LM_CNT].view(torch.int32).long()


def from_leafwise(const, coeff, feat, value, shrinkage: float
                  ) -> LinearLeaves:
    """The leaves of a ``leafwise_gain`` tree from its search's (L,)
    f32 rows (JAX boosting.py ``_set_leafwise_linear``): each leaf's own
    best single-feature model, shrunk, or its constant value where the
    slope's magnitude is at most 1e-35."""
    f64 = torch.float64
    c = coeff.to(f64)
    active = (c.abs() > K_ZERO_THRESHOLD)[:, None]
    vshr = value.to(f64) * shrinkage
    return LinearLeaves(
        const=torch.where(active[:, 0], const.to(f64) * shrinkage, vshr),
        coeff=torch.where(active, c[:, None] * shrinkage, 0.0),
        feat=feat.long()[:, None], active=active, value=vshr,
        status=torch.where(active[:, 0], LIN_OK,
                           LIN_NO_FEATURES).to(torch.int32))


def pack(lin: LinearLeaves) -> torch.Tensor:
    """(L, 2 + 2D) f64 for the host read: constant, status, the D
    coefficients, the D feature ids (-1 where inactive)."""
    return torch.cat([lin.const[:, None],
                      lin.status[:, None].to(torch.float64),
                      lin.coeff, torch.where(lin.active, lin.feat, -1)
                      .to(torch.float64)], dim=1)


def unpack(tree, packed: np.ndarray) -> np.ndarray:
    """Write ``pack``'s host copy into host ``tree``'s linear leaves (in
    the order of the columns); returns the fits' (L,) status."""
    L = tree.num_leaves
    D = (packed.shape[1] - 2) // 2
    rows = packed[:L]
    tree.is_linear = True
    tree.leaf_const = rows[:, 0].astype(np.float64)
    for i in range(L):
        f = rows[i, 2 + D:]
        act = f >= 0
        tree.leaf_features[i] = f[act].astype(np.int64).tolist()
        tree.leaf_coeff[i] = rows[i, 2:2 + D][act].tolist()
    return rows[:, 1].astype(np.int32)
