"""The tree loop's bookkeeping step: what the learner did on the host
between two splits, as one small launch on the device.

No TPU kernel corresponds to it: in the JAX package these are XLA
operations inside the while-loop body of ``_build_tree_impl``
(lightgbm_tpu/models/learner.py).  The port runs them as the
hand-written kernel ``csrc/tree_step.cu`` so that a captured CUDA graph
grows a whole tree (models/learner.py).  ``tree_step`` dispatches on the
device of its inputs: CPU tensors run ``tree_step_plain``, CUDA tensors
launch the kernel or raise.  The two agree bit for bit: the step is
integer bookkeeping, comparisons and f32 copies.

The packed per-leaf and per-node matrices: ``leafmat`` (NLF, L + 1) and
``nodemat`` (NND, nodes + 1) f32, int fields bitcast into f32
(``_i2f`` / ``_f2i``); the step block is ops/partition.py's ``SB_*``.
One call, by ``mode``:

  * ``MODE_ROOT``: reset both matrices to an empty tree, write the root
    search's (2F, 8) info block from the root histogram's sums ``sums``
    (2,), the bag-aware count ``bag`` (1,) int32 and the feature mask
    ``fmask`` (F,) f32, and mark the root's column as due;
  * ``MODE_STEP``: commit what is due -- the root's column from the root
    search's row, or the two children of the split just made from the
    partition's left count ``nl`` and the pair search's (2, 13) rows
    ``pair`` -- then elect the next split: the first index of the largest
    ``LM_BGAIN`` over the L leaves (a NaN counts as the largest, as
    ``np.argmax`` takes it), made when ``s < nodes``, the gain is > 0 (a
    NaN gain is not) and the tree has not stopped.  It writes node column
    ``s``, the parent's child pointer, the children's info block (their
    sums, counts and depth, and ``fmask`` as the feature mask) and the
    step block of the split (range, decision from ``fmeta`` (7, F),
    histogram-state slots, ``small_is_left`` by the bag-aware counts,
    ties left, and the side to histogram); a split not made sets
    ``cnt = 0`` and stops the tree, so every later step writes nothing;
  * ``MODE_FINAL``: commit what is due.

Every call also takes the category sets as bitsets of bins
(JAX learner.py ``best_cat_set`` / ``node_cat_set``): ``leafcat``
(L + 1, W), ``nodecat`` (nodes + 1, W) and ``paircat`` (2, W) int32, W
the learner's set width (ops/partition.py ``cat_words``: 8 up to 256
bins; the step block is SB_CAT + W words).  The
root's reset zeroes the first two; a commit copies each child's set from
``paircat`` (ops/split_cat.py) into its leaf's row beside its leafmat
column; an election copies the leaf's set into the node's row, writes
``ND_IS_CAT`` from ``LM_BISCAT`` and puts the flag and the set into the
step block (``SB_ISCAT``, ``SB_CAT``) for the partition's decision.  On
numerical data the pair search writes ``LM_BISCAT`` = 0 and ``paircat``
stays zero, so all of these are zeros.

Monotone constraints (fmeta row 7, each feature's direction; zeros
without them): the children's output bounds follow the reference's
BasicLeafConstraints (JAX learner.py, the basic bounds of a split): the
parent's ``[LM_CMIN, LM_CMAX]``, and for a numerical split on a monotone
feature the mid ``(LM_BLOUT + LM_BROUT) / 2`` of the two outputs as the
bound on the side the direction says.  The election writes them into
the children's info rows (``IN_CMIN``, ``IN_CMAX``: ops/split_pair.py),
the commit into their leafmat columns; the root's are -inf and +inf.
Without a monotone feature every bound stays -inf / +inf.  ``boxes``
(intermediate constraints; JAX ``leaf_lo`` / ``leaf_hi``): (2, L + 1, F)
int32, each leaf's lowest and highest bin per feature.  The root's reset
writes row 0 (every bin), a commit the two children's (JAX
``_child_boxes``): the parent's box, the left child's upper end and the
right child's lower end cut at the threshold along a numerical split's
feature, unless the missing / default bin falls on the far side of the
child it goes to.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .partition import (CAT_WORDS, ERR_STEP, SB_CAT, SB_CNT, SB_COL,
                        SB_DBIN, SB_DL, SB_DONE, SB_ERR, SB_ISCAT, SB_LEAF,
                        SB_MTYPE, SB_NB, SB_NEW, SB_PARENT, SB_PEND, SB_S,
                        SB_SIDE, SB_SIL, SB_START, SB_THR, SB_VALID, SB_WA,
                        SB_WB, SB_BSTART, SB_ISB, step_len)

NEG_INF = float("-inf")

(LM_START, LM_CNT, LM_CNT_G, LM_SUM_G, LM_SUM_H, LM_DEPTH, LM_CMIN, LM_CMAX,
 LM_VALUE, LM_PARENT, LM_PSIDE, LM_BGAIN, LM_BFEAT, LM_BTHR, LM_BDL,
 LM_BLCNT, LM_BRCNT, LM_BLSG, LM_BLSH, LM_BRSG, LM_BRSH, LM_BLOUT,
 LM_BROUT, LM_BISCAT, LM_FORCED) = range(25)
NLF = 25

(ND_FEATURE, ND_FEATURE_ENUM, ND_THRESHOLD, ND_DL, ND_GAIN, ND_LEFT,
 ND_RIGHT, ND_IVALUE, ND_IWEIGHT, ND_ICOUNT, ND_COL, ND_BIN_START,
 ND_IS_BUNDLED, ND_NUM_BIN, ND_DEFAULT_BIN, ND_MISSING, ND_IS_CAT) = range(17)
NND = 17

FMETA_ROWS = 8      # feature, group, bin_start, is_bundled, num_bin,
#                     default_bin, missing_type, monotone direction
MODE_ROOT, MODE_STEP, MODE_FINAL = 0, 1, 2
# intermediate monotone constraints refresh every leaf between a split's
# commit and the next election: the commit is a final step's launch (it
# commits what is due and leaves nothing due), the election a step's
# launch that finds nothing due
MODE_COMMIT, MODE_ELECT = MODE_FINAL, MODE_STEP

# launches of the CUDA kernel by this wrapper, a launch recorded into a
# CUDA graph under capture included (a replay launches without the
# wrapper and is not counted; nor is the plain version)
launches = 0


def _i2f(x) -> np.float32:
    """int -> the f32 whose bits are that int32 (leafmat/nodemat fields)."""
    return np.asarray(x, np.int32).view(np.float32)


def _f2i(x):
    """f32 field -> the int32 its bits hold."""
    return np.asarray(x, np.float32).view(np.int32)


def leaf_column(start, cnt, cnt_g, sum_g, sum_h, depth, value, parent,
                side, seg13) -> np.ndarray:
    """One leafmat column: the leaf's own fields, then the 13-field best
    split segment [LM_BGAIN..LM_BISCAT] exactly as the search wrote it
    (f32 copies keep the bitcast int fields bit for bit)."""
    col = np.zeros(NLF, np.float32)
    col[[LM_SUM_G, LM_SUM_H, LM_CMIN, LM_CMAX, LM_VALUE]] = [
        sum_g, sum_h, NEG_INF, np.inf, value]
    col.view(np.int32)[[LM_START, LM_CNT, LM_CNT_G, LM_DEPTH, LM_PARENT,
                        LM_PSIDE, LM_FORCED]] = [
        start, cnt, cnt_g, depth, parent, side, -1]
    col[LM_BGAIN:LM_BISCAT + 1] = seg13
    return col


def empty_leafmat(L: int) -> np.ndarray:
    """The (NLF, L + 1) leafmat of a tree with no leaves yet."""
    lm = np.zeros((NLF, L + 1), np.float32)
    lm[LM_BGAIN] = NEG_INF
    lm[LM_CMIN] = NEG_INF
    lm[LM_CMAX] = np.inf
    lm.view(np.int32)[[LM_PARENT, LM_FORCED]] = -1
    return lm


def node_column(pcol, gain, fmeta_col, best_leaf, new_leaf) -> np.ndarray:
    """The internal node's nodemat column for splitting the leaf whose
    leafmat column is ``pcol`` on its best split, ``fmeta_col`` the split
    feature's (feature, group, bin_start, is_bundled, num_bin,
    default_bin, missing_type)."""
    f_enum = int(_f2i(pcol[LM_BFEAT]))
    thr = int(_f2i(pcol[LM_BTHR]))
    dl = bool(pcol[LM_BDL] > 0.5)
    orig_feat, col, bstart, isb, nb, dbin, mtype = (int(v) for v in
                                                    fmeta_col[:7])
    ncol = np.zeros(NND, np.float32)
    ncol[[ND_DL, ND_GAIN, ND_IVALUE, ND_IWEIGHT]] = [
        float(dl), gain, pcol[LM_VALUE], pcol[LM_SUM_H]]
    ncol.view(np.int32)[[
        ND_FEATURE, ND_FEATURE_ENUM, ND_THRESHOLD, ND_LEFT, ND_RIGHT,
        ND_ICOUNT, ND_COL, ND_BIN_START, ND_IS_BUNDLED, ND_NUM_BIN,
        ND_DEFAULT_BIN, ND_MISSING]] = [
        orig_feat, f_enum, thr, -(best_leaf + 1), -(new_leaf + 1),
        int(_f2i(pcol[LM_CNT_G])), col, bstart, isb, nb, dbin, mtype]
    return ncol


def info_block(F: int, halves, fmask=None) -> np.ndarray:
    """(2F, 8) f32 info block of the pair search from two (sum_g, sum_h,
    cnt, depth[, cmin, cmax]): each child's rows carry its sums, count,
    depth, the feature mask ``fmask`` (F,) (default all 1) and its output
    bounds (default -inf, +inf)."""
    info = np.zeros((2 * F, 8), np.float32)
    for c, half in enumerate(halves):
        sg, sh, cnt, depth = half[:4]
        cmin, cmax = half[4:] if len(half) > 4 else (-np.inf, np.inf)
        rows = slice(c * F, (c + 1) * F)
        info[rows, 0] = sg
        info[rows, 1] = sh
        info[rows, 2] = np.float32(cnt)
        info[rows, 3] = np.float32(depth)
        info[rows, 4] = 1.0 if fmask is None else fmask
        info[rows, 5] = cmin
        info[rows, 6] = cmax
    return info


def child_bounds(pcol, mono: int):
    """The (left cmin, left cmax, right cmin, right cmax) f32 bounds of
    the children of the split in leafmat column ``pcol`` on a feature of
    direction ``mono`` (see module doc)."""
    pmin, pmax = pcol[LM_CMIN], pcol[LM_CMAX]
    mid = (pcol[LM_BLOUT] + pcol[LM_BROUT]) * np.float32(0.5)
    num = not pcol[LM_BISCAT] > 0.5
    return (np.fmax(pmin, mid) if num and mono < 0 else pmin,
            np.fmin(pmax, mid) if num and mono > 0 else pmax,
            np.fmax(pmin, mid) if num and mono > 0 else pmin,
            np.fmin(pmax, mid) if num and mono < 0 else pmax)


def child_boxes(boxes, leaf: int, new: int, pcol, fm) -> None:
    """The two children's boxes of the split in leafmat column ``pcol`` of
    ``leaf`` into rows ``leaf`` and ``new`` of ``boxes`` (2, L + 1, F),
    ``fm`` the split feature's fmeta column (see module doc)."""
    pci = pcol.view(np.int32)
    fe, thr = int(pci[LM_BFEAT]), int(pci[LM_BTHR])
    dl, iscat = bool(pcol[LM_BDL] > 0.5), bool(pcol[LM_BISCAT] > 0.5)
    nb, dbin, mtype = int(fm[4]), int(fm[5]), int(fm[6])
    d_eff = nb - 1 if mtype == 2 else dbin
    miss_l = mtype != 0 and dl and d_eff > thr
    miss_r = mtype != 0 and not dl and d_eff <= thr
    lo, hi = boxes[0, leaf].copy(), boxes[1, leaf].copy()
    l_hi, r_lo = hi.copy(), lo.copy()
    if not iscat:
        if not miss_l:
            l_hi[fe] = min(hi[fe], thr)
        if not miss_r:
            r_lo[fe] = max(lo[fe], thr + 1)
    boxes[0, leaf], boxes[1, leaf] = lo, l_hi
    boxes[0, new], boxes[1, new] = r_lo, hi


def tree_step_plain(mode, lm, nm, step, nl, pair, fmeta, info, sums, bag,
                    fmask, leafcat, nodecat, paircat, *, row0: int,
                    N: int, boxes=None) -> None:
    """Plain version of the kernel, in place on CPU tensors (see module
    doc)."""
    L, nodes, F = lm.shape[1] - 1, nm.shape[1] - 1, fmeta.shape[1]
    bx = None if boxes is None else boxes.numpy()
    fmn = fmeta.numpy()
    lc, nc, pc = leafcat.numpy(), nodecat.numpy(), paircat.numpy()
    bag_cnt, fm_np = int(bag[0]), fmask.numpy()
    lmf, nmf = lm.numpy(), nm.numpy()
    nmi = nmf.view(np.int32)
    w = step.numpy()
    inf = info.numpy()
    if mode == MODE_ROOT:
        lmf[:] = empty_leafmat(L)
        nmf[:] = 0.0
        s = sums.numpy()
        inf[:] = info_block(F, [(0, 0, bag_cnt, 0)] * 2, fm_np)
        inf[:, 0] = s[0]
        inf[:, 1] = s[1]
        w[:] = 0
        w[SB_PEND] = 1
        lc[:] = 0
        nc[:] = 0
        if bx is not None:
            bx[0, 0] = 0
            bx[1, 0] = fmn[4] - 1
        return
    p = pair.numpy()
    if w[SB_PEND] == 1:
        s = sums.numpy()
        lmf[:, 0] = leaf_column(row0, N, bag_cnt, s[0], s[1], 0, 0.0, -1, 0,
                                p[0])
        lc[0] = pc[0]
    elif w[SB_PEND] == 2:
        leaf, new, node = int(w[SB_LEAF]), int(w[SB_NEW]), int(w[SB_S]) - 1
        pcol = lmf[:, leaf].copy()
        pci = pcol.view(np.int32)
        left = int(nl[0])
        start, cnt = int(pci[LM_START]), int(pci[LM_CNT])
        depth = int(pci[LM_DEPTH]) + 1
        lmf[:, leaf] = leaf_column(start, left, pci[LM_BLCNT], pcol[LM_BLSG],
                                   pcol[LM_BLSH], depth, pcol[LM_BLOUT],
                                   node, 0, p[0])
        lmf[:, new] = leaf_column(start + left, cnt - left, pci[LM_BRCNT],
                                  pcol[LM_BRSG], pcol[LM_BRSH], depth,
                                  pcol[LM_BROUT], node, 1, p[1])
        fm = fmn[:, int(pci[LM_BFEAT])]
        b = child_bounds(pcol, int(fm[7]))
        lmf[[LM_CMIN, LM_CMAX], leaf] = b[:2]
        lmf[[LM_CMIN, LM_CMAX], new] = b[2:]
        if bx is not None:
            child_boxes(bx, leaf, new, pcol, fm)
        lc[leaf] = pc[0]
        lc[new] = pc[1]
    if mode == MODE_FINAL:
        w[SB_PEND] = 0
        return

    bgain = lmf[LM_BGAIN, :L]
    best = int(np.argmax(bgain))
    gain = bgain[best]
    s = int(w[SB_S])
    valid = s < nodes and gain > 0 and not w[SB_DONE] and F > 0
    if valid:
        pcol = lmf[:, best].copy()
        pci = pcol.view(np.int32)
        fe, parent = int(pci[LM_BFEAT]), int(pci[LM_PARENT])
        if not 0 <= fe < F or parent >= nodes:
            w[SB_ERR] |= ERR_STEP
            valid = False
    if not valid:
        w[SB_CNT] = 0
        w[SB_VALID] = 0
        w[SB_DONE] = 1
        w[SB_PEND] = 0
        return
    new = s + 1
    fm = fmn[:, fe]
    nmf[:, s] = node_column(pcol, gain, fm, best, new)
    iscat = int(pcol[LM_BISCAT] > 0.5)
    nmf[ND_IS_CAT, s] = iscat
    nc[s] = lc[best]
    w[SB_ISCAT] = iscat
    w[SB_CAT:] = lc[best]
    if parent >= 0:
        nmi[ND_LEFT if int(pci[LM_PSIDE]) == 0 else ND_RIGHT, parent] = s
    lcg, rcg = int(pci[LM_BLCNT]), int(pci[LM_BRCNT])
    depth = int(pci[LM_DEPTH]) + 1
    b = child_bounds(pcol, int(fm[7]))
    inf[:] = info_block(F, [(pcol[LM_BLSG], pcol[LM_BLSH], lcg, depth) + b[:2],
                            (pcol[LM_BRSG], pcol[LM_BRSH], rcg, depth) + b[2:]],
                        fm_np)
    sil = int(lcg <= rcg)
    w[SB_START] = pci[LM_START]
    w[SB_CNT] = pci[LM_CNT]
    w[[SB_COL, SB_BSTART, SB_ISB, SB_NB, SB_DBIN, SB_MTYPE]] = fm[1:7]
    w[SB_THR] = pci[LM_BTHR]
    w[SB_DL] = int(pcol[LM_BDL] > 0.5)
    w[[SB_PARENT, SB_WA, SB_WB, SB_SIL]] = [best, best, new, sil]
    w[SB_SIDE] = 1 if sil else 2
    w[SB_VALID] = 1
    w[SB_S] = new
    w[SB_LEAF] = best
    w[SB_NEW] = new
    w[SB_PEND] = 2


def tree_step(mode, lm, nm, step, nl, pair, fmeta, info, sums, bag, fmask,
              leafcat, nodecat, paircat, *, row0: int, N: int,
              boxes=None) -> None:
    """One bookkeeping step in place (see module doc); ``boxes`` the
    leaves' bin boxes of intermediate monotone constraints, or None."""
    args = (mode, lm, nm, step, nl, pair, fmeta, info, sums, bag, fmask,
            leafcat, nodecat, paircat)
    if lm.device.type == "cpu":
        return tree_step_plain(*args, row0=row0, N=N, boxes=boxes)
    return tree_step_cuda(*args, row0=row0, N=N, boxes=boxes)


def tree_step_cuda(mode, lm, nm, step, nl, pair, fmeta, info, sums, bag,
                   fmask, leafcat, nodecat, paircat, *, row0, N,
                   boxes=None) -> None:
    global launches
    L, nodes, F = lm.shape[1] - 1, nm.shape[1] - 1, fmeta.shape[1]
    W = paircat.shape[-1]
    if (mode not in (MODE_ROOT, MODE_STEP, MODE_FINAL) or nodes != L - 1
            or W < CAT_WORDS):
        raise ValueError(f"tree_step: mode {mode}, {L} leaves, {nodes} "
                         f"nodes and sets of {W} words")
    for t, dtype, name, shape in (
            (lm, torch.float32, "leafmat", (NLF, L + 1)),
            (nm, torch.float32, "nodemat", (NND, nodes + 1)),
            (step, torch.int32, "step block", (step_len(W),)),
            (nl, torch.int32, "left count", (1,)),
            (pair, torch.float32, "pair rows", (2, 13)),
            (fmeta, torch.int32, "fmeta", (FMETA_ROWS, F)),
            (info, torch.float32, "info", (2 * F, 8)),
            (sums, torch.float32, "sums", (2,)),
            (bag, torch.int32, "bag count", (1,)),
            (fmask, torch.float32, "feature mask", (F,)),
            (leafcat, torch.int32, "leafcat", (L + 1, W)),
            (nodecat, torch.int32, "nodecat", (nodes + 1, W)),
            (paircat, torch.int32, "paircat", (2, W))):
        kernels.require_cuda(t, dtype, name, shape)
    if boxes is not None:
        kernels.require_cuda(boxes, torch.int32, "boxes", (2, L + 1, F))
    fn = kernels.load("tree_step").tree_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    err = fn(*(kernels.ptr(t) for t in (lm, nm, step, nl, pair, fmeta, info,
                                        sums, bag, fmask, leafcat, nodecat,
                                        paircat)),
             None if boxes is None else kernels.ptr(boxes),
             L, nodes, F, int(row0), int(N), int(mode), W,
             kernels.stream_ptr(lm.device))
    kernels.check(err, "tree_step_launch")
    launches += 1
