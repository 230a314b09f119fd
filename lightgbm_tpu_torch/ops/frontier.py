"""Frontier-batched tree growth: the bookkeeping of a step that splits up
to K leaves, the tree-end renumber and undo, and the conditional graph
nodes that skip the steps of a stopped tree.

Port of ``_build_tree_frontier`` and ``_renumber_frontier``
(lightgbm_tpu/models/learner.py, ``tpu_frontier_k`` > 1).  No TPU kernel
corresponds to the bookkeeping: in the JAX package it is XLA code in the
while-loop body.  The port runs it as the hand-written kernels of
``csrc/frontier.cu``; each wrapper here dispatches on the device of its
inputs: CPU tensors run the plain version, CUDA tensors launch the
kernel or raise.  Plain and kernel agree bit for bit: the work is
integer bookkeeping, comparisons and f32 copies.

The oracle-order replay (see the JAX docstring): every potential leaf is
an *item* -- item 0 the root, items ``1 + 2j + side`` the children of
the j-th split made, in the order made -- and the replay pops the K=1
learner's priority queue over the items (``ops/split.py
oracle_next_pick``).  A pop of a split item commits it as the next K=1
split; a pop of an item not split yet stalls the replay, and that item
is the next step's required leaf.  Each step splits the required leaf
and up to K-1 speculative ones (``frontier_topk``), at most
``clip(min(K, needed, s_left - needed + 1, ncand), 1, K)``, so at most
K-1 speculative splits outlive the num_leaves budget.  Split slots:
``MS = (L-1) + (K-1)``; leaf slots ``MS + 1`` (the left child keeps its
parent's slot, the right child of split j takes slot j + 1); items
``NI = 2 MS + 2``.

``frontier_step`` by ``mode``:

  * ``MODE_ROOT``: reset the state to a tree of one leaf, write the root
    search's info rows (child 0 of the pair search) from the root
    histogram's sums, the bag-aware count ``bag`` and the feature mask
    ``fmask`` (both device buffers), and mark the root as due;
  * ``MODE_STEP``: commit what is due -- the root's column from pair row
    0, or each split of the step just run: its two children's leaf
    columns from its left count ``nl[k]`` and pair rows ``k`` and
    ``K + k``, and their items -- advance the replay, then select the
    next step's batch: per leaf k a step record ``steps[k]`` (the single
    leaf step block the split kernels read, ops/partition.py ``SB_*``;
    ``cnt == 0`` for a lane not used), a snapshot of the leaf's column,
    its node column and the info rows of its two children (feature mask
    ``fmask``).  It sets
    ``FS_RUN`` (and, inside a captured graph, the conditional handle of
    the next step) when a batch was selected;
  * ``MODE_FINAL``: renumber into the K=1 learner's numbering -- the
    output ``leafmat`` (NLF, L + 1) and ``nodemat`` (NND, L) bit-identical
    to the K=1 loop's, a pruned leaf's column from its snapshot -- write
    the committed split count into ``steps[0][SB_S]``, and list the
    pruned speculative splits' ranges for the undo (``FS_NPRUNED``, and
    the undo's conditional handle).

Rows keep their place through a pruned split by ``frontier_undo``: a
stable partition keeps both children in their parent's order, so every
leaf range holds its rows in the order of their positions at the start
of the tree.  ``frontier_key`` writes those positions into payload row
``KEY_ROW`` (7; the objectives' rows end at 6), which every partition
moves with its row, and clears it again at the end of the tree.  A
pruned split's children were never split (they never became available),
so its range was permuted by exactly one partition, and merging the two
children by their keys restores the range as the K=1 learner leaves
it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .partition import (ERR_STEP, SB_BSTART, SB_CNT, SB_COL, SB_DBIN, SB_DL,
                        SB_ERR, SB_ISB, SB_LEAF, SB_MADE, SB_MTYPE, SB_NB,
                        SB_NEW, SB_PARENT, SB_S, SB_SIDE, SB_SIL, SB_START,
                        SB_STEPS, SB_THR, SB_VALID, SB_WA, SB_WB, STEP_WORDS,
                        GHI_ROWS, check_bufs, require_uint8,
                        scratch_rows, workspace)
from .split import frontier_topk, oracle_next_pick
from .tree_step import (FMETA_ROWS, LM_BDL, LM_BFEAT, LM_BGAIN, LM_BLCNT,
                        LM_BLOUT, LM_BLSG, LM_BLSH, LM_BRCNT, LM_BROUT,
                        LM_BRSG, LM_BRSH, LM_BTHR, LM_CNT, LM_DEPTH,
                        LM_PARENT, LM_PSIDE, LM_START, ND_LEFT, ND_RIGHT,
                        NLF, NND, empty_leafmat, leaf_column, node_column)

MODE_ROOT, MODE_STEP, MODE_FINAL = 0, 1, 2
PEND_NONE, PEND_ROOT, PEND_SPLIT = 0, 1, 2

# state words (csrc/frontier.cu FS_*), then the arrays of ``layout``
(FS_MADE, FS_M, FS_DONE, FS_UITEM, FS_PEND, FS_KSTEP, FS_RUN, FS_NPRUNED,
 FS_ERR, FS_STEPS) = range(10)
FS_HEAD = 16
ERR_PRUNED = 8      # more pruned splits than K - 1 (csrc/frontier.cu)
BIG_SLOT = 1 << 30

# launches of each CUDA kernel by its wrapper, a launch recorded into a
# CUDA graph under capture included (a replay launches without the
# wrapper and is not counted; nor is the plain version)
launches = {"frontier_step": 0, "frontier_key": 0, "frontier_undo": 0}


def sizes(L: int, K: int):
    """(MS, SL, NI): split slots, leaf slots (one spare), items."""
    MS = (L - 1) + (K - 1)
    return MS, MS + 2, 2 * MS + 2


def layout(L: int, K: int):
    """Offsets of the state arrays in the int32 state words: name ->
    (offset, length), in the order csrc/frontier.cu lays them out."""
    MS, _, NI = sizes(L, K)
    out, off = {}, FS_HEAD
    for name, n in (("it_gain", NI), ("it_slot", NI), ("it_split", NI),
                    ("it_oslot", NI), ("avail", NI), ("sel", K),
                    ("pop_split", L), ("ora_of", MS + 1),
                    ("slot_item", L + 1), ("nl_of", MS + 1),
                    ("undo", 3 * K)):
        out[name] = (off, n)
        off += n
    return out, off


class Frontier:
    """The device buffers of one learner's frontier: the state words
    ``fs``, the working leaf matrix ``lmw`` (NLF, MS + 2), node matrix
    ``nmw`` (NND, MS + 1) and leaf-column snapshots ``snap`` (NLF,
    MS + 1); and, owned by the learner, the K=1-shaped outputs
    ``leafmat`` / ``nodemat``, the K step records ``steps`` (K,
    STEP_WORDS), the left counts ``nl`` (K,), the pair search's rows
    ``pair`` (2K, 13) and info block ``info`` (2KF, 8), the root sums
    ``sums`` (2,), the feature metadata ``fmeta`` (8, F), the bag-aware
    root count ``bag`` (1,) int32 and the tree's feature mask ``fmask``
    (F,) f32."""

    def __init__(self, L, K, leafmat, nodemat, steps, nl, pair, info, sums,
                 fmeta, bag, fmask):
        dev = leafmat.device
        self.L, self.K, self.F = L, K, fmeta.shape[1]
        self.MS, SL, _ = sizes(L, K)
        self.lay, words = layout(L, K)
        self.fs = torch.zeros(words, dtype=torch.int32, device=dev)
        self.lmw = torch.zeros((NLF, SL), dtype=torch.float32, device=dev)
        self.nmw = torch.zeros((NND, self.MS + 1), dtype=torch.float32,
                               device=dev)
        self.snap = torch.zeros((NLF, self.MS + 1), dtype=torch.float32,
                                device=dev)
        self.leafmat, self.nodemat, self.steps = leafmat, nodemat, steps
        self.nl, self.pair, self.info, self.sums = nl, pair, info, sums
        self.fmeta, self.bag, self.fmask = fmeta, bag, fmask

    TENSORS = ("fs", "lmw", "nmw", "snap", "leafmat", "nodemat", "steps",
               "nl", "pair", "info", "sums", "fmeta", "bag", "fmask")

    def to(self, device) -> "Frontier":
        """A copy of every buffer on ``device`` (the kernel's comparison
        with its plain version)."""
        c = object.__new__(Frontier)
        c.__dict__.update(self.__dict__)
        for name in self.TENSORS:
            setattr(c, name, getattr(self, name).detach().to(device,
                                                            copy=True))
        return c

    def arr(self, name):
        """A state array as numpy: a view of CPU buffers, a copy of CUDA
        ones."""
        off, n = self.lay[name]
        return self.fs.cpu().numpy()[off:off + n]


def frontier_step_plain(mode, fr: Frontier, *, row0: int, N: int) -> None:
    """Plain version of the bookkeeping kernel, in place on CPU buffers
    (see module doc)."""
    L, K, F, MS = fr.L, fr.K, fr.F, fr.MS
    bag_cnt, fmask = int(fr.bag[0]), fr.fmask.numpy()
    _, SL, NI = sizes(L, K)
    IT = NI - 1
    fs = fr.fs.numpy()
    lmw, nmw, snap = fr.lmw.numpy(), fr.nmw.numpy(), fr.snap.numpy()
    w = fr.steps.numpy()
    info = fr.info.numpy().reshape(2 * K, F, 8)
    it_gain = fr.arr("it_gain").view(np.float32)
    it_slot, it_split = fr.arr("it_slot"), fr.arr("it_split")
    it_oslot, avail, sel = fr.arr("it_oslot"), fr.arr("avail"), fr.arr("sel")
    pop_split, ora_of = fr.arr("pop_split"), fr.arr("ora_of")
    slot_item, nl_of = fr.arr("slot_item"), fr.arr("nl_of")
    undo = fr.arr("undo").reshape(K, 3)

    if mode == MODE_ROOT:
        fs[:] = 0
        lmw[:] = empty_leafmat(SL - 1)
        nmw[:] = 0.0
        snap[:] = 0.0
        it_gain[:] = -np.inf
        it_oslot[:] = BIG_SLOT
        it_oslot[0] = 0
        avail[0] = 1
        it_split[:] = -1
        pop_split[:] = -1
        ora_of[:] = -1
        slot_item[:] = -1
        slot_item[0] = 0
        s = fr.sums.numpy()
        info[:] = 0.0
        info[0, :, :4] = [s[0], s[1], np.float32(bag_cnt), 0.0]
        info[0, :, 4] = fmask
        w[:] = 0
        fs[FS_PEND] = PEND_ROOT
        return

    if mode == MODE_FINAL:
        _renumber_plain(fr, fs, lmw, nmw, snap, w, undo)
        return

    # ---- commit what is due ------------------------------------------
    p = fr.pair.numpy()
    nl = fr.nl.numpy()
    if fs[FS_PEND] == PEND_ROOT:
        s = fr.sums.numpy()
        lmw[:, 0] = leaf_column(row0, N, bag_cnt, s[0], s[1], 0, 0.0, -1, 0,
                                p[0])
        it_gain[0] = p[0, 0]
        fs[FS_DONE] = int(not p[0, 0] > 0)
    elif fs[FS_PEND] == PEND_SPLIT:
        made = int(fs[FS_MADE])
        for k in range(int(fs[FS_KSTEP])):
            j, item = made + k, int(sel[k])
            slot = int(it_slot[item])
            pc = snap[:, j]
            pci = pc.view(np.int32)
            start, cnt = int(pci[LM_START]), int(pci[LM_CNT])
            depth, left = int(pci[LM_DEPTH]) + 1, int(nl[k])
            lmw[:, slot] = leaf_column(start, left, pci[LM_BLCNT],
                                       pc[LM_BLSG], pc[LM_BLSH], depth,
                                       pc[LM_BLOUT], j, 0, p[k])
            lmw[:, j + 1] = leaf_column(start + left, cnt - left,
                                        pci[LM_BRCNT], pc[LM_BRSG],
                                        pc[LM_BRSH], depth, pc[LM_BROUT], j,
                                        1, p[K + k])
            it_gain[1 + 2 * j] = p[k, 0]
            it_gain[2 + 2 * j] = p[K + k, 0]
            it_slot[1 + 2 * j] = slot
            it_slot[2 + 2 * j] = j + 1
            it_split[item] = j
            nl_of[j] = left
        fs[FS_MADE] = made + int(fs[FS_KSTEP])
        _replay_plain(fs, L, it_gain, it_split, it_oslot, avail, slot_item,
                      pop_split, ora_of)
    fs[FS_PEND] = PEND_NONE
    fs[FS_KSTEP] = 0
    fs[FS_RUN] = 0
    w[:, SB_CNT] = 0
    w[:, SB_VALID] = 0

    # ---- select the next step's batch ----------------------------------
    made, m = int(fs[FS_MADE]), int(fs[FS_M])
    if fs[FS_DONE] or made >= MS:
        return
    g = torch.from_numpy(it_gain)
    cand = (avail > 0) & (it_split < 0) & (it_gain > 0)
    scores = torch.where(torch.from_numpy(cand), g, float("-inf"))
    items, ok = frontier_topk(scores, int(fs[FS_UITEM]), K)
    needed, s_left = (L - 1) - m, MS - made
    k_step = min(K, needed, s_left - needed + 1, int(ok.sum()))
    k_step = max(1, min(k_step, K))
    sel[:] = items.numpy()
    slots = [int(it_slot[int(items[k])]) for k in range(k_step)]
    feats = [int(lmw[LM_BFEAT, slot:slot + 1].view(np.int32)[0])
             for slot in slots]
    if not all(0 <= fe < F for fe in feats) or IT in sel[:k_step]:
        fs[FS_ERR] |= ERR_STEP
        fs[FS_DONE] = 1
        return
    fmv = fr.fmeta.numpy()
    for k, (slot, fe) in enumerate(zip(slots, feats)):
        j = made + k
        pc = lmw[:, slot].copy()
        pci = pc.view(np.int32)
        snap[:, j] = pc
        fm = fmv[:, fe]
        nmw[:, j] = node_column(pc, pc[LM_BGAIN], fm, slot, j + 1)
        lcg, rcg = int(pci[LM_BLCNT]), int(pci[LM_BRCNT])
        depth = int(pci[LM_DEPTH]) + 1
        info[k, :, :4] = [pc[LM_BLSG], pc[LM_BLSH], np.float32(lcg),
                          np.float32(depth)]
        info[K + k, :, :4] = [pc[LM_BRSG], pc[LM_BRSH], np.float32(rcg),
                              np.float32(depth)]
        info[[k, K + k], :, 4] = fmask
        sil = int(lcg <= rcg)
        r = w[k]
        r[SB_START] = pci[LM_START]
        r[SB_CNT] = pci[LM_CNT]
        r[[SB_COL, SB_BSTART, SB_ISB, SB_NB, SB_DBIN, SB_MTYPE]] = fm[1:7]
        r[SB_THR] = pci[LM_BTHR]
        r[SB_DL] = int(pc[LM_BDL] > 0.5)
        r[[SB_PARENT, SB_WA, SB_WB, SB_SIL]] = [slot, slot, j + 1, sil]
        r[SB_SIDE] = 1 if sil else 2
        r[SB_VALID] = 1
        r[SB_S] = j + 1
        r[SB_LEAF] = slot
        r[SB_NEW] = j + 1
    fs[FS_KSTEP] = k_step
    fs[FS_PEND] = PEND_SPLIT
    fs[FS_RUN] = 1
    fs[FS_STEPS] += 1


def _replay_plain(fs, L, it_gain, it_split, it_oslot, avail, slot_item,
                  pop_split, ora_of) -> None:
    """Pop the oracle's queue until it stalls on an item not split yet
    (the next required leaf), the budget is spent or no gain is > 0
    (JAX ``sim_body``)."""
    g = torch.from_numpy(it_gain)
    while True:
        it, gmax = oracle_next_pick(g, torch.from_numpy(it_oslot),
                                    torch.from_numpy(avail > 0))
        it, gmax = int(it), float(gmax)
        m = int(fs[FS_M])
        budget_done = m >= L - 1
        dead = not gmax > 0
        j2 = int(it_split[it])
        if not budget_done and not dead and j2 < 0:
            fs[FS_UITEM] = it
        if budget_done or dead:
            fs[FS_DONE] = 1
        if budget_done or dead or j2 < 0:
            return
        cl, cr, po = 1 + 2 * j2, 2 + 2 * j2, int(it_oslot[it])
        avail[it] = 0
        avail[cl] = 1
        avail[cr] = 1
        it_oslot[cl] = po
        it_oslot[cr] = m + 1
        slot_item[po] = cl
        slot_item[m + 1] = cr
        pop_split[m] = j2
        ora_of[j2] = m
        fs[FS_M] = m + 1


def _renumber_plain(fr, fs, lmw, nmw, snap, w, undo) -> None:
    """MODE_FINAL: the K=1 numbering (JAX ``_renumber_frontier``) and the
    pruned ranges."""
    L, K, MS = fr.L, fr.K, fr.MS
    nodes = L - 1
    m, made = int(fs[FS_M]), int(fs[FS_MADE])
    it_slot, it_split = fr.arr("it_slot"), fr.arr("it_split")
    it_oslot, ora_of = fr.arr("it_oslot"), fr.arr("ora_of")
    slot_item, pop_split = fr.arr("slot_item"), fr.arr("pop_split")
    nl_of = fr.arr("nl_of")
    lm = fr.leafmat.numpy()
    nm = fr.nodemat.numpy()
    lm[:] = empty_leafmat(L)
    nm[:] = 0.0
    lmi = lm.view(np.int32)
    for leaf in range(min(m, L - 1) + 1):
        item = int(slot_item[leaf])
        if item < 0:
            continue
        jw = int(it_split[item])
        lm[:, leaf] = snap[:, jw] if jw >= 0 else lmw[:, int(it_slot[item])]
        if item > 0:
            lmi[LM_PARENT, leaf] = ora_of[(item - 1) // 2]
            lmi[LM_PSIDE, leaf] = (item - 1) % 2
        else:
            lmi[LM_PARENT, leaf] = -1
            lmi[LM_PSIDE, leaf] = 0
    nmi = nm.view(np.int32)
    for i in range(min(m, nodes)):
        j = int(pop_split[i])
        nm[:, i] = nmw[:, j]
        for row, c in ((ND_LEFT, 1 + 2 * j), (ND_RIGHT, 2 + 2 * j)):
            jc = int(it_split[c])
            o = int(ora_of[jc]) if jc >= 0 else -1
            nmi[row, i] = o if o >= 0 else -(int(it_oslot[c]) + 1)
    undo[:] = 0
    n = 0
    for j in range(made):
        if ora_of[j] >= 0:
            continue
        if n >= K - 1:
            fs[FS_ERR] |= ERR_PRUNED
            break
        si = snap[:, j].view(np.int32)
        undo[n] = [si[LM_START], si[LM_CNT], nl_of[j]]
        n += 1
    fs[FS_NPRUNED] = n
    if fs[FS_PEND] != PEND_NONE:
        fs[FS_ERR] |= ERR_STEP
    w[0, SB_S] = m
    w[0, SB_MADE] = made
    w[0, SB_STEPS] = fs[FS_STEPS]
    w[0, SB_ERR] |= fs[FS_ERR]


def frontier_step(mode, fr: Frontier, *, row0: int, N: int,
                  handles=(0, 0)) -> None:
    """One bookkeeping step in place (see module doc).  ``handles``: up to
    two conditional handles that the kernel sets to ``FS_RUN``
    (MODE_STEP) or to ``FS_NPRUNED > 0`` (MODE_FINAL), those nonzero --
    inside a captured graph."""
    kw = dict(row0=row0, N=N)
    if fr.fs.device.type == "cpu":
        return frontier_step_plain(mode, fr, **kw)
    if mode not in (MODE_ROOT, MODE_STEP, MODE_FINAL):
        raise ValueError(f"frontier_step: mode {mode}")
    L, K, F = fr.L, fr.K, fr.F
    _, SL, _ = sizes(L, K)
    for name, dtype, shape in (
            ("fs", torch.int32, (fr.fs.numel(),)),
            ("lmw", torch.float32, (NLF, SL)),
            ("nmw", torch.float32, (NND, fr.MS + 1)),
            ("snap", torch.float32, (NLF, fr.MS + 1)),
            ("leafmat", torch.float32, (NLF, L + 1)),
            ("nodemat", torch.float32, (NND, L)),
            ("steps", torch.int32, (K, STEP_WORDS)),
            ("nl", torch.int32, (K,)),
            ("pair", torch.float32, (2 * K, 13)),
            ("info", torch.float32, (2 * K * F, 8)),
            ("sums", torch.float32, (2,)),
            ("fmeta", torch.int32, (FMETA_ROWS, F)),
            ("bag", torch.int32, (1,)),
            ("fmask", torch.float32, (F,))):
        kernels.require_cuda(getattr(fr, name), dtype, name, shape)
    fn = kernels.load("frontier").frontier_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
        ctypes.c_ulonglong] * 2 + [ctypes.c_void_p]
    h1, h2 = handles
    err = fn(*(kernels.ptr(getattr(fr, n)) for n in Frontier.TENSORS),
             L, K, F, int(row0), int(N), int(mode),
             ctypes.c_ulonglong(h1), ctypes.c_ulonglong(h2),
             kernels.stream_ptr(fr.fs.device))
    kernels.check(err, "frontier_step_launch")
    launches["frontier_step"] += 1


# -- the row order: tree-start positions and the undo ------------------------
KEY_ROW = 7     # the payload row that carries a row's tree-start position


def frontier_key_plain(part_ghi, *, row0: int, N: int, clear: bool) -> None:
    """Payload row KEY_ROW over the root range [row0, row0 + N): each
    row's position in the range (as int32 bits), or zeros (``clear``)."""
    words = part_ghi.view(torch.int32)
    words[KEY_ROW, row0:row0 + N] = (0 if clear else torch.arange(
        N, dtype=torch.int32, device=part_ghi.device))


def frontier_key(part_ghi, *, row0: int, N: int, clear: bool = False) -> None:
    """Write (or clear) the rows' tree-start positions into payload row
    KEY_ROW, which the partition moves with every row (see
    frontier_key_plain)."""
    if part_ghi.device.type == "cpu":
        return frontier_key_plain(part_ghi, row0=row0, N=N, clear=clear)
    kernels.require_cuda(part_ghi, torch.float32, "part_ghi")
    if part_ghi.shape[0] != GHI_ROWS or not (
            0 <= row0 and 0 <= N and row0 + N <= part_ghi.shape[1]):
        raise ValueError("frontier_key: root range outside the payload")
    fn = kernels.load("frontier").frontier_key_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    err = fn(kernels.ptr(part_ghi), part_ghi.shape[1], int(row0), int(N),
             int(bool(clear)), kernels.stream_ptr(part_ghi.device))
    kernels.check(err, "frontier_key_launch")
    launches["frontier_key"] += 1


def frontier_undo_plain(part_bins, part_ghi, fr: Frontier) -> None:
    """Restore each pruned range listed by MODE_FINAL to the order of its
    rows' tree-start positions (payload row KEY_ROW), in place (every row
    of the range moves with all its bin and payload words)."""
    undo = fr.arr("undo").reshape(fr.K, 3)
    words = part_ghi.view(torch.int32)
    for start, cnt, _ in undo[:int(fr.fs[FS_NPRUNED].item())].tolist():
        s, e = start, start + cnt
        order = torch.argsort(words[KEY_ROW, s:e])
        part_bins[:, s:e] = part_bins[:, s:e][:, order]
        words[:, s:e] = words[:, s:e][:, order]


def frontier_undo(part_bins, part_ghi, fr: Frontier, *, bound: int,
                  ws=None) -> None:
    """The undo of the pruned ranges (see frontier_undo_plain), for ranges
    of up to ``bound`` rows together: the plain version for CPU tensors,
    csrc/frontier.cu for CUDA tensors (a merge of each range's two
    children by position into the workspace's right-side scratch, then
    back).  uint8 bins only (the frontier runs on the mega path): a
    uint16 tensor raises."""
    require_uint8(part_bins, "frontier_undo")
    if part_bins.device.type == "cpu":
        return frontier_undo_plain(part_bins, part_ghi, fr)
    check_bufs(part_bins, part_ghi, "frontier_undo")
    kernels.require_cuda(fr.fs, torch.int32, "fs")
    R, Np = part_bins.shape
    if not 0 <= bound <= min(Np, (1 << 24) - 1):
        raise ValueError(f"frontier_undo: bound {bound}")
    ws = ws or workspace(part_bins.device)
    scap = scratch_rows(bound)
    sbins = ws.buffer("sbins", R * scap, torch.uint8)
    sghi = ws.buffer("sghi", GHI_ROWS * scap, torch.int32)
    off, _ = fr.lay["undo"]
    fn = kernels.load("frontier").frontier_undo_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    err = fn(kernels.ptr(part_bins), R, Np, kernels.ptr(part_ghi),
             kernels.ptr(fr.fs), off, fr.K, bound, kernels.ptr(sbins),
             kernels.ptr(sghi), scap, kernels.stream_ptr(part_bins.device))
    kernels.check(err, "frontier_undo_launch")
    launches["frontier_undo"] += 1


# -- conditional graph nodes -------------------------------------------------
def cond_handles(n: int, device) -> list:
    """``n`` conditional handles on the graph being captured on the current
    stream, each reset to 0 at every launch of the graph."""
    fn = kernels.load("frontier").cond_handle_create
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    out = []
    for _ in range(n):
        h = ctypes.c_ulonglong(0)
        kernels.check(fn(kernels.stream_ptr(device), ctypes.byref(h)),
                      "cond_handle_create")
        out.append(h.value)
    return out


class IfNode:
    """``with IfNode(handle, body_stream):`` captures the block's launches
    into the body of a conditional IF node of the graph being captured on
    the current stream; the body runs at a launch of the graph when a
    kernel before it has set ``handle`` to a nonzero value."""

    def __init__(self, handle: int, body: "torch.cuda.Stream"):
        self.handle, self.body = handle, body

    def __enter__(self):
        lib = kernels.load("frontier")
        fn = lib.cond_if_begin
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong]
        dev = self.body.device
        kernels.check(fn(kernels.stream_ptr(dev),
                         ctypes.c_void_p(self.body.cuda_stream),
                         ctypes.c_ulonglong(self.handle)), "cond_if_begin")
        self._ctx = torch.cuda.stream(self.body)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        fn = kernels.load("frontier").cond_if_end
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
        kernels.check(fn(ctypes.c_void_p(self.body.cuda_stream)),
                      "cond_if_end")
        return False


def stopped_step_ms(step, device, n: int = 64, reps: int = 10) -> float:
    """Device ms of a step whose IF node is not taken: ``step()``, which
    launches one step's kernels, captured under each of ``n`` IF nodes
    whose handles no kernel sets, in one graph replayed ``reps`` times.
    Nothing in the bodies runs, so any buffers the step was sized for
    will do."""
    # body and capture streams taken together, so that they differ (see
    # models/learner.py: the pooled streams come round)
    body, capture = torch.cuda.Stream(device), torch.cuda.Stream(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture):
        for h in cond_handles(n, device):
            with IfNode(h, body):
                step()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * n)
