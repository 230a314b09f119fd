"""Leaf-wise tree learner of the port: the serial K=1 learner with two
split bodies.

Port of the K=1 path of lightgbm_tpu/models/learner.py
(``SerialTreeLearner._build_tree_impl`` with the Pallas pair search,
``tpu_frontier_k=1``) for all-numerical uint8 data without EFB bundles.

Rows are physically partitioned by leaf, as in the JAX learner: the
(G, N_pad) uint8 bin matrix and the (8, N_pad) f32 payload (grad, hess,
row-id bits, score, objective rows) are reordered together on every
split, so each leaf is one contiguous row range.  The body is chosen at
construction from ``tpu_megakernel``:

  * the mega path (``auto`` / ``pallas``, the default): per split,
    ``ops/split_mega.py:split_mega`` partitions the chosen leaf and,
    from the same decision, builds both children's histograms.  The
    root's histogram is a ``split_mega`` call with an all-left decision
    that moves no rows.
  * the histogram-subtraction path (``off``; JAX learner.py:2282-2344):
    the learner keeps one histogram slot per leaf
    (``ops/hist_state.py``; int64 fixed-point sums at one scale per
    tree on the card).  ``ops/hist_state.py:leaf_hist_rmw`` builds the
    root's histogram over all rows into slot 0.  Per split,
    ``ops/partition.py:partition_leaf`` partitions the leaf, and
    ``leaf_hist_rmw`` builds the smaller child's histogram only -- the
    child with the smaller bag-aware count (``LM_BLCNT <= LM_BRCNT``,
    ties left), its rows read on the device from the partition's left
    count -- derives the larger child as parent minus smaller and
    writes both slots, in one launch on the card.

Both then run ``ops/split_pair.py:split_pair``, which finds both
children's best splits and returns their packed leafmat segments.

The JAX learner runs the whole tree inside one jitted while-loop.  This
port runs an eager Python loop over splits: the packed per-leaf and
per-node matrices (``leafmat`` (NLF, L+1) and ``nodemat`` (NND, nodes+1),
int fields bitcast into f32 with ``_i2f`` / ``_f2i``) live on the host,
and each split costs one device-to-host copy of its 27 result words
(the left count and the two 13-field rows) -- the host sync the
learner counts in ``syncs``.  The root's best split is a
``split_pair`` call on (root, root).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import Config, DEFAULT_ROW_CHUNK, parse_row_chunk
from ..dataset import BinnedDataset
from ..ops.hist_state import leaf_hist_rmw, new_state
from ..ops.partition import (S_CNT, make_scalars, partition_leaf,
                             scalars_start)
from ..ops.split_mega import split_mega, unpack_hist4
from ..ops.split_pair import split_pair

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


def _i2f(x) -> np.float32:
    """int -> the f32 whose bits are that int32 (leafmat/nodemat fields)."""
    return np.asarray(x, np.int32).view(np.float32)


def _f2i(x):
    """f32 field -> the int32 its bits hold."""
    return np.asarray(x, np.float32).view(np.int32)


def _leaf_column(start, cnt, cnt_g, sum_g, sum_h, depth, value, parent,
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


def _pow2ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class SerialTreeLearner:
    """Builds one tree per call on ``device`` (see module doc)."""

    def __init__(self, dataset: BinnedDataset, config: Config, device):
        self.ds = dataset
        self.cfg = config
        self.device = torch.device(device)
        meta = dataset.feature_meta_arrays()
        self.G = max(dataset.num_groups, 1)
        self.B = max(dataset.max_group_bins, 2)
        self.F = len(meta["feature"])
        self.L = config.num_leaves
        self.max_splits = self.L - 1
        self.N = dataset.num_data
        if self.N >= (1 << 24):
            raise NotImplementedError(
                "lightgbm_tpu_torch trains below 2^24 rows (counts ride f32)")
        # per-feature metadata as columns: feature id, group row,
        # bin_start, is_bundled, num_bin, default_bin, missing_type
        F = self.F
        self._fmeta = np.stack([
            meta["feature"], meta["group"], np.zeros(F, np.int32),
            np.zeros(F, np.int32), meta["num_bin"], meta["default_bin"],
            meta["missing_type"]]).astype(np.int32) if F else None
        half = np.zeros((F, 8), np.int32)
        if F:
            half[:, 0] = meta["num_bin"]
            half[:, 1] = meta["missing_type"]
            half[:, 2] = meta["default_bin"]
        self.fmeta_pair = torch.as_tensor(np.concatenate([half, half]),
                                          device=self.device)

        # row geometry (learner.py:387-405): [C front pad][N rows][>= 2C
        # tail pad]; the root range starts at row0 = C
        base = parse_row_chunk(config.tpu_row_chunk) or DEFAULT_ROW_CHUNK
        C = min(base, max(_pow2ceil(self.N), 256))
        C = min(_pow2ceil(C), 1 << 15)
        self.row_chunk = C
        self.row0 = C
        self.N_pad = C + ((self.N + C - 1) // C + 2) * C
        pad = np.zeros((self.G, self.N_pad), np.uint8)
        if dataset.binned is not None and F:
            pad[:, C:C + self.N] = dataset.binned.T
        self.part0 = torch.as_tensor(pad, device=self.device)

        self.l1 = float(config.lambda_l1)
        self.l2 = float(config.lambda_l2)
        self.max_delta_step = float(config.max_delta_step)
        self.min_gain_to_split = float(config.min_gain_to_split)
        self.min_data_in_leaf = int(config.min_data_in_leaf)
        self.min_sum_hessian = float(config.min_sum_hessian_in_leaf)
        self.max_depth = int(config.max_depth)
        self.syncs = 0          # device-to-host round trips, all trees
        # the histogram-subtraction body keeps one histogram slot per leaf
        self.subtract = str(config.tpu_megakernel).strip().lower() == "off"
        self.state = (new_state(self.L, self.G, self.B, self.device)
                      if self.subtract else None)
        self._absmax = None

    # ------------------------------------------------------------------
    def _search(self, hg, hh, info):
        """Both children's best splits: (2, 13) f32 on the device."""
        return split_pair(
            hg, hh, self.fmeta_pair, info, l1=self.l1, l2=self.l2,
            max_delta_step=self.max_delta_step,
            min_gain_to_split=self.min_gain_to_split,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian=self.min_sum_hessian, max_depth=self.max_depth)

    def _info(self, halves):
        """(2F, 8) f32 info block on the device from two (sum_g, sum_h,
        cnt, depth)."""
        F = self.F
        info = np.zeros((2 * F, 8), np.float32)
        for c, (sg, sh, cnt, depth) in enumerate(halves):
            rows = slice(c * F, (c + 1) * F)
            info[rows, 0] = sg
            info[rows, 1] = sh
            info[rows, 2] = np.float32(cnt)
            info[rows, 3] = np.float32(depth)
            info[rows, 4] = 1.0
        return torch.as_tensor(info, device=self.device)

    def _root_hist(self, part_bins, part_ghi):
        """The root's (G, Bp) grad and hess histograms twice, as (2G, Bp):
        the pair search's inputs for (root, root)."""
        G, B = self.G, self.B
        if self.subtract:
            ch = leaf_hist_rmw(part_bins, part_ghi, self.row0, self.N,
                               num_bins=B, num_groups=G, state=self.state,
                               idx=(-1, 0, 0, 0), absmax=self._absmax,
                               kcnt=self.N)
            return ch[0].reshape(2 * G, -1), ch[1].reshape(2 * G, -1)
        # an all-left mega call that moves no rows
        _, acc = split_mega(part_bins, part_ghi,
                            make_scalars(self.row0, self.N, 0, 0, 0, B, 0,
                                         0, 255, 0),
                            num_bins=B, num_groups=G, move=False,
                            absmax=self._absmax)
        hl_g, hl_h, _, _ = unpack_hist4(acc, B)
        return torch.cat([hl_g, hl_g]), torch.cat([hl_h, hl_h])

    def _split(self, part_bins, part_ghi, scalars, leaf: int, new_leaf: int,
               small_is_left: bool):
        """Partition ``leaf`` (its left child keeps the slot, the right
        child takes ``new_leaf``); returns the (1,) left count on the
        device and the children's (2G, Bp) grad and hess histograms, the
        left child's rows first (the pair search masks every bin past a
        feature's num_bin)."""
        G, B = self.G, self.B
        if self.subtract:
            nl = partition_leaf(part_bins, part_ghi, scalars)
            ch = leaf_hist_rmw(part_bins, part_ghi, scalars_start(scalars),
                               scalars[S_CNT], num_bins=B, num_groups=G,
                               child=(nl, 0 if small_is_left else 1),
                               state=self.state,
                               idx=(leaf, leaf, new_leaf,
                                    int(small_is_left)),
                               absmax=self._absmax, kcnt=self.N)
            return nl, ch[0].reshape(2 * G, -1), ch[1].reshape(2 * G, -1)
        nl, acc = split_mega(part_bins, part_ghi, scalars, num_bins=B,
                             num_groups=G, absmax=self._absmax)
        hl_g, hl_h, hr_g, hr_h = unpack_hist4(acc, B)
        return nl, torch.cat([hl_g, hr_g]), torch.cat([hl_h, hr_h])

    def build_tree(self, part_bins: torch.Tensor, part_ghi: torch.Tensor,
                   bag_cnt: int) -> Dict[str, Any]:
        """Grow one tree over the payload in ``part_ghi`` (rows 0/1 hold
        this iteration's grad/hess), partitioning both buffers in place.
        Returns the host record of ``_unpack_state``."""
        L, F = self.L, self.F
        nodes = self.max_splits
        lm = np.zeros((NLF, L + 1), np.float32)
        lm[LM_BGAIN] = NEG_INF
        lm[LM_CMIN] = NEG_INF
        lm[LM_CMAX] = np.inf
        lm.view(np.int32)[[LM_PARENT, LM_FORCED]] = -1
        nm = np.zeros((NND, nodes + 1), np.float32)

        # the card's fixed-point histograms (split_mega, leaf_hist_rmw)
        # are scaled by one bound of |grad| and |hess| per tree, kept on
        # the device (and the histogram state by the root's row count)
        self._absmax = part_ghi[:2].abs().amax(dim=1)
        # root: its histogram, then the best split from a pair search
        # over (root, root)
        hg, hh = self._root_hist(part_bins, part_ghi)
        sum_g = hg[0].sum()
        sum_h = hh[0].sum()
        if F:
            info = self._info([(0, 0, bag_cnt, 0)] * 2)
            info[:, 0] = sum_g
            info[:, 1] = sum_h
            tile = self._search(hg, hh, info)[0]
        else:
            tile = torch.full((13,), NEG_INF, device=self.device)
        host = torch.cat([sum_g.reshape(1), sum_h.reshape(1), tile]).cpu()
        self.syncs += 1
        host = host.numpy()
        lm[:, 0] = _leaf_column(self.row0, self.N, bag_cnt, host[0], host[1],
                                0, 0.0, -1, 0, host[2:15])

        s = 0
        while s < nodes and F:
            bgain = lm[LM_BGAIN, :L]
            best_leaf = int(np.argmax(bgain))
            gain = bgain[best_leaf]
            if not gain > 0:
                break
            pcol = lm[:, best_leaf].copy()
            new_leaf = s + 1
            f_enum = int(_f2i(pcol[LM_BFEAT]))
            thr = int(_f2i(pcol[LM_BTHR]))
            dl = bool(pcol[LM_BDL] > 0.5)
            orig_feat, col, bstart, isb, nb, dbin, mtype = (
                int(v) for v in self._fmeta[:, f_enum])
            start = int(_f2i(pcol[LM_START]))
            cnt = int(_f2i(pcol[LM_CNT]))
            cnt_g = int(_f2i(pcol[LM_CNT_G]))
            left_cnt_g = int(_f2i(pcol[LM_BLCNT]))
            right_cnt_g = int(_f2i(pcol[LM_BRCNT]))
            nl, hg, hh = self._split(
                part_bins, part_ghi,
                make_scalars(start, cnt, col, bstart, isb, nb, dbin, mtype,
                             thr, dl),
                best_leaf, new_leaf, left_cnt_g <= right_cnt_g)
            lsg, lsh = pcol[LM_BLSG], pcol[LM_BLSH]
            rsg, rsh = pcol[LM_BRSG], pcol[LM_BRSH]
            lout, rout = pcol[LM_BLOUT], pcol[LM_BROUT]
            depth_child = int(_f2i(pcol[LM_DEPTH])) + 1

            # record the internal node; fix the parent's child pointer
            ncol = np.zeros(NND, np.float32)
            ncol[[ND_DL, ND_GAIN, ND_IVALUE, ND_IWEIGHT]] = [
                float(dl), gain, pcol[LM_VALUE], pcol[LM_SUM_H]]
            ncol.view(np.int32)[[
                ND_FEATURE, ND_FEATURE_ENUM, ND_THRESHOLD, ND_LEFT, ND_RIGHT,
                ND_ICOUNT, ND_COL, ND_BIN_START, ND_IS_BUNDLED, ND_NUM_BIN,
                ND_DEFAULT_BIN, ND_MISSING]] = [
                orig_feat, f_enum, thr, -(best_leaf + 1), -(new_leaf + 1),
                cnt_g, col, bstart, isb, nb, dbin, mtype]
            nm[:, s] = ncol
            p = int(_f2i(pcol[LM_PARENT]))
            if p >= 0:
                side = int(_f2i(pcol[LM_PSIDE]))
                nm.view(np.int32)[ND_LEFT if side == 0 else ND_RIGHT, p] = s

            tile = self._search(
                hg, hh, self._info([(lsg, lsh, left_cnt_g, depth_child),
                                    (rsg, rsh, right_cnt_g, depth_child)]))
            host = torch.cat([nl.view(torch.float32), tile.reshape(-1)]).cpu()
            self.syncs += 1
            host = host.numpy()
            left_cnt = int(_f2i(host[0]))
            lm[:, best_leaf] = _leaf_column(
                start, left_cnt, left_cnt_g, lsg, lsh, depth_child, lout, s,
                0, host[1:14])
            lm[:, new_leaf] = _leaf_column(
                start + left_cnt, cnt - left_cnt, right_cnt_g, rsg, rsh,
                depth_child, rout, s, 1, host[14:27])
            s += 1
        return self._unpack_state(lm, nm, s)

    def _unpack_state(self, lm, nm, s) -> Dict[str, Any]:
        """The packed matrices as the per-field host record
        (learner.py:_unpack_state)."""
        L, nodes = self.L, self.max_splits
        lm = lm[:, :L]
        nm = nm[:, :nodes]
        li = lambda r: _f2i(lm[r])  # noqa: E731
        ni = lambda r: _f2i(nm[r])  # noqa: E731
        return {
            "s": s,
            "leaf_start": li(LM_START), "leaf_cnt": li(LM_CNT),
            "leaf_cnt_g": li(LM_CNT_G), "leaf_sum_g": lm[LM_SUM_G],
            "leaf_sum_h": lm[LM_SUM_H], "leaf_depth": li(LM_DEPTH),
            "leaf_value": lm[LM_VALUE], "best_gain": lm[LM_BGAIN],
            "node_feature": ni(ND_FEATURE),
            "node_feature_enum": ni(ND_FEATURE_ENUM),
            "node_threshold": ni(ND_THRESHOLD),
            "node_default_left": nm[ND_DL] > 0.5,
            "node_gain": nm[ND_GAIN],
            "node_left": ni(ND_LEFT), "node_right": ni(ND_RIGHT),
            "node_internal_value": nm[ND_IVALUE],
            "node_internal_weight": nm[ND_IWEIGHT],
            "node_internal_count": ni(ND_ICOUNT),
            "node_missing_type": ni(ND_MISSING),
        }
