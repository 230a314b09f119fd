"""Leaf-wise tree learner of the port: the serial learner with two split
bodies, one leaf a step or, on the mega path, up to K (the frontier).

Port of lightgbm_tpu/models/learner.py (``SerialTreeLearner``: the K=1
path ``_build_tree_impl`` with the Pallas pair search, and the
frontier-batched path ``_build_tree_frontier`` / ``_renumber_frontier``
of ``tpu_frontier_k`` > 1) for uint8 and uint16 data.

With EFB bundles (dataset.py) the histograms are per group and the pair
search reads one row a feature: as in the JAX package, which then runs
neither its mega kernel nor its Pallas pair search, bundled data takes
the histogram-subtraction body at K=1 whatever ``tpu_megakernel`` and
``tpu_frontier_k`` say, and ``ops/feat_view.py`` turns each split's
children into their per-feature view (a bundled feature's default bin
rebuilt from the leaf's total) between the state update and the pair
search.

Categorical features (JAX ``find_best_split_categorical``) take the
same body as bundles, the histogram-subtraction path at K=1, as the JAX
package's general search does.  Their rows carry FM_IS_CAT in the pair
search's metadata, so ``split_pair`` scans only the numerical features,
and ``ops/split_cat.py`` then searches the categorical ones and merges
its best into each child's row by JAX's argmax rule, writing the child's
category set (W words of bins, ``cat_words``: 8 up to 256 bins) beside
it.  The bookkeeping carries the sets: ``leafcat`` (L+1, W) per leaf,
``nodecat`` (nodes+1, W) per node, and the elected split's set in the
step block (SB_CAT + W words), where the partition reads it
(ops/partition.py ``decide_left``).

Wide bins (JAX dataset.py ``_bin_dtype``): once a group has more than
256 bins -- ``max_bin`` or ``max_bin_by_feature`` past 255, or a
categorical of more than 256 levels -- the whole (G, N_pad) matrix is
uint16, ``B`` the widest group's bins and the histograms (G, Bp) at that
width.  As in the JAX package, whose mega kernel needs uint8 and
B <= 256, such data takes the histogram-subtraction body at K=1; every
kernel of that body (partition, leaf_hist with its state, feat_view,
split_pair, split_cat, tree_step) has its uint16 or wide arm.

Row and feature sampling reach the tree through two device buffers the
bookkeeping kernels read at the root and at every child: ``bag``, the
root's bag-aware row count (the sampling pass of ops/sample.py writes
it; N without sampling), and ``fmask``, the tree's (F,) feature mask
(``set_feature_mask``), written into the pair search's IN_MASK column.
Neither is a launch argument, so one captured graph serves every draw.

Rows are physically partitioned by leaf, as in the JAX learner: the
(G, N_pad) uint8 (or uint16) bin matrix and the (8, N_pad) f32 payload
(grad, hess, row-id bits, score, objective rows) are reordered together
on every split, so each leaf is one contiguous row range.  The body is
chosen at construction from ``tpu_megakernel``:

  * the mega path (``auto`` / ``pallas``, the default): per split,
    ``ops/split_mega.py`` partitions the chosen leaf and, from the same
    decision, builds both children's histograms.  The root's histogram
    is a ``split_mega`` call with an all-left decision that moves no
    rows.
  * the histogram-subtraction path (``off``; JAX learner.py:2282-2344):
    the learner keeps one histogram slot per leaf
    (``ops/hist_state.py``; int64 fixed-point sums at one scale per
    tree on the card).  The root's histogram goes into slot 0.  Per
    split, ``ops/partition.py`` partitions the leaf, and
    ``ops/hist_state.py`` builds the smaller child's histogram only --
    the child with the smaller bag-aware count (``LM_BLCNT <=
    LM_BRCNT``, ties left), its rows read on the device from the
    partition's left count -- derives the larger child as parent minus
    smaller and writes both slots, in one launch on the card.

Both then run ``ops/split_pair.py:split_pair``, which finds both
children's best splits; the root's best split is a ``split_pair`` call
on (root, root).

The tree loop runs on the device, as the JAX learner's while-loop does.
The packed per-leaf and per-node matrices (``leafmat`` (NLF, L+1) and
``nodemat`` (NND, nodes+1), ops/tree_step.py) live on the learner's
device, and so do the step block that names each step's leaf
(ops/partition.py ``SB_*``), the left count, the children's histogram
planes, the pair search's rows and info block, the root's sums and the
per-tree bound of |grad| and |hess|, all allocated once.  Between two
splits the bookkeeping kernel ``ops/tree_step.py`` commits the split
just made into leafmat, elects the next leaf (the first argmax of
``LM_BGAIN``; the tree stops at a gain that is not > 0) and writes the
next step block and info block; the split kernels read their leaf from
the step block, with grids sized for the root's rows.  After the tree
stops, the remaining steps have ``cnt == 0`` and write nothing, as the
JAX body's trash-slot iterations do.

  * On the card, the first tree's sequence -- the root step, then
    ``nodes`` x (tree_step, the split body, split_pair), then a final
    commit -- runs once on copies of the row buffers to load and size
    everything, is captured as one CUDA graph, and every tree replays
    it.  The host then reads the finished tree once: leafmat, nodemat
    and the step block (``s`` and the error word) in one copy, the one
    host sync a tree that ``syncs`` counts.
  * On the CPU there is no graph: the same steps run through the plain
    versions in a Python loop that stops when the step block says done.

The frontier (``tpu_frontier_k`` = K > 1, the mega path only, as in the
JAX package; ``frontier_k``): each step splits up to K leaves -- the K=1
learner's next leaf and up to K-1 speculative ones -- through K split
bodies, one per step record ``steps[k]``, and one pair search over their
2K children; the bookkeeping kernel ``ops/frontier.py`` replays the K=1
learner's order, renumbers the finished tree into K=1's leafmat and
nodemat and lists the speculative splits past the budget, whose ranges
the undo puts back in their tree-start row order.  The trees, and the
row order left for the next tree, are K=1's bit for bit.  On the card
each step after the root is one conditional IF node of the graph, which
the step before it enables when it selected a batch; the steps group in
blocks of about sqrt(L) with an IF node each, so a tree that stopped
skips the rest of its block node by node and each later block at once.
On the CPU the same steps run in a Python loop.

Quantized training (``use_quantized_grad``; JAX ``hist_scale``): payload
rows 0 and 1 hold integer carriers (ops/quantize.py writes them before
the tree) and the learner's (2,) f32 device word ``qscale`` their scale
(gs, hs), which changes every tree and is read on the device like the
bag count.  Every histogram kernel's scale arm multiplies its f32 output
by it (split_mega, leaf_hist's state children, feat_view), so the search
reads the gain domain; the histogram state keeps the integer sums; the
root's totals are the carriers' exact sums, as f32, times the scale.
Without quantization ``qscale`` is None and no arm runs.

Monotone constraints (``monotone_constraints``; JAX
``find_best_split``'s monotone arms, the reference's monotone
constraints): as in the JAX package, whose fast search they turn off,
they take the histogram-subtraction body at K=1.  fmeta row 7 and the
pair search's FM_MONO column hold each used feature's direction (0 for a
categorical one), the pair search (and the categorical search) runs its
monotone arm, and ``tree_step`` carries each leaf's output bounds
(``LM_CMIN`` / ``LM_CMAX``, the basic rule) into the children's info
rows.  ``monotone_penalty`` is a table of factors by depth
(``penalty_table``, ``mc_pen``).  ``monotone_constraints_method``
``intermediate`` adds the leaves' bin boxes (``boxes``) and, after each
split's commit and before the next election, the refresh of
ops/mono.py: every leaf's bounds from the leaves it is comparable with,
the planes of the leaves whose bounds changed from the histogram state,
one pair search over all L leaves, and the overlay of their rows.
``advanced`` is refused by the config.

``build_tree_eager`` keeps the loop this port ran before, with the
bookkeeping on the host and one sync a split, as the oracle the tests
hold the device loop to (not on monotone data, whose oracle is the JAX
package).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config, DEFAULT_ROW_CHUNK, parse_row_chunk
from ..dataset import BinnedDataset
from ..ops.frontier import (FS_NPRUNED, FS_RUN, KEY_ROW, Frontier, IfNode,
                            cond_handles, frontier_key, frontier_step,
                            frontier_undo)
from ..ops.frontier import MODE_FINAL as FR_FINAL
from ..ops.frontier import MODE_ROOT as FR_ROOT
from ..ops.frontier import MODE_STEP as FR_STEP
from ..ops.feat_view import View, feat_view
from ..ops.hist_state import leaf_hist_rmw, leaf_hist_rmw_step, new_state
from ..ops.mono import mono_overlay, mono_planes, mono_refresh
from ..ops.partition import (S_CNT, SB_DONE, SB_ERR, SB_LEAF, SB_MADE,
                             SB_NEW, SB_S, SB_STEPS, SB_VALID, Workspace,
                             cat_words, make_scalars,
                             partition_leaf, partition_step, scalars_start,
                             step_len, step_words)
from ..ops.split_cat import cat_params, new_work, split_cat
from ..ops.split_mega import (hist_geometry, split_mega, split_mega_step,
                              unpack_hist4)
from ..ops.split_linear import LIN_FIELDS, linear_static, split_linear
from ..ops.split_pair import OUT_FIELDS, penalty_table, split_pair
from ..ops.tree_step import (LM_BDL, LM_BFEAT, LM_BGAIN, LM_BISCAT,
                             LM_BLCNT, LM_BLOUT, LM_BLSG, LM_BLSH, LM_BRCNT,
                             LM_BROUT, LM_BRSG, LM_BRSH, LM_BTHR, LM_CNT,
                             LM_CNT_G, LM_DEPTH,
                             LM_PARENT, LM_PSIDE, LM_START, LM_SUM_G,
                             LM_SUM_H, LM_VALUE, ND_BIN_START, ND_COL,
                             ND_DEFAULT_BIN, ND_DL, ND_FEATURE,
                             ND_FEATURE_ENUM, ND_GAIN, ND_ICOUNT,
                             ND_IS_BUNDLED, ND_IS_CAT, ND_IVALUE,
                             ND_IWEIGHT, ND_LEFT,
                             ND_MISSING, ND_NUM_BIN, ND_RIGHT, ND_THRESHOLD,
                             MODE_COMMIT, MODE_ELECT, MODE_FINAL, MODE_ROOT,
                             MODE_STEP, FMETA_ROWS,
                             NEG_INF, NLF, NND, _f2i, empty_leafmat,
                             info_block, leaf_column, node_column, tree_step)
from ..utils import log


# tpu_frontier_k=auto on the card (PERF.md section 5, the K sweep of
# lightgbm_tpu_torch/bench.py on the mega path)
AUTO_FRONTIER_K = 4


def frontier_k(config: Config, eligible: bool, L: int, device) -> int:
    """K of ``tpu_frontier_k`` (JAX learner.py: the spec's parsing, its
    errors and the fallback): ``auto`` is AUTO_FRONTIER_K on the card when
    the learner is eligible and 1 elsewhere; an integer K > 1 on a learner
    that is not eligible logs a warning and gives 1; the result is capped
    at L - 1."""
    spec = str(getattr(config, "tpu_frontier_k", "auto") or "auto")
    spec = spec.strip().lower()
    if spec in ("auto", ""):
        k = AUTO_FRONTIER_K if (eligible and torch.device(device).type
                                == "cuda") else 1
    else:
        if not spec.lstrip("+-").isdigit():
            raise ValueError("tpu_frontier_k must be 'auto' or a positive "
                             f"integer, got {spec!r}")
        k = int(spec)
        if k < 1:
            raise ValueError("tpu_frontier_k must be >= 1")
        if k > 1 and not eligible:
            log.warning("tpu_frontier_k=%d needs the mega path "
                        "(tpu_megakernel auto/pallas, no EFB bundles, no "
                        "categorical features, uint8 bins, no monotone "
                        "constraints), at least one "
                        "feature and payload row %d free for its row keys; "
                        "using 1", k, KEY_ROW)
            k = 1
    return max(1, min(k, L - 1))


def parse_monotone_constraints(spec, num_total_features: int) -> np.ndarray:
    """The ``monotone_constraints`` param ("1,-1,0" or a list) as a
    per-original-feature int32 array, missing entries 0 (JAX
    learner.py ``parse_monotone_constraints``)."""
    out = np.zeros(num_total_features, dtype=np.int32)
    if spec is None:
        return out
    if isinstance(spec, str):
        spec = spec.strip().strip("()[]")
        if not spec:
            return out
        items = [s for s in spec.replace(" ", "").split(",") if s]
    else:
        items = list(spec)
    vals = [int(v) for v in items]
    if len(vals) > num_total_features:
        raise ValueError(
            f"monotone_constraints has {len(vals)} entries but the dataset "
            f"has {num_total_features} features")
    out[:len(vals)] = vals
    if np.any((out < -1) | (out > 1)):
        raise ValueError("monotone_constraints entries must be -1, 0 or 1")
    return out


def linear_gain_blockers(has_cat: bool, use_mc: bool, N: int, l1: float,
                         max_delta_step: float, F: int) -> list:
    """What keeps a learner out of ``linear_tree_mode`` leafwise_gain
    (JAX learner.py's envelope, in its words; CEGB, ``path_smooth``,
    forced splits, ``feature_contri`` and parallel learners are refused
    by the port's config)."""
    out = []
    if has_cat or use_mc or N >= (1 << 24):
        out.append("categorical/monotone/CEGB/path_smooth/huge-N configs")
    if l1 > 0.0:
        out.append("lambda_l1 > 0")
    if max_delta_step > 0.0:
        out.append("max_delta_step > 0")
    if F == 0:
        out.append("no usable features")
    return out


def _pow2ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class SerialTreeLearner:
    """Builds one tree per call on ``device`` (see module doc)."""

    def __init__(self, dataset: BinnedDataset, config: Config, device,
                 payload_rows: int = 4):
        """``payload_rows``: the payload rows the booster fills (the
        frontier needs row KEY_ROW free).  ``use_quantized_grad`` in
        ``config`` allocates the scale word ``qscale`` (see module doc)."""
        self.ds = dataset
        self.cfg = config
        self.device = torch.device(device)
        meta = dataset.feature_meta_arrays()
        self.G = max(dataset.num_groups, 1)
        self.B = max(dataset.max_group_bins, 2)
        # the bin matrix's dtype (JAX dataset.py _bin_dtype) and the
        # category sets' words (the step block is SB_CAT + W words)
        self.bin_dtype = dataset.bin_dtype
        self.W = cat_words(hist_geometry(self.B)[1])
        self.F = len(meta["feature"])
        self.L = config.num_leaves
        self.max_splits = self.L - 1
        self.N = dataset.num_data
        if self.N >= (1 << 24):
            raise NotImplementedError(
                "lightgbm_tpu_torch trains below 2^24 rows (counts ride f32)")
        # monotone constraints over the used features, categorical ones
        # unconstrained (JAX learner.py: mono_used, mc_mode)
        F = self.F
        mono = parse_monotone_constraints(
            config.monotone_constraints,
            dataset.num_total_features)[meta["feature"]].astype(np.int32)
        mono[meta["is_categorical"] != 0] = 0
        self.use_mc = bool(np.any(mono != 0))
        self.mc_mode = ("intermediate" if self.use_mc and
                        config.monotone_constraints_method == "intermediate"
                        else "basic")
        self.monotone_penalty = float(config.monotone_penalty)
        # per-feature metadata as columns: feature id, group row,
        # bin_start, is_bundled, num_bin, default_bin, missing_type,
        # monotone direction
        is_bundled = np.zeros(F, np.int32)
        for g, grp in enumerate(dataset.groups):
            if len(grp.feature_indices) > 1:
                is_bundled[meta["group"] == g] = 1
        self._fmeta = np.stack([
            meta["feature"], meta["group"], meta["bin_start"], is_bundled,
            meta["num_bin"], meta["default_bin"],
            meta["missing_type"], mono]).astype(np.int32) if F else None
        # EFB bundles: the pair search reads the per-feature view
        # (ops/feat_view.py) of the group histograms (JAX _plain_view)
        self.bundled = bool(is_bundled.any())
        # categorical features: FM_IS_CAT keeps them out of the numerical
        # scans; ops/split_cat.py searches them (JAX find_best_split)
        self.is_cat = meta["is_categorical"].astype(np.int32)
        self.has_cat = bool(self.is_cat.any())
        self.cat_kw = cat_params(config)
        half = np.zeros((F, 8), np.int32)
        if F:
            half[:, 0] = meta["num_bin"]
            half[:, 1] = meta["missing_type"]
            half[:, 2] = meta["default_bin"]
            half[:, 3] = self.is_cat
            half[:, 4] = mono
        self._fmeta_half = half

        # row geometry (learner.py:387-405): [C front pad][N rows][>= 2C
        # tail pad]; the root range starts at row0 = C
        base = parse_row_chunk(config.tpu_row_chunk) or DEFAULT_ROW_CHUNK
        C = min(base, max(_pow2ceil(self.N), 256))
        C = min(_pow2ceil(C), 1 << 15)
        self.row_chunk = C
        self.row0 = C
        self.N_pad = C + ((self.N + C - 1) // C + 2) * C
        pad = np.zeros((self.G, self.N_pad), self.bin_dtype)
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
        # the histogram-subtraction body keeps one histogram slot per leaf;
        # EFB bundles, categorical features, uint16 bins and monotone
        # constraints take it whatever tpu_megakernel says, as the JAX
        # package's mega kernel needs its fast search on the plain
        # all-numerical per-feature view and uint8 bins (learner.py:590,
        # 867-870)
        self._setup_linear_gain(dataset, meta)
        mega = str(config.tpu_megakernel).strip().lower()
        wide = self.bin_dtype != np.uint8
        general = (self.bundled or self.has_cat or wide or self.use_mc
                   or self.linear_gain)
        self.subtract = mega == "off" or general
        if general and mega == "pallas":
            log.warning("tpu_megakernel=pallas needs the plain "
                        "all-numerical path without EFB bundles, "
                        "categorical features, monotone constraints or "
                        "linear_tree_mode=leafwise_gain, on uint8 bins; "
                        "using the histogram-subtraction path")
        self.state = (new_state(self.L, self.G, self.B, self.device)
                      if self.subtract else None)
        # frontier-batched growth on the mega path (the JAX package's
        # eligibility: the pair search without the mega kernel is not)
        self.K = frontier_k(config, not self.subtract and self.F > 0
                            and payload_rows <= KEY_ROW, self.L, self.device)
        self.qscale = (torch.ones(2, dtype=torch.float32, device=self.device)
                       if config.use_quantized_grad else None)
        self.last_steps = self.last_made = 0
        self._alloc()

    def _setup_linear_gain(self, dataset: BinnedDataset, meta) -> None:
        """``linear_tree_mode`` leafwise_gain (JAX learner.py: the linear
        search of ops/split_linear.py in place of the pair search): its
        eligibility, warned about in the JAX package's words and trained
        as refit outside it, and each used feature's representative raw
        values (F, Bp) on the device, from the raw train columns."""
        cfg = self.cfg
        self.linear_gain = (bool(cfg.linear_tree)
                            and cfg.linear_tree_mode == "leafwise_gain")
        self.linear_lambda = float(cfg.linear_lambda)
        self.lin_static = None
        if not self.linear_gain:
            return
        blockers = linear_gain_blockers(self.has_cat, self.use_mc, self.N,
                                        float(cfg.lambda_l1),
                                        float(cfg.max_delta_step), self.F)
        if blockers:
            log.warning("linear_tree_mode=leafwise_gain is not supported "
                        "with %s; falling back to the post-hoc refit mode",
                        ", ".join(blockers))
            self.linear_gain = False
            return
        Bp = hist_geometry(self.B)[1]
        raw = dataset.raw_data
        rep = np.zeros((self.F, Bp), np.float32)
        for i, orig in enumerate(meta["feature"]):
            # a feature alone in its group: its bins are the group's column
            grp = dataset.groups[meta["group"][i]]
            bins = (dataset.binned[:, meta["group"][i]]
                    if raw is not None and dataset.binned is not None
                    and len(grp.feature_indices) == 1 else None)
            rep[i] = dataset.bin_mappers[orig].bin_rep_values(
                Bp, values=None if raw is None else raw[:, orig],
                bins=bins)[:Bp]
        self.lin_static = linear_static(
            meta["num_bin"], meta["missing_type"], meta["default_bin"],
            torch.as_tensor(rep, device=self.device),
            meta["feature"].astype(np.int64), Bp)

    def _alloc(self) -> None:
        """Everything a tree's steps touch, allocated once on the device."""
        L, F, G, K, dev = self.L, self.F, self.G, self.K, self.device
        W, SW = self.W, step_len(self.W)
        nodes = self.max_splits
        BH, Bp = hist_geometry(self.B)
        self.fmeta = torch.as_tensor(
            self._fmeta if F else np.zeros((FMETA_ROWS, 0), np.int32),
            device=dev)
        # leafmat, nodemat, the nodes' and leaves' category sets, the K
        # step records and the root's step block in one flat buffer: the
        # host reads the finished tree in one copy
        a, b, c, d, e = self._layout()
        self._tree_dev = torch.zeros(e + (K + 1) * SW,
                                     dtype=torch.float32, device=dev)
        self.leafmat = self._tree_dev[:a].view(NLF, L + 1)
        self.nodemat = self._tree_dev[a:b].view(NND, nodes + 1)
        self.nodecat = self._tree_dev[b:c].view(torch.int32).view(
            nodes + 1, W)
        self.leafcat = self._tree_dev[c:d].view(torch.int32).view(L + 1, W)
        # leafwise_gain: each leaf's own model (const, coeff, feature id
        # bits; JAX LM_LIN_*), and the children's from the search
        self.leaflin = self._tree_dev[d:e].view(-1, L + 1)
        self.pair_lin = torch.zeros((2 * K, LIN_FIELDS), device=dev)
        self.steps = self._tree_dev[e:e + K * SW].view(
            torch.int32).view(K, SW)
        self.step = self.steps[0]
        self.root_step = self._tree_dev[e + K * SW:].view(torch.int32)
        # the children's category sets (ops/split_cat.py), the categorical
        # features' indices and the search kernel's scratch
        self.paircat = torch.zeros((2, W), dtype=torch.int32, device=dev)
        self.cat_feats = torch.as_tensor(
            np.nonzero(self.is_cat)[0].astype(np.int32), device=dev)
        self.cat_work = (new_work(2, int(self.is_cat.sum()), dev, Bp)
                         if self.has_cat else None)
        # the root's range, an all-left decision (the mega path's
        # histogram-only call) and, for the histogram state, slot 0
        self.root_step.copy_(torch.tensor(step_words(make_scalars(
            self.row0, self.N, 0, 0, 0, self.B, 0, 0, 255, 0, 0, (0,) * W)),
            dtype=torch.int32))
        # per step: K left counts; the pair search over the 2K children
        # (the left children first), its feature metadata repeated
        self.nl = torch.zeros(K, dtype=torch.int32, device=dev)
        # the root's bag-aware row count and the tree's feature mask, read
        # on the device by the bookkeeping kernels: the sampling pass and
        # set_feature_mask refill them, so one graph serves every draw
        self.bag = torch.full((1,), self.N, dtype=torch.int32, device=dev)
        self.fmask = torch.ones(F, dtype=torch.float32, device=dev)
        self.pair_out = torch.full((2 * K, 13), NEG_INF, device=dev)
        self.info = torch.zeros((2 * K * F, 8), device=dev)
        inter = self.mc_mode == "intermediate"
        self.fmeta_pair = torch.as_tensor(np.concatenate(
            [self._fmeta_half] * max(2 * K, L if inter else 0)), device=dev)
        # monotone constraints: the penalty's table by depth and, for
        # intermediate ones, the leaves' boxes and the refresh's buffers
        # (ops/mono.py): changed flags, info rows, planes, rows and sets
        # of the L-leaf re-search and its categorical scratch
        self.mc_pen = (penalty_table(self.monotone_penalty, L).to(dev)
                       if self.use_mc and self.monotone_penalty > 0 else None)
        self.boxes = (torch.zeros((2, L + 1, F), dtype=torch.int32,
                                  device=dev) if inter else None)
        if inter:
            self.mc_changed = torch.zeros(L, dtype=torch.int32, device=dev)
            self.mc_info = torch.zeros((L * F, 8), device=dev)
            self.mc_planes = torch.zeros((2, L, F, Bp), device=dev)
            self.mc_rows = torch.zeros((L, OUT_FIELDS), device=dev)
            self.mc_cats = torch.zeros((L, W), dtype=torch.int32, device=dev)
            self.mc_cat_work = (new_work(L, int(self.is_cat.sum()), dev, Bp)
                                if self.has_cat else None)
        self.sums = torch.zeros(2, device=dev)
        self._absmax = torch.zeros(2, device=dev)
        # the children's planes (plane, child, G, Bp): [0] and [1] viewed
        # as (2KG, Bp) are the pair search's grad and hess inputs
        self.children = torch.zeros((2, 2 * K, G, Bp), device=dev)
        # the mega kernel's (G, side, plane, Bp) histograms, one a leaf
        self.hist4 = (None if self.subtract else
                      torch.zeros((K, G, 4 * BH, 16), device=dev))
        # with bundles, the children's per-feature view (plane, child, F,
        # Bp): the pair search's inputs
        self.view = self.fchildren = None
        if self.bundled:
            m = self._fmeta
            self.view = View(m[1], m[2], m[3], m[4], G, Bp, dev)
            self.fchildren = torch.zeros((2, 2, F, Bp), device=dev)
        self.ws = Workspace(dev) if dev.type == "cuda" else None
        self.fr = None
        if K > 1:
            self.fr = Frontier(L, K, self.leafmat, self.nodemat, self.steps,
                               self.nl, self.pair_out, self.info, self.sums,
                               self.fmeta, self.bag, self.fmask)
            # steps per conditional block: a stopped tree skips the rest of
            # its block step by step and every later block at once
            self.fr_block = max(1, int(np.ceil(np.sqrt(nodes))))
            if dev.type == "cuda":
                # the IF nodes' bodies and the capture on streams of the
                # learner's own, taken together: PyTorch hands out pooled
                # streams round-robin, so torch.cuda.graph's shared default
                # capture stream comes back as a body stream once enough
                # learners have taken theirs
                self._bodies = (torch.cuda.Stream(dev),
                                torch.cuda.Stream(dev))
                self._capture = torch.cuda.Stream(dev)
        self._graph = None
        self._graph_key = None
        self._host = None
        self.replays = 0
        self.captures = 0       # graphs captured (a new row buffer each)

    def _layout(self):
        """Ends of leafmat, nodemat, nodecat, leafcat and leaflin in the
        flat tree buffer (f32 words)."""
        a = NLF * (self.L + 1)
        b = a + NND * self.L
        c = b + self.W * self.L
        d = c + self.W * (self.L + 1)
        return a, b, c, d, d + (LIN_FIELDS * (self.L + 1)
                                if self.linear_gain else 0)

    # ------------------------------------------------------------------
    def _search(self, hg, hh, info, out=None, cat_out=None, cat_work=None):
        """The best splits of the children whose (cF, Bp) histograms are
        hg / hh: (c, 13) f32 on the device; with categorical features the
        categorical search merges into them and writes the children's
        sets to ``cat_out`` (c, W) (the learner's ``paircat`` when not
        given), its scratch ``cat_work`` (the learner's two children's
        when not given).  Monotone constraints run both searches'
        monotone arms."""
        c = hg.shape[0] // max(self.F, 1)
        kw = dict(l1=self.l1, l2=self.l2, max_delta_step=self.max_delta_step,
                  min_gain_to_split=self.min_gain_to_split,
                  min_data_in_leaf=self.min_data_in_leaf,
                  min_sum_hessian=self.min_sum_hessian,
                  max_depth=self.max_depth)
        fm = self.fmeta_pair[:c * self.F]
        if self.linear_gain:
            return split_linear(
                hg, hh, info, self.lin_static, l2=self.l2,
                min_gain_to_split=self.min_gain_to_split,
                min_data_in_leaf=self.min_data_in_leaf,
                min_sum_hessian=self.min_sum_hessian,
                max_depth=self.max_depth, lam=self.linear_lambda,
                children=c, out=out, lin_out=self.pair_lin[:c])[0]
        rows = split_pair(hg, hh, fm, info, out=out, children=c,
                          mono=self.use_mc, pen=self.mc_pen, **kw)
        if self.has_cat:
            split_cat(hg, hh, fm, info, self.cat_feats, rows,
                      self.paircat if cat_out is None else cat_out,
                      children=c, mono=self.use_mc,
                      work=self.cat_work if cat_work is None else cat_work,
                      **kw, **self.cat_kw)
        return rows

    def set_feature_mask(self, mask) -> None:
        """The next trees' (F,) feature mask (bool or 0/1, in the used
        features' order) into the device mask the bookkeeping kernels
        write into the pair search's IN_MASK column; the copy to the card
        is pinned and asynchronous."""
        m = torch.from_numpy(np.asarray(mask, dtype=np.float32).reshape(-1))
        if self.device.type == "cuda":
            m = m.pin_memory()
        self.fmask.copy_(m, non_blocking=True)

    # -- the device-resident loop ------------------------------------------
    def _step(self, mode) -> None:
        tree_step(mode, self.leafmat, self.nodemat, self.step, self.nl,
                  self.pair_out, self.fmeta, self.info, self.sums, self.bag,
                  self.fmask, self.leafcat, self.nodecat, self.paircat,
                  row0=self.row0, N=self.N, boxes=self.boxes)

    def _refresh(self) -> None:
        """Intermediate monotone constraints between a split's commit and
        the next election (ops/mono.py): every leaf's bounds, the changed
        leaves' planes from the histogram state, the pair search over the
        L leaves and the overlay of the changed leaves' rows and sets."""
        mono_refresh(self.leafmat, self.boxes, self.fmeta, self.step,
                     self.fmask, self.mc_changed, self.mc_info)
        mono_planes(self.state, self.mc_changed, self._absmax, self.mc_info,
                    kcnt=self.N, out=self.mc_planes, view=self.view,
                    scale=self.qscale)
        Bp = self.mc_planes.shape[-1]
        self._search(self.mc_planes[0].view(-1, Bp),
                     self.mc_planes[1].view(-1, Bp), self.mc_info,
                     out=self.mc_rows, cat_out=self.mc_cats,
                     cat_work=self.mc_cat_work)
        mono_overlay(self.leafmat, self.leafcat, self.mc_changed,
                     self.mc_rows, self.mc_cats if self.has_cat else None)

    def _next(self, first: bool) -> None:
        """The bookkeeping before a split body: the commit of what is due
        and the next election, with the refresh of intermediate monotone
        constraints between the two after a split (not after the
        root)."""
        if first or self.mc_mode != "intermediate":
            self._step(MODE_STEP)
            return
        self._step(MODE_COMMIT)
        self._refresh()
        self._step(MODE_ELECT)

    def _pair(self, step=None) -> None:
        """The pair search over the children's planes; with bundles, over
        their per-feature view, formed first from the state slots of
        ``step`` (default: the K=1 step block) -- after the bookkeeping
        wrote the children's info rows, whose sums the CPU's view reads."""
        ch = self.children
        if self.bundled:
            feat_view(ch, self.info, self.state,
                      self.step if step is None else step, self._absmax,
                      kcnt=self.N, view=self.view, out=self.fchildren,
                      scale=self.qscale)
            ch = self.fchildren
        Bp = ch.shape[-1]
        self._search(ch[0].view(-1, Bp), ch[1].view(-1, Bp), self.info,
                     out=self.pair_out)
        if self.linear_gain:
            self._store_linear(step is self.root_step)

    def _store_linear(self, root: bool) -> None:
        """The searched leaves' own models into ``leaflin``: the root's
        into column 0, a split's two children's into the slots of the
        step block (``SB_LEAF``, ``SB_NEW``), into the spare column L
        when the step made no split; read on the device, so the graph
        replays it for every tree."""
        if root:
            self.leaflin[:, 0] = self.pair_lin[0]
            return
        w = self.step
        slots = torch.where(w[SB_VALID] != 0, w[SB_LEAF:SB_NEW + 1], self.L)
        self.leaflin.index_copy_(1, slots.long(), self.pair_lin[:2].T)

    def leaf_linear(self):
        """The tree's (L,) own-model constants and slopes (f32) and
        original feature ids (int32) on the device (leafwise_gain)."""
        lin = self.leaflin[:, :self.L]
        return lin[0], lin[1], lin[2].view(torch.int32)

    def _mega_kw(self):
        return dict(num_bins=self.B, num_groups=self.G, bound=self.N,
                    ws=self.ws, absmax=self._absmax, scale=self.qscale)

    def _body(self, pb, pg, step) -> None:
        """One split body on the leaf of ``step`` (the root's: its
        histogram only), into the children's planes."""
        G, B, N = self.G, self.B, self.N
        kw = dict(num_bins=B, num_groups=G, bound=N, ws=self.ws,
                  scale=self.qscale)
        root = step is self.root_step
        if self.subtract:
            if not root:
                partition_step(pb, pg, step, self.nl, bound=N, ws=self.ws)
            leaf_hist_rmw_step(pb, pg, step, None if root else self.nl,
                               state=self.state, absmax=self._absmax,
                               kcnt=N, out=self.children, **kw)
            return
        split_mega_step(pb, pg, step, self.nl, self.hist4[0], move=not root,
                        absmax=self._absmax, **kw)
        # (G, side, plane, Bp) -> (plane, child, G, Bp); the root's
        # all-left histogram is both children
        h4 = self.hist4[0].view(G, 2, 2, -1)
        src = (h4[:, :1].expand(-1, 2, -1, -1) if root else h4)
        self.children.copy_(src.permute(2, 1, 0, 3))

    def _root(self, pb, pg) -> None:
        """The root: the tree's bound of |grad| and |hess|, the root's
        histogram and sums, tree_step's reset, the root's search."""
        torch.amax(pg[:2].abs(), dim=1, out=self._absmax)
        self._body(pb, pg, self.root_step)
        self._root_sums(pg, self.children[0, 0, 0], self.children[1, 0, 0],
                        self.sums)
        self._step(MODE_ROOT)
        if self.F:
            self._pair(self.root_step)

    def _root_sums(self, pg, hg0, hh0, out) -> None:
        """The root's grad and hess totals into ``out`` (2,): the sums of
        group 0's histogram rows ``hg0`` / ``hh0``; quantized, the exact
        sums of the integer carriers as f32 times the scale (JAX
        learner.py: the integer-domain root totals times hist_scale)."""
        if self.qscale is None:
            torch.stack([hg0.sum(), hh0.sum()], out=out)
            return
        torch.mul(pg[:2].sum(dim=1, dtype=torch.float64).float(),
                  self.qscale, out=out)

    def _sequence(self, pb, pg) -> None:
        """The whole tree as a fixed sequence of launches (the graph)."""
        self._root(pb, pg)
        for i in range(self.max_splits if self.F else 1):
            self._next(i == 0)
            if self.F:
                self._body(pb, pg, self.step)
                self._pair()
        self._step(MODE_FINAL)

    def _loop(self, pb, pg) -> None:
        """The same steps in a Python loop that stops when the step block
        says done (on the CPU, where reading it is no sync)."""
        if self.K > 1:
            return self._fr_loop(pb, pg)
        self._root(pb, pg)
        first = True
        while True:
            self._next(first)
            first = False
            if int(self.step[SB_DONE]):
                break
            self._body(pb, pg, self.step)
            self._pair()

    # -- the frontier (K > 1, the mega path) -------------------------------
    def _fstep(self, mode, handles=(0, 0)) -> None:
        frontier_step(mode, self.fr, row0=self.row0, N=self.N,
                      handles=handles)

    def _fr_children(self) -> None:
        """The K leaves' (G, side, plane, Bp) histograms into the
        children's planes (plane, side, K, G, Bp): child k is leaf k's
        left, child K + k its right."""
        K, G = self.K, self.G
        Bp = self.children.shape[-1]
        self.children.view(2, 2, K, G, Bp).copy_(
            self.hist4.view(K, G, 2, 2, Bp).permute(3, 2, 0, 1, 4))

    def _fr_root(self, pb, pg, handles=(0, 0)) -> None:
        """The frontier's root: the tree's bound of |grad| and |hess|, the
        rows' tree-start positions (payload row KEY_ROW), the root's
        histogram (leaf 0 of the step) and sums, the reset, the root's
        search (child 0) and the selection of the first step's batch."""
        torch.amax(pg[:2].abs(), dim=1, out=self._absmax)
        frontier_key(pg, row0=self.row0, N=self.N)
        split_mega_step(pb, pg, self.root_step, self.nl[:1], self.hist4[0],
                        move=False, **self._mega_kw())
        self._fr_children()
        self._root_sums(pg, self.children[0, 0, 0], self.children[1, 0, 0],
                        self.sums)
        self._fstep(FR_ROOT)
        self._pair()
        self._fstep(FR_STEP, handles)

    def fr_step(self, pb, pg, handles=(0, 0)) -> None:
        """One frontier step: the split kernel on each of the K step
        records (a record of no rows writes a zero histogram and moves
        nothing), one pair search over the 2K children, the bookkeeping
        that commits them and selects the next batch."""
        kw = self._mega_kw()
        for k in range(self.K):
            split_mega_step(pb, pg, self.steps[k], self.nl[k:k + 1],
                            self.hist4[k], **kw)
        self._fr_children()
        self._pair()
        self._fstep(FR_STEP, handles)

    def _fr_undo(self, pb, pg) -> None:
        frontier_undo(pb, pg, self.fr, bound=self.N, ws=self.ws)

    def _fr_loop(self, pb, pg) -> None:
        """The frontier's steps in a Python loop that stops when the state
        says no batch was selected, then the renumber and, when something
        was pruned, the undo; the key row cleared (on the CPU, where
        reading the state is no sync)."""
        fs = self.fr.fs
        self._fr_root(pb, pg)
        while int(fs[FS_RUN]):
            self.fr_step(pb, pg)
        self._fstep(FR_FINAL)
        if int(fs[FS_NPRUNED]):
            self._fr_undo(pb, pg)
        frontier_key(pg, row0=self.row0, N=self.N, clear=True)

    def _fr_sequence(self, pb, pg) -> None:
        """The frontier's tree as the captured graph: the root, then L - 1
        steps, each in a conditional IF node that the step before it
        enables when it selected a batch, grouped in blocks of
        ``fr_block`` steps inside IF nodes of their own (a stopped tree
        skips each later block as one node); the renumber; the undo in an
        IF node that the renumber enables when something was pruned; the
        key row cleared.  Outside a capture (the run that sizes
        everything) the same launches run with no IF nodes: the steps
        after the tree stops and an undo with nothing listed write
        nothing."""
        n, blk = self.max_splits, self.fr_block
        nb = -(-n // blk)
        capture = torch.cuda.is_current_stream_capturing()
        if capture:
            hs = cond_handles(n, self.device)
            hb = cond_handles(nb, self.device)
            hu = cond_handles(1, self.device)[0]
        else:
            hs, hb, hu = [0] * n, [0] * nb, 0

        def enable(t):      # the handles the step before step t sets
            if t >= n:
                return (0, 0)
            return (hs[t], hb[t // blk] if t % blk == 0 else 0)

        def cond(handle, body):
            return (IfNode(handle, body) if capture
                    else contextlib.nullcontext())

        self._fr_root(pb, pg, enable(0))
        for b in range(nb):
            with cond(hb[b], self._bodies[0]):
                for t in range(b * blk, min(n, (b + 1) * blk)):
                    with cond(hs[t], self._bodies[1]):
                        self.fr_step(pb, pg, enable(t + 1))
        self._fstep(FR_FINAL, (hu, 0))
        with cond(hu, self._bodies[0]):
            self._fr_undo(pb, pg)
        frontier_key(pg, row0=self.row0, N=self.N, clear=True)

    def _replay(self, pb, pg) -> None:
        """Grow the tree by replaying the captured graph, capturing it
        first when the buffers are new: one run of the steps on copies of
        the row buffers loads every kernel and sizes the workspace, which
        is then frozen, and the capture holds its addresses."""
        key = (pb.data_ptr(), pg.data_ptr())
        if self._graph_key != key:
            self._graph = None
            sequence = self._fr_sequence if self.K > 1 else self._sequence
            sequence(pb.clone(), pg.clone())
            self.ws.frozen = True
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._capture
                                  if self.K > 1 else None):
                sequence(pb, pg)
            self._graph, self._graph_key = graph, key
            self.captures += 1
            self._host = torch.empty(self._tree_dev.shape,
                                     dtype=torch.float32, pin_memory=True)
            self._done = torch.cuda.Event()
        self._graph.replay()
        self.replays += 1

    def build_tree(self, part_bins: torch.Tensor, part_ghi: torch.Tensor,
                   before_read: Optional[Callable[[], None]] = None
                   ) -> Dict[str, Any]:
        """Grow one tree over the payload in ``part_ghi`` (rows 0/1 hold
        this iteration's grad/hess), partitioning both buffers in place,
        with the tree loop on the device (see module doc).  The bag-aware
        row count is the device word ``bag`` (the sampling pass writes
        it).  ``before_read`` runs device work on the finished tree (the
        leaf renewal rewrites leafmat's values, the linear fit) before its
        host read; a tensor it returns is read in the same copy, as the
        record's ``extra``.  Returns the host record of
        ``_unpack_state``; ``leafmat`` keeps the tree on the device."""
        extra = None
        if self.device.type == "cuda":
            self._replay(part_bins, part_ghi)
            if before_read is not None:
                extra = before_read()
            self._host.copy_(self._tree_dev, non_blocking=True)
            if extra is not None:
                ex = torch.empty(extra.shape, dtype=extra.dtype,
                                 pin_memory=True)
                ex.copy_(extra, non_blocking=True)
                extra = ex
            self._done.record()
            self._done.synchronize()
            host = self._host.numpy().copy()
        else:
            self._loop(part_bins, part_ghi)
            if before_read is not None:
                extra = before_read()
            host = self._tree_dev.numpy().copy()
        self.syncs += 1
        L, nodes, K = self.L, self.max_splits, self.K
        a, b, c, d, e = self._layout()
        steps = host[e:].view(np.int32).reshape(K + 1, step_len(self.W))
        err = int(np.bitwise_or.reduce(steps[:, SB_ERR]))
        if err:
            raise RuntimeError(
                f"tree loop: a step block failed its device checks (error "
                f"bits {err}: 1 range outside the bound, 2 histogram-state "
                f"slot, 4 leaf or feature index, 8 more pruned splits than "
                f"K - 1)")
        if K > 1:
            self.last_made = int(steps[0, SB_MADE])
            self.last_steps = int(steps[0, SB_STEPS])
        rec = self._unpack_state(host[:a].reshape(NLF, L + 1),
                                 host[a:b].reshape(NND, nodes + 1),
                                 int(steps[0, SB_S]),
                                 host[b:c].view(np.int32).reshape(
                                     nodes + 1, self.W))
        if self.linear_gain:
            # each leaf's own model (JAX learner.py ``leaf_lin_*``)
            lin = host[d:e].reshape(LIN_FIELDS, L + 1)[:, :L]
            rec.update({"leaf_lin_const": lin[0], "leaf_lin_coeff": lin[1],
                        "leaf_lin_feat": lin[2].view(np.int32)})
        if extra is not None:
            rec["extra"] = extra.numpy().copy()
        return rec

    # -- the oracle: the host loop -----------------------------------------
    def _info(self, halves):
        """(2F, 8) f32 info block on the device from two (sum_g, sum_h,
        cnt, depth) and the feature mask."""
        return torch.as_tensor(
            info_block(self.F, halves, self.fmask.cpu().numpy()),
            device=self.device)

    def _eager_search(self, hg, hh, info, idx, cnt):
        """The pair search over two children's (2G, Bp) histograms, read
        through the feature view when the data has bundles (``idx`` the
        state slots of the split, ``cnt`` its rows)."""
        if self.bundled:
            G, F = self.G, self.F
            ch = torch.stack([hg.view(2, G, -1), hh.view(2, G, -1)])
            step = torch.tensor(step_words(make_scalars(
                0, cnt, 0, 0, 0, 0, 0, 0, 0, 0), idx), dtype=torch.int32,
                device=self.device)
            fv = torch.empty_like(self.fchildren)
            feat_view(ch, info, self.state, step, self._absmax, kcnt=self.N,
                      view=self.view, out=fv, scale=self.qscale)
            hg, hh = fv[0].reshape(2 * F, -1), fv[1].reshape(2 * F, -1)
        cats = torch.zeros((2, self.W), dtype=torch.int32,
                           device=self.device)
        return self._search(hg, hh, info, cat_out=cats), cats

    def _root_hist(self, part_bins, part_ghi):
        """The root's (G, Bp) grad and hess histograms twice, as (2G, Bp):
        the pair search's inputs for (root, root)."""
        G, B = self.G, self.B
        if self.subtract:
            ch = leaf_hist_rmw(part_bins, part_ghi, self.row0, self.N,
                               num_bins=B, num_groups=G, state=self.state,
                               idx=(-1, 0, 0, 0), absmax=self._absmax,
                               kcnt=self.N, scale=self.qscale)
            return ch[0].reshape(2 * G, -1), ch[1].reshape(2 * G, -1)
        # an all-left mega call that moves no rows
        _, acc = split_mega(part_bins, part_ghi,
                            make_scalars(self.row0, self.N, 0, 0, 0, B, 0,
                                         0, 255, 0),
                            num_bins=B, num_groups=G, move=False,
                            absmax=self._absmax, scale=self.qscale)
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
                               absmax=self._absmax, kcnt=self.N,
                               scale=self.qscale)
            return nl, ch[0].reshape(2 * G, -1), ch[1].reshape(2 * G, -1)
        nl, acc = split_mega(part_bins, part_ghi, scalars, num_bins=B,
                             num_groups=G, absmax=self._absmax,
                             scale=self.qscale)
        hl_g, hl_h, hr_g, hr_h = unpack_hist4(acc, B)
        return nl, torch.cat([hl_g, hr_g]), torch.cat([hl_h, hr_h])

    def build_tree_eager(self, part_bins: torch.Tensor,
                         part_ghi: torch.Tensor,
                         before_read: Optional[Callable[[], None]] = None
                         ) -> Dict[str, Any]:
        """The oracle of ``build_tree``: the same tree, grown by an eager
        Python loop with the bookkeeping on the host, the kernels' host-int
        entry points and one host sync a split (the port's loop before the
        tree moved onto the device), with the bag count read from the
        device word ``bag``.  Leaves the tree in ``leafmat`` too, where
        ``before_read`` then works on it."""
        if self.use_mc or self.linear_gain:
            raise NotImplementedError(
                "build_tree_eager: monotone constraints and leafwise_gain "
                "grow on the device loop only (the JAX package is their "
                "oracle)")
        L, F, W = self.L, self.F, self.W
        bag_cnt = int(self.bag[0])
        nodes = self.max_splits
        lm = empty_leafmat(L)
        nm = np.zeros((NND, nodes + 1), np.float32)
        lc = np.zeros((L + 1, W), np.int32)
        nc = np.zeros((nodes + 1, W), np.int32)

        # the card's fixed-point histograms (split_mega, leaf_hist_rmw)
        # are scaled by one bound of |grad| and |hess| per tree, kept on
        # the device (and the histogram state by the root's row count)
        torch.amax(part_ghi[:2].abs(), dim=1, out=self._absmax)
        # root: its histogram, then the best split from a pair search
        # over (root, root)
        hg, hh = self._root_hist(part_bins, part_ghi)
        sums = torch.empty(2, device=self.device)
        self._root_sums(part_ghi, hg[0], hh[0], sums)
        sum_g, sum_h = sums[0], sums[1]
        if F:
            info = self._info([(0, 0, bag_cnt, 0)] * 2)
            info[:, 0] = sum_g
            info[:, 1] = sum_h
            tile, cats = self._eager_search(hg, hh, info, (-1, 0, 0, 0),
                                            self.N)
            tile, cats = tile[0], cats[0]
        else:
            tile = torch.full((13,), NEG_INF, device=self.device)
            cats = torch.zeros(W, dtype=torch.int32, device=self.device)
        host = torch.cat([sum_g.reshape(1), sum_h.reshape(1), tile,
                          cats.view(torch.float32)]).cpu()
        self.syncs += 1
        host = host.numpy()
        lm[:, 0] = leaf_column(self.row0, self.N, bag_cnt, host[0], host[1],
                               0, 0.0, -1, 0, host[2:15])
        lc[0] = host[15:].view(np.int32)

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
            _, col, bstart, isb, nb, dbin, mtype = (
                int(v) for v in self._fmeta[:7, f_enum])
            start = int(_f2i(pcol[LM_START]))
            cnt = int(_f2i(pcol[LM_CNT]))
            left_cnt_g = int(_f2i(pcol[LM_BLCNT]))
            right_cnt_g = int(_f2i(pcol[LM_BRCNT]))
            iscat = int(pcol[LM_BISCAT] > 0.5)
            nl, hg, hh = self._split(
                part_bins, part_ghi,
                make_scalars(start, cnt, col, bstart, isb, nb, dbin, mtype,
                             thr, dl, iscat, lc[best_leaf]),
                best_leaf, new_leaf, left_cnt_g <= right_cnt_g)
            lsg, lsh = pcol[LM_BLSG], pcol[LM_BLSH]
            rsg, rsh = pcol[LM_BRSG], pcol[LM_BRSH]
            lout, rout = pcol[LM_BLOUT], pcol[LM_BROUT]
            depth_child = int(_f2i(pcol[LM_DEPTH])) + 1

            # record the internal node; fix the parent's child pointer
            nm[:, s] = node_column(pcol, gain, self._fmeta[:, f_enum],
                                   best_leaf, new_leaf)
            nm[ND_IS_CAT, s] = iscat
            nc[s] = lc[best_leaf]
            p = int(_f2i(pcol[LM_PARENT]))
            if p >= 0:
                side = int(_f2i(pcol[LM_PSIDE]))
                nm.view(np.int32)[ND_LEFT if side == 0 else ND_RIGHT, p] = s

            tile, cats = self._eager_search(
                hg, hh, self._info([(lsg, lsh, left_cnt_g, depth_child),
                                    (rsg, rsh, right_cnt_g, depth_child)]),
                (best_leaf, best_leaf, new_leaf,
                 int(left_cnt_g <= right_cnt_g)), cnt)
            host = torch.cat([nl.view(torch.float32), tile.reshape(-1),
                              cats.view(torch.float32).reshape(-1)]).cpu()
            self.syncs += 1
            host = host.numpy()
            lc[[best_leaf, new_leaf]] = host[27:].view(np.int32).reshape(
                2, W)
            left_cnt = int(_f2i(host[0]))
            lm[:, best_leaf] = leaf_column(
                start, left_cnt, left_cnt_g, lsg, lsh, depth_child, lout, s,
                0, host[1:14])
            lm[:, new_leaf] = leaf_column(
                start + left_cnt, cnt - left_cnt, right_cnt_g, rsg, rsh,
                depth_child, rout, s, 1, host[14:27])
            s += 1
        self.leafmat.copy_(torch.as_tensor(lm))
        self.nodemat.copy_(torch.as_tensor(nm))
        self.leafcat.copy_(torch.as_tensor(lc))
        self.nodecat.copy_(torch.as_tensor(nc))
        if before_read is not None:
            before_read()
            lm = self.leafmat.cpu().numpy()
        return self._unpack_state(lm, nm, s, nc)

    def _unpack_state(self, lm, nm, s, nc) -> Dict[str, Any]:
        """The packed matrices as the per-field host record
        (learner.py:_unpack_state); ``nc`` the nodes' category sets."""
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
            "node_col": ni(ND_COL), "node_bin_start": ni(ND_BIN_START),
            "node_is_bundled": ni(ND_IS_BUNDLED),
            "node_num_bin": ni(ND_NUM_BIN),
            "node_default_bin": ni(ND_DEFAULT_BIN),
            "node_is_cat": nm[ND_IS_CAT] > 0.5,
            "node_cat_set": np.asarray(nc[:nodes], np.int32),
        }

    @staticmethod
    def node_arrays_for_predict(rec: Dict[str, Any]) -> Dict[str, Any]:
        """The bin-space node arrays of the tree in host record ``rec``
        (JAX learner.py node_arrays_for_predict), cut to its ``s``
        internal nodes, for ops/predict.py ``predict_leaf_binned``; the
        frontier's record is already renumbered into K=1's."""
        s = int(rec["s"])
        return {"col": rec["node_col"][:s],
                "bin_start": rec["node_bin_start"][:s],
                "is_bundled": rec["node_is_bundled"][:s],
                "num_bin": rec["node_num_bin"][:s],
                "default_bin": rec["node_default_bin"][:s],
                "missing_type": rec["node_missing_type"][:s],
                "threshold": rec["node_threshold"][:s],
                "default_left": rec["node_default_left"][:s],
                "left": rec["node_left"][:s], "right": rec["node_right"][:s],
                "is_cat": rec["node_is_cat"][:s],
                "cat_set": rec["node_cat_set"][:s],
                "num_nodes": s}
