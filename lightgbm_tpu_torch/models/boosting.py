"""GBDT boosting of the slice: the fused physical-order iteration.

Port of lightgbm_tpu/models/boosting.py (``GBDT`` with
``_setup_fused_phys``, ``_train_one_iter_fused``, ``_scores_from_phys``
and ``predict_raw``).  Gradients, scores and the objective's row data
ride the partition payload, so an iteration computes gradients in the
physical row order left by the previous tree, builds the tree, and adds
each leaf's value to its contiguous row range -- no per-iteration
scatter back to the original row order.  Payload rows: 0 grad, 1 hess,
2 row-id bits (pad rows hold the sentinel N), 3 score, 4.. the
objective's ``payload_fields``, zero-padded to 8; row 7 carries the
frontier's row keys during a tree (ops/frontier.py ``KEY_ROW``) and is
zero between trees.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import BinnedDataset
from ..ops.frontier import KEY_ROW
from ..ops.predict import ThresholdIndex, predict_leaf_thridx
from ..ops.split_mega import GHI_ROWS
from ..ops.tree_step import LM_CNT, LM_START, LM_VALUE
from ..utils import log
from .learner import SerialTreeLearner
from .metric import create_metrics
from .objective import ObjectiveFunction
from .tree import Tree, tree_from_device_record

K_EPSILON = 1e-15


def scores_from_phys(ghi: torch.Tensor, num_data: int) -> torch.Tensor:
    """Scatter the physically ordered score row back to original row order
    (row ids ride row 2 as int32 bits; pad rows carry ``num_data``)."""
    rowid = ghi[2].view(torch.int32).long()
    keep = rowid < num_data
    out = torch.zeros(num_data, dtype=torch.float32, device=ghi.device)
    out[rowid[keep]] = ghi[3][keep]
    return out


class GBDT:
    """Gradient Boosting Decision Tree engine (reference: gbdt.cpp)."""

    def __init__(self, config: Config, train_data: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction], device):
        self.config = config
        self.device = torch.device(device)
        self.train_data = train_data
        self.objective = objective
        self.models: List[Tree] = []
        self.iter = 0
        self.shrinkage_rate = float(config.learning_rate)
        self.num_tree_per_iteration = 1
        self.num_class = 1
        self.init_scores = [0.0]
        self.max_feature_idx = 0
        self.feature_names: List[str] = []
        self.label_idx = 0
        self.train_metrics = []
        self._phys: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._scores: Optional[torch.Tensor] = None
        if train_data is not None:
            self._setup_training(train_data)

    # ------------------------------------------------------------------
    def _setup_training(self, train_data: BinnedDataset) -> None:
        cfg = self.config
        dev = self.device
        self.learner = SerialTreeLearner(train_data, cfg, dev)
        self.num_data = N = train_data.num_data
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.objective.init(train_data.metadata, dev)
        self.train_metrics = create_metrics(cfg, self.objective.name)
        for m in self.train_metrics:
            m.init(train_data.metadata, dev)
        md = train_data.metadata
        if md.init_score is not None:
            scores = torch.as_tensor(md.init_score, dtype=torch.float32,
                                     device=dev)
        else:
            scores = torch.zeros(N, dtype=torch.float32, device=dev)
            if cfg.boost_from_average:
                s = self.objective.boost_from_score(0)
                if abs(s) > K_EPSILON:
                    self.init_scores[0] = s
                    scores = scores + s
                    log.info("Start training from score %f", s)
        # the physical carrier adopts the learner's master bin buffer: the
        # partition permutes it in place, iteration after iteration
        lr = self.learner
        C, Npad = lr.row0, lr.N_pad
        ghi = torch.zeros((GHI_ROWS, Npad), dtype=torch.float32, device=dev)
        iota = torch.arange(Npad, device=dev, dtype=torch.int32)
        rowid = torch.where((iota >= C) & (iota < C + N), iota - C, N)
        ghi[2] = rowid.to(torch.int32).view(torch.float32)
        ghi[3, C:C + N] = scores
        self._payload_names = [n for n, _ in self.objective.payload()]
        if lr.K > 1 and 4 + len(self._payload_names) > KEY_ROW:
            raise NotImplementedError(
                f"tpu_frontier_k > 1 keeps payload row {KEY_ROW} for its "
                f"row keys; objective {self.objective.name} fills it")
        for i, (_, arr) in enumerate(self.objective.payload()):
            ghi[4 + i, C:C + N] = arr
        self._phys = (lr.part0, ghi)
        lr.part0 = None

    # -- train scores in original row order ------------------------------
    @property
    def scores(self) -> torch.Tensor:
        if self._phys is not None:
            return scores_from_phys(self._phys[1], self.num_data)
        return self._scores

    def train_one_iter(self) -> bool:
        """One fused iteration; returns True when the tree is a stump
        (no split met the requirements)."""
        pb, ghi = self._phys
        lr = self.learner
        N = self.num_data
        vf = (ghi[2].view(torch.int32) != N).to(torch.float32)
        payload = [ghi[4 + i] for i in range(len(self._payload_names))]
        g, h = self.objective.gradients_from_payload(ghi[3], *payload)
        ghi[0] = g * vf
        ghi[1] = h * vf
        rec = lr.build_tree(pb, ghi, N)
        num_nodes = int(rec["s"])
        self._add_leaf_values(ghi)
        tree = tree_from_device_record(rec, num_nodes,
                                       self.train_data.bin_mappers,
                                       shrinkage=self.shrinkage_rate)
        if not self.models and abs(self.init_scores[0]) > K_EPSILON:
            if num_nodes > 0:
                tree.leaf_value = tree.leaf_value + self.init_scores[0]
                tree.internal_value = tree.internal_value + self.init_scores[0]
            else:
                tree.leaf_value = np.asarray([self.init_scores[0]])
        self.models.append(tree)
        self.iter += 1
        if num_nodes == 0:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
        return num_nodes == 0

    def _add_leaf_values(self, ghi) -> None:
        """Add each leaf's shrunk value to its contiguous physical row
        range, from the tree the learner keeps on the device (no host
        sync): the L leafmat columns in the order of their starts, each
        value repeated over its count (columns of no leaf have count 0)."""
        lr = self.learner
        lm = lr.leafmat[:, :lr.L]
        starts = lm[LM_START].view(torch.int32)
        order = torch.argsort(starts, stable=True)
        cnts = lm[LM_CNT].view(torch.int32)[order].long()
        vals = lm[LM_VALUE][order]
        N = self.num_data
        delta = torch.repeat_interleave(vals * self.shrinkage_rate, cnts,
                                        output_size=N)
        ghi[3, lr.row0:lr.row0 + N] += delta

    def eval_train(self) -> List[Tuple[str, float, bool]]:
        sc = self.scores
        return [(name, val, m.is_max_better) for m in self.train_metrics
                for name, val in m.eval(sc, self.objective)]

    def num_trees(self) -> int:
        return len(self.models)

    @property
    def current_iteration(self) -> int:
        return self.iter

    # ------------------------------------------------------------------
    def predict_raw(self, data: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
        """Raw scores (f64 sums of the trees' leaf values) on the device,
        every tree walked in threshold-index space."""
        data = np.asarray(data, dtype=np.float64)
        total = len(self.models)
        end = total if num_iteration <= 0 else min(
            total, start_iteration + num_iteration)
        out = torch.zeros(data.shape[0], dtype=torch.float64,
                          device=self.device)
        trees = self.models[start_iteration:end]
        tix = ThresholdIndex(trees)
        packed = tix.pack_values(data, self.device)
        for tree in trees:
            leaf = predict_leaf_thridx(packed, tix.nodes(tree))
            lv = torch.as_tensor(tree.leaf_value, dtype=torch.float64,
                                 device=self.device)
            out += lv[leaf]
        return out.cpu().numpy()

    def predict(self, data: np.ndarray, raw_score: bool = False,
                **kw) -> np.ndarray:
        raw = self.predict_raw(data, **kw)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(torch.as_tensor(raw)).numpy()
