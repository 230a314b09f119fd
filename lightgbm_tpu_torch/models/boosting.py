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

The L1-family objectives renew each leaf's value after the tree
(models/renew.py), on the device before the tree's one host read, so the
model text, the train scores and the validation scores carry the renewed
values.

Multiclass (``num_class`` = K > 1) grows K trees an iteration.  The
class scores stay out of the payload: a (K, N) f32 buffer in original
row order holds them, all K classes' gradients come from it once an
iteration, each class tree gathers its class's grad and hess into
payload rows 0 and 1 through the row ids of row 2, and its shrunk leaf
values go back into its score row through the same ids -- so any K runs
through the same captured tree loop, the frontier included.  One feature
mask and one bag serve the K trees of an iteration.

Quantized training (``use_quantized_grad``; JAX ``_setup_fused_phys``'s
in-program discretizer and the eager ``_discretize_gradients``): after
sampling, one pass of ops/quantize.py turns payload rows 0 and 1 into
integer carriers and writes their scale into the learner's device word
``qscale``, which the histogram kernels' scale arms read.  The draw
follows the JAX package's iteration for the configuration: its fused
one (``fold_in(PRNGKey(seed), iter + 1)`` drawn at the physical
position) for objectives with payload gradients, its eager one (the
``quant_rng`` chain drawn in original row order, and the eager bag) for
multiclass, custom gradients, the renewing objectives and the objectives
whose gradients JAX does not fuse (``reference_fused``).  With
``quant_train_renew_leaf`` the true grad and hess ride payload rows
``4 + fields`` and ``5 + fields`` through the partition, and each leaf's
value is renewed from their sums before the tree's host read (before the
L1-family renewal, as JAX orders them).

Host-side per-row data crosses into the physical order through the row
ids of payload row 2 (``rows_to_phys``, the inverse of
``scores_from_phys``): a custom objective's gradients
(``train_one_iter(grad, hess)``), a ranking objective's (its
``get_gradients`` reads the scores in original row order; the iteration
then samples and quantizes as a custom objective's, JAX's eager draws)
and a continued model's train scores (``continue_from``).  Validation sets keep their (N_valid, G) bin
matrix and f32 scores on the booster's device; after each tree the
scores gain the tree's f32 shrunk leaf values at the leaves of
``ops/predict.py:predict_leaf_binned``, walked over the node arrays of
the tree's one host read, outside the captured graph.

The eager iteration (JAX boosting.py ``GBDT.train_one_iter``), taken
with ``tpu_fused_iteration=false``, by DART and RF, by GOSS with a
renewing objective and where quantized training draws eagerly: the
gradients leave the payload for original row order, where the bag, GOSS
and the quantization are drawn as that iteration draws them (an exact
count by a permutation, ``quant_rng`` at the row id), and go back into
the physical order before the tree's graph replay.  Every tree appended
keeps a device record (JAX ``device_trees``): its bin-space node arrays
and its f32 shrunk leaf values.  ``_tree_to_scores`` walks a past tree
over the learner's live physical bin matrix (the order of payload row
3) and over the validation sets, to add its values times a factor:
``rollback_one_iter`` takes the last iteration out, ``DART`` drops and
renormalises trees.  ``RF`` averages trees grown from the gradients at
the init score.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import BinnedDataset
from ..ops.predict import (ThresholdIndex, pack_binned_nodes,
                           predict_leaf_binned, predict_leaf_binned_t,
                           predict_leaf_thridx, tree_depth)
from ..ops.quantize import quantize
from ..ops.sample import (MODE_BAG, MODE_BALANCED, MODE_GOSS, goss_threshold,
                          sample)
from ..ops.split import leaf_output
from ..ops.split_mega import GHI_ROWS
from ..ops.partition import SB_S
from ..ops.tree_step import LM_CNT, LM_PARENT, LM_START, LM_VALUE
from ..utils import log
from ..utils import random as jrandom
from . import linear as linmod
from .learner import SerialTreeLearner
from .metric import create_metrics
from .objective import ObjectiveFunction
from .renew import renew_leaves
from .tree import Tree, tree_from_device_record

K_EPSILON = 1e-15


def scores_from_phys(ghi: torch.Tensor, num_data: int,
                     row: int = 3) -> torch.Tensor:
    """Scatter the physically ordered score row (or payload row ``row``)
    back to original row order (row ids ride row 2 as int32 bits; pad
    rows carry ``num_data``)."""
    rowid = ghi[2].view(torch.int32).long()
    keep = rowid < num_data
    out = torch.zeros(num_data, dtype=torch.float32, device=ghi.device)
    out[rowid[keep]] = ghi[row][keep]
    return out


def rows_to_phys(ghi: torch.Tensor, values: torch.Tensor,
                 num_data: int) -> torch.Tensor:
    """``values`` (num_data,) in original row order, gathered into the
    physical order of ``ghi``'s row ids (the inverse of
    ``scores_from_phys``); pad rows get 0."""
    rowid = ghi[2].view(torch.int32)
    keep = rowid != num_data
    src = torch.where(keep, rowid, 0).long()
    return torch.where(keep, values[src], 0.0)


def host_rows(values, num_data: int, device) -> torch.Tensor:
    """(num_data,) f32 on ``device`` from host rows (or a tensor); the
    copy to the card is pinned and asynchronous, so no sync.
    ``num_data`` counts every value: N * K for K classes."""
    if isinstance(values, torch.Tensor):
        t = values.to(device=device, dtype=torch.float32).reshape(-1)
    else:
        t = torch.from_numpy(np.array(values, dtype=np.float32).reshape(-1))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
    if t.numel() != num_data:
        raise ValueError(f"expected {num_data} rows, got {t.numel()}")
    return t


class GBDT:
    """Gradient Boosting Decision Tree engine (reference: gbdt.cpp)."""

    # DART and RF train every iteration eagerly
    eager_engine = False

    def __init__(self, config: Config, train_data: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction], device):
        self.config = config
        self.device = torch.device(device)
        self.train_data = train_data
        self.objective = objective
        self.models: List[Tree] = []
        # per tree: its bin-space node arrays and f32 shrunk leaf values
        # on the device (None for an init model's trees)
        self.device_trees: List[Optional[Dict[str, Any]]] = []
        self.average_output = False
        self.iter = 0
        self.shrinkage_rate = float(config.learning_rate)
        self.num_class = max(int(config.num_class), 1)
        self.num_tree_per_iteration = K = (
            objective.num_model_per_iteration if objective is not None
            else self.num_class)
        self.init_scores = [0.0] * K
        self.max_feature_idx = 0
        self.feature_names: List[str] = []
        self.label_idx = 0
        self.train_metrics = []
        # (dataset, metrics, (N_valid, G) uint8 or uint16 bins on the device)
        self.valid_sets: List[Tuple[BinnedDataset, list, torch.Tensor]] = []
        # (N_valid,) scores, (K, N_valid) for K classes
        self.valid_scores: List[torch.Tensor] = []
        # linear trees: each validation set's raw f32 rows on the device
        self._valid_raw: List[Optional[torch.Tensor]] = []
        self.linear = False
        self._continued = False        # set by continue_from
        self._phys: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        # K > 1: the (K, N) class scores in original row order
        self._class_scores: Optional[torch.Tensor] = None
        if train_data is not None:
            self._setup_training(train_data)

    # ------------------------------------------------------------------
    def _setup_training(self, train_data: BinnedDataset) -> None:
        cfg = self.config
        dev = self.device
        self.num_data = N = train_data.num_data
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        obj = self.objective
        if obj is not None:
            obj.init(train_data.metadata, dev)
        payload = obj.payload() if obj is not None else []
        self._setup_linear(train_data)
        self._payload_names = [n for n, _ in payload]
        self._setup_quant(len(payload))
        rows = 4 + len(payload) + (2 if self._renew_rows else 0)
        if rows > GHI_ROWS:
            raise NotImplementedError(
                f"the payload holds {GHI_ROWS} rows; objective "
                f"{obj.name} with quantized leaf renewal needs {rows}")
        self.learner = SerialTreeLearner(train_data, cfg, dev,
                                         payload_rows=rows)
        self.train_metrics = create_metrics(cfg, obj.name if obj else None)
        for m in self.train_metrics:
            m.init(train_data.metadata, dev)
        K = self.num_tree_per_iteration
        md = train_data.metadata
        if md.init_score is not None:
            # K classes: N * K values, class-major as the JAX package
            # reads them
            scores = host_rows(md.init_score, N * K, dev).reshape(K, N)
        else:
            scores = torch.zeros((K, N), dtype=torch.float32, device=dev)
            if obj is not None and cfg.boost_from_average:
                for k in range(K):
                    s = obj.boost_from_score(k)
                    if abs(s) > K_EPSILON:
                        self.init_scores[k] = s
                        scores[k] = scores[k] + s
                        log.info("Start training from score %f", s)
        if K > 1:
            self._class_scores = scores
        # the physical carrier adopts the learner's master bin buffer: the
        # partition permutes it in place, iteration after iteration
        lr = self.learner
        C, Npad = lr.row0, lr.N_pad
        ghi = torch.zeros((GHI_ROWS, Npad), dtype=torch.float32, device=dev)
        iota = torch.arange(Npad, device=dev, dtype=torch.int32)
        rowid = torch.where((iota >= C) & (iota < C + N), iota - C, N)
        ghi[2] = rowid.to(torch.int32).view(torch.float32)
        if K == 1:
            ghi[3, C:C + N] = scores[0]
        for i, (_, arr) in enumerate(payload):
            ghi[4 + i, C:C + N] = arr
        self._phys = (lr.part0, ghi)
        lr.part0 = None
        self._setup_sampling(train_data)
        self._renew_alpha = obj.renew_leaf_alpha if obj is not None else None
        # quantized, the JAX package takes its eager iteration for
        # multiclass, the renewing objectives and the objectives it does
        # not fuse: the port samples and discretizes as that one draws
        self._eager_quant = self.use_quant and (
            K > 1 or obj is None or self._renew_alpha is not None
            or not obj.reference_fused)
        # the eager iteration (see module doc), where the JAX package
        # takes it: asked for, DART and RF, GOSS with a renewing objective
        # (its in-bag rows are the eager mask's), linear trees, and
        # quantized as above
        self._eager = (self.eager_engine or not cfg.tpu_fused_iteration
                       or (self.goss and self._renew_alpha is not None)
                       or self._eager_quant or self.linear)
        if self.linear:
            log.info("fused single-program iteration DISABLED (linear_tree): "
                     "each iteration pays per-dispatch host latency")
        # K classes bag as the JAX package's fused multiclass program
        # draws (boosting.py _setup_fused_multiclass: one uniform draw by
        # row id, as the binary one); GOSS, balanced bagging and custom
        # objectives as its eager iteration draws, which they take there
        self._class_fused_draw = (K > 1 and obj is not None
                                  and not self.goss
                                  and not self.balanced_bagging
                                  and not self.use_quant
                                  and not self._eager)

    def _setup_linear(self, train_data: BinnedDataset) -> None:
        """Linear trees (``linear_tree``; see models/linear.py): the train
        rows' raw f32 matrix on the device and the leaves' widest path
        D."""
        cfg = self.config
        self.linear = bool(cfg.linear_tree)
        self._raw = None
        self._lin = None
        self._lin_delta = None
        self.last_linear_status = None
        if not self.linear:
            return
        if train_data.raw_data is None:
            raise ValueError("linear_tree needs the raw train rows: "
                             "construct the Dataset with linear_tree in "
                             "its params")
        self._raw = torch.as_tensor(train_data.raw_data, device=self.device)
        self._lin_D = linmod.width(train_data.num_total_features,
                                   int(cfg.num_leaves), int(cfg.max_depth))

    def _linear_leaves(self, ghi) -> torch.Tensor:
        """The finished tree's linear leaves on the device, before its
        host read: from the leafwise search's rows (``linear_tree_mode``
        leafwise_gain) or by the refit of models/linear.py on the true
        gradients in the payload; and each train row's linear output, f32
        in the physical order.  Returns them packed for the host: per
        leaf the constant, the fit's status, D coefficients and D feature
        ids (-1 where inactive), f64."""
        lr, N = self.learner, self.num_data
        C = lr.row0
        start, cnt = linmod.leaf_ranges(lr.leafmat, C, N)
        rowid = ghi[2, C:C + N].view(torch.int32).long()
        value = lr.leafmat[LM_VALUE, :lr.L]
        shr = self.shrinkage_rate
        rawp = linmod.physical_rows(self._raw, rowid)
        if lr.linear_gain:
            lin = linmod.from_leafwise(*lr.leaf_linear(), value, shr)
        else:
            gr, hr = self._renew_rows if self.use_quant else (0, 1)
            feat, ok = linmod.path_features(
                lr.leafmat, lr.nodemat, lr.steps[0, SB_S],
                self.train_data.num_total_features, self._lin_D)
            lin = linmod.fit_leaves(
                rawp, start, cnt, ghi[gr, C:C + N], ghi[hr, C:C + N], feat,
                ok, value, lam=float(self.config.linear_lambda),
                shrinkage=shr)
        self._lin = lin
        self._lin_delta = linmod.tile_output(rawp, start, cnt, lin,
                                             N).float()
        return linmod.pack(lin)

    def _setup_quant(self, fields: int) -> None:
        """Quantized training's state (JAX boosting.py ``GBDT.__init__``
        and ``_setup_fused_phys``): the eager iteration's key chain
        ``quant_rng``, the fused one's key, the (2,) bound of |grad| and
        |hess| the discretizer reads, and the payload rows of the true
        gradients with ``quant_train_renew_leaf``."""
        cfg = self.config
        self.use_quant = bool(cfg.use_quantized_grad)
        self._renew_rows = None
        if not self.use_quant:
            return
        seed = cfg.seed if cfg.seed is not None else 12345
        self.quant_rng = jrandom.PRNGKey(seed)
        self._q_key = jrandom.PRNGKey(seed)
        self._q_absmax = torch.zeros(2, dtype=torch.float32,
                                     device=self.device)
        # the true gradients ride two payload rows for the renewal and
        # for the linear leaves' fit (JAX fits on ``gk_true``)
        if cfg.quant_train_renew_leaf or self.linear:
            self._renew_rows = (4 + fields, 5 + fields)

    def _setup_sampling(self, train_data: BinnedDataset) -> None:
        """Row and feature sampling as the JAX package sets it up
        (boosting.py ``GBDT.__init__`` and ``_setup_fused_phys``): GOSS,
        bagging, balanced bagging by the label sign, and the host rngs of
        the eager draws and of the feature mask.  The fused draw's
        fractions, period and GOSS counts are frozen here, as JAX freezes
        them when it compiles its fused step; a later ``reset_parameter``
        reaches only the eager draws and the feature mask, there as in
        JAX."""
        cfg = self.config
        self.bag_rng = jrandom.PRNGKey(cfg.bagging_seed)
        self.feat_rng = jrandom.PRNGKey(cfg.feature_fraction_seed)
        self._bag_key = jrandom.PRNGKey(cfg.bagging_seed)
        self.goss = cfg.data_sample_strategy == "goss"
        self.balanced_bagging = (
            cfg.bagging_freq > 0
            and (cfg.pos_bagging_fraction < 1.0
                 or cfg.neg_bagging_fraction < 1.0)
            and train_data.metadata.label is not None)
        self.need_bagging = (not self.goss and cfg.bagging_freq > 0
                             and (cfg.bagging_fraction < 1.0
                                  or self.balanced_bagging))
        if cfg.bagging_by_query:
            log.warning("bagging_by_query is accepted for config "
                        "compatibility but is not implemented by the "
                        "reference this framework tracks; it is IGNORED")
        self._cached_bag = None
        # the eager draw's in-bag rows in original row order (JAX
        # ``_bag_mask_host``: the bag, or GOSS's kept rows); None for all
        self._bag_mask = None
        self._sign_row = None
        if self.need_bagging and self.balanced_bagging:
            names = self._payload_names
            for n in ("label", "signed_label_weight"):
                if n in names:
                    self._sign_row = 4 + names.index(n)
                    break
        N = self.num_data
        self._goss_k = (max(int(N * cfg.top_rate), 1),
                        max(int(N * cfg.other_rate), 1))
        self._bag_freq = max(int(cfg.bagging_freq), 1)
        self._bag_frac = float(cfg.bagging_fraction)
        self._pos_frac = float(cfg.pos_bagging_fraction)
        self._neg_frac = float(cfg.neg_bagging_fraction)
        # the mask last written into the learner's device mask (all ones
        # at build); rewritten only when this iteration's differs
        self._fmask_set = np.ones(self.learner.F, dtype=bool)

    # -- train scores in original row order ------------------------------
    @property
    def scores(self) -> torch.Tensor:
        """(N,) train scores, (N, K) for K classes (a view)."""
        if self._class_scores is not None:
            return self._class_scores.T
        return scores_from_phys(self._phys[1], self.num_data)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One iteration, fused or eager (see module doc); returns True
        when the tree is a stump (no split met the requirements).
        ``grad`` / ``hess`` (a custom objective's, in original row order;
        for K classes (N, K), or N * K values class-major) replace the
        objective's."""
        if self.num_tree_per_iteration > 1:
            return self._train_classes(grad, hess)
        pb, ghi = self._phys
        lr = self.learner
        N = self.num_data
        obj = self.objective
        custom = grad is not None and hess is not None
        if custom:
            g, h = (host_rows(v, N, self.device) for v in (grad, hess))
        elif obj is None:
            raise ValueError("objective=none needs gradients: pass fobj "
                             "to Booster.update or grad and hess")
        elif self._eager or not hasattr(obj, "gradients_from_payload"):
            # ranking: gradients from the scores in original row order,
            # then the custom-gradient route, as JAX's eager iteration
            g, h = self._gradients(ghi)
        else:
            self._payload_gradients(ghi, ghi[3])
            g = h = None
        eager = g is not None
        if eager:
            # the eager iteration's draws, in original row order
            g, h = self._sample_eager(g, h)
            ghi[0] = rows_to_phys(ghi, g, N)
            ghi[1] = rows_to_phys(ghi, h, N)
        else:
            self._sample_fused(ghi)
        if self.use_quant:
            self._quantize(ghi, eager)
        mask = self._feature_mask()
        if not np.array_equal(mask, self._fmask_set):
            lr.set_feature_mask(mask)
            self._fmask_set = mask
        renew = self._renew_alpha is not None and not custom
        rec = lr.build_tree(pb, ghi, self._before_read(ghi, renew))
        num_nodes = int(rec["s"])
        dt = self._device_record(rec)
        ghi[3, lr.row0:lr.row0 + N] += (self._lin_delta if self.linear
                                        else self._row_deltas(dt["delta"]))
        self._append_tree(rec, num_nodes, 0, dt)
        if self.valid_sets:
            self._tree_to_scores(len(self.models) - 1, 1.0, train=False)
        self.iter += 1
        if num_nodes == 0:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
        return num_nodes == 0

    def _gradients(self, ghi):
        """The objective's (grad, hess) at the train scores in original
        row order: (N,) each, or (K, N) for K classes.  From the payload
        (rows 0 and 1 written in the physical order, then scattered
        back), or for an objective without payload gradients (ranking)
        from the scores in original row order."""
        obj, N = self.objective, self.num_data
        if self.num_tree_per_iteration > 1:
            return obj.class_gradients(self._class_scores)
        if not hasattr(obj, "gradients_from_payload"):
            return obj.get_gradients(scores_from_phys(ghi, N))
        self._payload_gradients(ghi, ghi[3])
        return scores_from_phys(ghi, N, 0), scores_from_phys(ghi, N, 1)

    def _payload_gradients(self, ghi, score) -> None:
        """Payload rows 0 and 1 := the objective's grad and hess at the
        physically ordered ``score`` row (0 on pad rows)."""
        N = self.num_data
        vf = (ghi[2].view(torch.int32) != N).to(torch.float32)
        payload = [ghi[4 + i] for i in range(len(self._payload_names))]
        g, h = self.objective.gradients_from_payload(score, *payload)
        ghi[0] = g * vf
        ghi[1] = h * vf

    def _before_read(self, ghi, renew: bool):
        """The device work on a finished tree before its host read: the
        quantized leaf renewal, then the L1 family's (JAX boosting.py
        orders them so; a leaf with no in-bag row then keeps the tree's
        own value, as JAX's eager renewal starts from the record's);
        None when there is none."""
        quant = (self._renew_rows is not None
                 and bool(self.config.quant_train_renew_leaf))
        if not quant and not renew and not self.linear:
            return None

        def run():
            lr = self.learner
            if quant or renew:
                tree_values = lr.leafmat[LM_VALUE, :lr.L].clone()
            if quant:
                self._renew_quant(ghi)
            if renew:
                self._renew(ghi, tree_values)
            if self.linear:
                return self._linear_leaves(ghi)
            return None
        return run

    def _quantize(self, ghi, eager: bool) -> None:
        """Discretize payload rows 0 and 1 into integer carriers and the
        learner's scale word (ops/quantize.py), with the JAX package's draw:
        its fused iteration's key ``fold_in(PRNGKey(seed), iter + 1)`` at
        the physical position, or (``eager``) the next split of
        ``quant_rng`` at the original row id, where sampling also turns
        off the constant-hessian shortcut (boosting.py
        ``_discretize_gradients``)."""
        cfg, obj = self.config, self.objective
        torch.amax(ghi[:2].abs(), dim=1, out=self._q_absmax)
        const_h = obj is not None and obj.is_constant_hessian
        keys = None
        if eager:
            const_h = const_h and not (self.goss or self.need_bagging)
            if cfg.stochastic_rounding:
                self.quant_rng, sub = jrandom.split(self.quant_rng)
                keys = jrandom.split(sub)
        elif cfg.stochastic_rounding:
            keys = jrandom.split(jrandom.fold_in(self._q_key, self.iter + 1))
        quantize(ghi, self._q_absmax, self.learner.qscale, N=self.num_data,
                 bins=int(cfg.num_grad_quant_bins), const_h=const_h,
                 keys=keys, by_rowid=eager, renew_rows=self._renew_rows)

    def _renew_quant(self, ghi) -> None:
        """Quantized leaf renewal (JAX boosting.py ``_quant_renew_device``;
        reference: RenewIntGradTreeOutput): each leaf of a tree with a
        split gets the output of its rows' true grad and hess sums, read
        from the renewal rows after the partition -- f64 prefix
        differences at the leaf ranges, rounded to f32 once."""
        lr, N, cfg = self.learner, self.num_data, self.config
        C = lr.row0
        lm = lr.leafmat[:, :lr.L]
        start, cnt = linmod.leaf_ranges(lr.leafmat, C, N)
        end = (start + cnt).clamp(0, N)
        sums = []
        for r in self._renew_rows:
            # one row at a time: a 1-D cumulative sum is one device-wide
            # scan on the card, a (2, N) one a block per row (PERF.md 6)
            cs = torch.nn.functional.pad(
                torch.cumsum(ghi[r, C:C + N].double(), 0), (1, 0))
            sums.append((cs[end] - cs[start]).float())
        new = leaf_output(sums[0], sums[1] + 2e-15, float(cfg.lambda_l1),
                          float(cfg.lambda_l2), float(cfg.max_delta_step))
        # leaf 1 has a parent once the tree has split (a stump keeps its
        # value, as in the JAX package)
        split = lm[LM_PARENT, 1].view(torch.int32) >= 0
        lm[LM_VALUE] = torch.where((cnt > 0) & split, new, lm[LM_VALUE])

    def _append_tree(self, rec, num_nodes: int, k: int, dt) -> None:
        """The host tree of record ``rec`` into the model list, the
        class's boost-from-average folded into its first tree (into the
        host tree only, as the JAX package folds it), and its device
        record ``dt`` beside it."""
        tree = tree_from_device_record(rec, num_nodes,
                                       self.train_data.bin_mappers,
                                       shrinkage=self.shrinkage_rate)
        if "extra" in rec:
            self.last_linear_status = linmod.unpack(tree, rec["extra"])
        init = self.init_scores[k]
        if len(self.models) < self.num_tree_per_iteration and \
                abs(init) > K_EPSILON:
            if num_nodes > 0:
                tree.leaf_value = tree.leaf_value + init
                tree.internal_value = tree.internal_value + init
                if tree.is_linear:
                    tree.leaf_const = tree.leaf_const + init
            else:
                tree.leaf_value = np.asarray([init])
                if tree.is_linear:
                    tree.leaf_const = np.asarray([init])
        self.models.append(tree)
        self.device_trees.append(dt)

    def _train_classes(self, grad, hess) -> bool:
        """One iteration of K class trees: all K classes' gradients from
        the (K, N) scores before it (or the custom objective's), one bag
        and one feature mask for the K trees, each class's grad and hess
        gathered into payload rows 0 and 1, and its shrunk leaf values
        scattered back into its score row (JAX boosting.py
        ``_setup_fused_multiclass`` and the eager iteration's class
        loop)."""
        pb, ghi = self._phys
        lr, N, K = self.learner, self.num_data, self.num_tree_per_iteration
        fused_draw = self._class_fused_draw and grad is None
        if grad is None or hess is None:
            if self.objective is None:
                raise ValueError("objective=none needs gradients: pass fobj "
                                 "to Booster.update or grad and hess")
            g, h = self._gradients(ghi)
        else:
            g, h = (self._class_rows(v) for v in (grad, hess))
        if not fused_draw:
            g, h = self._sample_eager(g, h)
        mask = self._feature_mask()
        if not np.array_equal(mask, self._fmask_set):
            lr.set_feature_mask(mask)
            self._fmask_set = mask
        stop = True
        C = lr.row0
        for k in range(K):
            ghi[0] = rows_to_phys(ghi, g[k], N)
            ghi[1] = rows_to_phys(ghi, h[k], N)
            if fused_draw:
                self._sample_fused(ghi)
            if self.use_quant:
                self._quantize(ghi, True)
            rec = lr.build_tree(pb, ghi, self._before_read(ghi, False))
            num_nodes = int(rec["s"])
            stop = stop and num_nodes == 0
            dt = self._device_record(rec)
            rowid = ghi[2, C:C + N].view(torch.int32).long()
            self._class_scores[k, rowid] += (
                self._lin_delta if self.linear
                else self._row_deltas(dt["delta"]))
            self._append_tree(rec, num_nodes, k, dt)
            if self.valid_sets:
                self._tree_to_scores(len(self.models) - 1, 1.0, train=False)
        self.iter += 1
        if stop:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
        return stop

    def _class_rows(self, values) -> torch.Tensor:
        """A custom objective's (N, K) values, or N * K class-major, as
        (K, N) on the device."""
        N, K = self.num_data, self.num_tree_per_iteration
        if np.ndim(values) == 2:
            values = (values.T.contiguous() if isinstance(values, torch.Tensor)
                      else np.asarray(values, np.float32).T.copy())
        return host_rows(values, N * K, self.device).reshape(K, N)

    def _renew(self, ghi, old) -> None:
        """Renew the tree's leaf values in leafmat on the device, before
        its host read (see models/renew.py): the percentile of label -
        score over each leaf's in-bag rows, the payload's rows after the
        partition; a leaf with no in-bag row gets its value in ``old``."""
        lr, N = self.learner, self.num_data
        C = lr.row0
        names = self._payload_names
        label = ghi[4 + names.index("label"), C:C + N]
        weight = (ghi[4 + names.index("weight"), C:C + N]
                  if "weight" in names else None)
        w = self.objective.renew_weights_from_payload(label, weight)
        lm = lr.leafmat[:, :lr.L]
        lm[LM_VALUE] = renew_leaves(
            lm[LM_START].view(torch.int32) - C, lm[LM_CNT].view(torch.int32),
            old, label - ghi[3, C:C + N],
            self._in_bag(ghi[:, C:C + N]), w, self._renew_alpha)

    def _in_bag(self, ghi) -> torch.Tensor:
        """(N,) bool: the rows of the iteration's bag, by the fused draw
        at each row's id (``_sample_fused``), or the eager draw's mask at
        it (the bag or GOSS's kept rows, ``_sample_eager``) where the
        iteration drew eagerly."""
        if self._eager and self._bag_mask is not None:
            return self._bag_mask[ghi[2].view(torch.int32).long()]
        if self._eager or not self.need_bagging:
            return torch.ones(ghi.shape[1], dtype=torch.bool,
                              device=ghi.device)
        key = jrandom.fold_in(self._bag_key, self.iter // self._bag_freq)
        u = jrandom.torch_uniform_at(key, ghi[2].view(torch.int32).long())
        if self.balanced_bagging:
            return torch.where(ghi[self._sign_row] > 0,
                               u < np.float32(self._pos_frac),
                               u < np.float32(self._neg_frac))
        return u < np.float32(self._bag_frac)

    # -- sampling ----------------------------------------------------------
    def _sample_fused(self, ghi) -> None:
        """The JAX fused iteration's in-program sampling (boosting.py
        ``_setup_fused_phys``, seed = iter + 1) as one pass of
        ops/sample.py over the payload; the count goes to the learner's
        device word ``bag``, N without sampling."""
        lr, N = self.learner, self.num_data
        seed = self.iter + 1
        if self.goss:
            top_k, other_k = self._goss_k
            thr, n_top = goss_threshold(ghi, N, top_k)
            sample(ghi, lr.bag, MODE_GOSS, N=N,
                   key=jrandom.fold_in(self._bag_key, seed), thr=thr,
                   n_top=n_top, other_k=other_k,
                   mult=(N - top_k) / other_k)
        elif self.need_bagging:
            period = (seed - 1) // self._bag_freq
            key = jrandom.fold_in(self._bag_key, period)
            if self.balanced_bagging:
                if self._sign_row is None:
                    raise NotImplementedError(
                        "balanced bagging needs the objective's label row "
                        "in the payload")
                sample(ghi, lr.bag, MODE_BALANCED, N=N, key=key,
                       pos_frac=self._pos_frac, neg_frac=self._neg_frac,
                       sign_row=self._sign_row)
            else:
                sample(ghi, lr.bag, MODE_BAG, N=N, key=key,
                       frac=self._bag_frac)
        else:
            lr.bag.fill_(N)

    def _sample_eager(self, grad, hess):
        """Sampling of a custom objective's gradients (original row order),
        as the JAX package's eager iteration draws it (boosting.py
        ``_bagging_mask``, ``_goss_sample``): the bag redrawn every
        ``bagging_freq`` iterations from ``bag_rng`` -- an exact count by a
        permutation, or balanced by the label -- and GOSS from a fresh
        split of ``bag_rng`` each iteration.  Writes the count into the
        learner's ``bag`` word; returns the masked or scaled (grad, hess)."""
        lr, cfg, N = self.learner, self.config, self.num_data
        dev = grad.device
        if self.goss:
            top_k = max(int(N * cfg.top_rate), 1)
            other_k = max(int(N * cfg.other_rate), 1)
            imp = (grad * hess).abs()
            if imp.dim() == 2:      # K classes: the sum over the classes
                imp = imp.sum(0)
            thr = torch.topk(imp, top_k, sorted=False).values.min()
            top = imp >= thr
            self.bag_rng, sub = jrandom.split(self.bag_rng)
            rest = torch.clamp_min(N - top.sum(), 1).to(torch.float32)
            prob = torch.tensor(np.float32(other_k), device=dev) / rest
            u = jrandom.torch_uniform_at(sub, torch.arange(N, device=dev))
            keep = ~top & (u < prob)
            mult = torch.tensor(np.float32((N - top_k) / other_k),
                                device=dev)
            scale = torch.where(top, 1.0, torch.where(keep, mult, 0.0))
            self._bag_mask = top | keep
            lr.bag.copy_(self._bag_mask.sum().to(torch.int32).reshape(1))
            return grad * scale, hess * scale
        if not self.need_bagging:
            lr.bag.fill_(N)
            return grad, hess
        if self.iter % cfg.bagging_freq == 0 or self._cached_bag is None:
            self.bag_rng, sub = jrandom.split(self.bag_rng)
            if self.balanced_bagging:
                label = torch.as_tensor(self.train_data.metadata.label,
                                        device=dev)
                u = jrandom.torch_uniform_at(sub, torch.arange(N,
                                                               device=dev))
                mask = torch.where(label > 0,
                                   u < np.float32(cfg.pos_bagging_fraction),
                                   u < np.float32(cfg.neg_bagging_fraction))
                cnt = torch.clamp_min(mask.sum(), 1).to(torch.int32)
            else:
                k = max(int(N * cfg.bagging_fraction), 1)
                mask = torch.zeros(N, dtype=torch.bool, device=dev)
                mask[jrandom.torch_permutation(sub, N, dev)[:k]] = True
                cnt = torch.tensor(k, dtype=torch.int32, device=dev)
            self._cached_bag = (mask, cnt.reshape(1))
        mask, cnt = self._cached_bag
        self._bag_mask = mask
        lr.bag.copy_(cnt)
        return torch.where(mask, grad, 0.0), torch.where(mask, hess, 0.0)

    def _feature_mask(self) -> np.ndarray:
        """This iteration's (F,) feature mask (JAX boosting.py
        ``_feature_mask``): with ``feature_fraction`` < 1, a fresh split of
        ``feat_rng`` and the first ``max(int(F * fraction), 1)`` of its
        permutation of the used features; all ones otherwise."""
        frac = float(self.config.feature_fraction)
        F = self.learner.F
        if frac >= 1.0 or F <= 1:
            return np.ones(F, dtype=bool)
        k = max(int(F * frac), 1)
        self.feat_rng, sub = jrandom.split(self.feat_rng)
        mask = np.zeros(F, dtype=bool)
        mask[jrandom.permutation(sub, F)[:k]] = True
        return mask

    def _row_deltas(self, delta: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """(N,) the shrunk value of each physical row's leaf, from the
        tree the learner keeps on the device (no host sync): the L leafmat
        columns in the order of their starts, each value (of ``delta``,
        else ``_leaf_deltas()``) repeated over its count (columns of no
        leaf have count 0)."""
        lr = self.learner
        if delta is None:
            delta = self._leaf_deltas()
        lm = lr.leafmat[:, :lr.L]
        starts = lm[LM_START].view(torch.int32)
        order = torch.argsort(starts, stable=True)
        cnts = lm[LM_CNT].view(torch.int32)[order].long()
        return torch.repeat_interleave(delta[order], cnts,
                                       output_size=self.num_data)

    def _leaf_deltas(self) -> torch.Tensor:
        """The tree's f32 shrunk leaf values, on the device (a new
        tensor: leafmat is the next tree's)."""
        lr = self.learner
        return lr.leafmat[LM_VALUE, :lr.L] * self.shrinkage_rate

    def _device_record(self, rec) -> Dict[str, Any]:
        """The device record of the tree just grown (JAX
        ``device_trees``): the bin-space node arrays of its host record
        ``rec`` and its f32 shrunk leaf values; the walk's depth and
        packed node matrix are added at its first walk."""
        dt = {"node": self.learner.node_arrays_for_predict(rec),
              "delta": self._leaf_deltas()}
        if self.linear:
            dt["lin"] = self._lin
        return dt

    def _tree_to_scores(self, t: int, factor: float, train: bool = True,
                        valid: bool = True) -> None:
        """Add past tree ``t``'s f32 shrunk leaf values times ``factor``
        (an f32 product, as the JAX package multiplies by a Python
        float) to the train scores and / or each validation set's (JAX
        boosting.py ``_traverse_train``, ``DART._add_tree_to_scores``).
        The train rows' leaves come from a walk of the learner's live
        physical bin matrix, in the order of payload row 3 (K classes:
        scattered into class ``t % K``'s row by payload row 2's ids); the
        validation sets' from their bin matrices.  Nothing is read
        back."""
        dt = self.device_trees[t]
        node = dt["node"]
        if "depth" not in dt:
            dt["depth"] = tree_depth(node["left"], node["right"])
            dt["packed"] = (pack_binned_nodes(node, self.device)
                            if node["num_nodes"] else None)
        depth, packed = dt["depth"], dt["packed"]
        delta = dt["delta"] if factor == 1.0 else dt["delta"] * factor
        lin = dt.get("lin")

        def values(leaf, raw, rows=None):
            # a linear tree's rows: their linear output, f32 (JAX
            # ``_linear_tree_deltas``), times the factor
            if lin is None:
                return delta[leaf]
            out = linmod.linear_output(raw, leaf, lin, rows=rows).float()
            return out if factor == 1.0 else out * factor

        K = self.num_tree_per_iteration
        k = t % K
        if train:
            lr, N = self.learner, self.num_data
            pb, ghi = self._phys
            C = lr.row0
            leaf = predict_leaf_binned_t(pb[:, C:C + N], node, depth, packed)
            rowid = ghi[2, C:C + N].view(torch.int32).long()
            d = values(leaf, self._raw, rowid)
            if K == 1:
                ghi[3, C:C + N] += d
            else:
                self._class_scores[k, rowid] += d
        if not valid:
            return
        for vi, (_, _, binned) in enumerate(self.valid_sets):
            leaf = predict_leaf_binned(binned, node, depth, packed)
            d = values(leaf, self._valid_raw[vi])
            if K > 1:
                self.valid_scores[vi][k] += d
            else:
                self.valid_scores[vi] += d

    def rollback_one_iter(self) -> None:
        """Take the last iteration's K trees out of the train and
        validation scores and the model (JAX boosting.py
        ``rollback_one_iter``; reference: gbdt.cpp RollbackOneIter); an
        init model's trees stay."""
        if self.iter <= 0:
            return
        K = self.num_tree_per_iteration
        if any(self.device_trees[-k] is None for k in range(1, K + 1)):
            log.warning("cannot roll back past the init_model boundary "
                        "(loaded trees have no device arrays)")
            return
        for _ in range(K):
            t = len(self.models) - 1
            tree = self.models[t]
            if tree.is_linear:
                # its rows' outputs again from the host tree, the first
                # iteration's folded init score taken out (JAX
                # ``rollback_one_iter``)
                init = self.init_scores[t % K]
                adj = init if t < K and abs(init) > K_EPSILON else 0.0
                self.device_trees[t]["lin"] = linmod.from_tree(
                    tree, self.device, adj)
            self._tree_to_scores(t, -1.0)
            self.device_trees.pop()
            self.models.pop()
        self.iter -= 1

    def add_valid_data(self, valid_data: BinnedDataset,
                       extra_score=None) -> None:
        """A validation set binned by the training set's mappers; its
        scores start at its init_score, else the booster's init score,
        plus ``extra_score`` (a continued booster's init model)."""
        dev = self.device
        metrics = create_metrics(
            self.config, self.objective.name if self.objective else None)
        for m in metrics:
            m.init(valid_data.metadata, dev)
        n, K = valid_data.num_data, self.num_tree_per_iteration
        md = valid_data.metadata
        if md.init_score is not None:
            score = host_rows(md.init_score, n * K, dev).reshape(K, n)
        else:
            score = torch.zeros((K, n), dtype=torch.float32, device=dev)
            for k in range(K):
                if abs(self.init_scores[k]) > K_EPSILON:
                    score[k] = score[k] + self.init_scores[k]
        if extra_score is not None:
            # the init model's raw prediction, (n,) or (n, K)
            extra = np.asarray(extra_score, np.float32).reshape(n, K).T
            score = score + host_rows(extra.copy(), n * K, dev).reshape(K, n)
        elif self._continued:
            raise ValueError("validation sets added to a continued booster "
                             "need the init model's predictions "
                             "(Booster.add_valid computes them)")
        binned = torch.as_tensor(valid_data.binned, device=dev)
        raw = None
        if self.linear:
            if valid_data.raw_data is None:
                raise ValueError("linear_tree needs a validation set's raw "
                                 "rows: construct it with linear_tree in "
                                 "its params")
            raw = torch.as_tensor(valid_data.raw_data, device=dev)
        self._valid_raw.append(raw)
        self.valid_sets.append((valid_data, metrics, binned))
        self.valid_scores.append(score[0] if K == 1 else score)

    def continue_from(self, trees, train_pred) -> None:
        """Continued training from a loaded model (JAX boosting.py
        continue_from): ``trees`` head the model list, and the train
        scores become the dataset's init_score plus ``train_pred`` (the
        init model's raw prediction of the raw train rows, in original
        row order), written into the physical score row."""
        if self.models:
            raise ValueError("continue_from requires a fresh booster")
        N, K = self.num_data, self.num_tree_per_iteration
        self.models = [copy.deepcopy(t) for t in trees]
        self.device_trees = [None] * len(self.models)
        self.iter = len(self.models) // K
        self._continued = True
        # the loaded model's boost-from-average sits in its first trees
        self.init_scores = [0.0] * K
        md = self.train_data.metadata
        base = (np.zeros((K, N), np.float32) if md.init_score is None
                else np.asarray(md.init_score, np.float32).reshape(K, N))
        pred = np.asarray(train_pred, np.float32).reshape(N, K).T
        scores = host_rows(base + pred, N * K, self.device).reshape(K, N)
        if K > 1:
            self._class_scores = scores
            return
        ghi = self._phys[1]
        ghi[3] = rows_to_phys(ghi, scores[0], N)

    def eval_train(self) -> List[Tuple[str, float, bool]]:
        sc = self.scores
        return [(name, val, m.is_max_better) for m in self.train_metrics
                for name, val in m.eval(sc, self.objective)]

    def valid_score(self, vi: int) -> torch.Tensor:
        """Validation set ``vi``'s (n,) scores, (n, K) for K classes."""
        sc = self.valid_scores[vi]
        return sc.T if self.num_tree_per_iteration > 1 else sc

    def eval_valid(self, vi: int = 0) -> List[Tuple[str, float, bool]]:
        if vi >= len(self.valid_sets):
            return []
        _, metrics, _ = self.valid_sets[vi]
        sc = self.valid_score(vi)
        return [(name, val, m.is_max_better) for m in metrics
                for name, val in m.eval(sc, self.objective)]

    def num_trees(self) -> int:
        return len(self.models)

    @property
    def current_iteration(self) -> int:
        return self.iter

    # ------------------------------------------------------------------
    def _leaves(self, data: np.ndarray, start_iteration: int,
                num_iteration: int):
        """The trees of iterations [start, start + num) (all from start
        when num <= 0), K a class-major iteration, and each one's (n,)
        leaf index on the device, every tree walked in threshold-index
        space."""
        data = np.asarray(data, dtype=np.float64)
        K = self.num_tree_per_iteration
        total = len(self.models) // K
        end = total if num_iteration <= 0 else min(
            total, start_iteration + num_iteration)
        trees = self.models[start_iteration * K:max(end, start_iteration)
                            * K]
        tix = ThresholdIndex(trees)
        packed = tix.pack_values(data, self.device)
        cats = (tix.pack_categories(data, self.device)
                if tix.cat_features else None)
        return trees, [predict_leaf_thridx(packed, tix.nodes(t), cats)
                       for t in trees]

    def predict_raw(self, data: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
        """Raw scores (f64 sums of the trees' leaf values) on the device:
        (n,), or (n, K) for K classes; with ``average_output`` (RF) the
        sums over the iterations taken, divided by their count."""
        K = self.num_tree_per_iteration
        out = torch.zeros((np.shape(data)[0], K), dtype=torch.float64,
                          device=self.device)
        trees, leaves = self._leaves(data, start_iteration, num_iteration)
        raw = None
        for i, (tree, leaf) in enumerate(zip(trees, leaves)):
            if tree.is_linear:
                # f64 linear leaves over the raw values (JAX tree.py
                # ``_linear_output``)
                if raw is None:
                    raw = torch.as_tensor(np.asarray(data, np.float64),
                                          device=self.device)
                out[:, i % K] += linmod.linear_output(
                    raw, leaf, linmod.from_tree(tree, self.device))
                continue
            lv = torch.as_tensor(tree.leaf_value, dtype=torch.float64,
                                 device=self.device)
            out[:, i % K] += lv[leaf]
        out = out.cpu().numpy()
        if self.average_output and trees:
            out /= len(trees) // K
        return out[:, 0] if K == 1 else out

    def predict_leaf_index(self, data: np.ndarray, start_iteration: int = 0,
                           num_iteration: int = -1) -> np.ndarray:
        """(n, trees) int32 leaf index per row and tree."""
        _, leaves = self._leaves(data, start_iteration, num_iteration)
        if not leaves:
            return np.zeros((np.shape(data)[0], 0), np.int32)
        return torch.stack(leaves, 1).to(torch.int32).cpu().numpy()

    def predict(self, data: np.ndarray, raw_score: bool = False,
                **kw) -> np.ndarray:
        raw = self.predict_raw(data, **kw)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(torch.as_tensor(raw)).numpy()


class DART(GBDT):
    """DART boosting (JAX boosting.py ``DART``; reference: dart.hpp): each
    iteration drops some earlier iterations' trees from the train scores,
    grows its tree at the shrinkage that leaves room for them, and scales
    the dropped trees by k / (k + 1) (k / (k + learning_rate) in
    ``xgboost_dart_mode``).  The drops are drawn on the host by
    ``drop_rng``, in the JAX package's order."""

    eager_engine = True

    def __init__(self, config: Config, train_data: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction], device):
        if config.linear_tree:
            log.fatal("Cannot use linear tree with DART boosting "
                      "(reference: config.cpp linear_tree checks)")
        super().__init__(config, train_data, objective, device)
        self.drop_rng = np.random.RandomState(config.drop_seed)
        # one weight per iteration this booster trained (dart.hpp)
        self.tree_weights: List[float] = []
        self.sum_weight = 0.0
        # iterations below this one came from an init model: never dropped
        self.init_iters = 0
        # the iterations the last iteration dropped
        self.last_drops: List[int] = []

    def continue_from(self, trees, train_pred) -> None:
        super().continue_from(trees, train_pred)
        self.init_iters = self.iter

    def _drops(self) -> List[int]:
        """This iteration's dropped iterations (JAX ``DART.train_one_iter``;
        reference: dart.hpp DroppingTrees): skipped with probability
        ``skip_drop``, else a Bernoulli draw per droppable iteration at
        ``drop_rate`` (weighted by the tree's weight over the average
        unless ``uniform_drop``), at most ``max_drop`` of them."""
        cfg = self.config
        n = len(self.models) // self.num_tree_per_iteration - self.init_iters
        drops: List[int] = []
        if n <= 0 or self.drop_rng.rand() < cfg.skip_drop:
            return drops
        rate, max_drop = float(cfg.drop_rate), int(cfg.max_drop)
        if cfg.uniform_drop:
            if max_drop > 0:
                rate = min(rate, max_drop / n)
            probs = [rate] * n
        else:
            inv_avg = (len(self.tree_weights) / self.sum_weight
                       if self.sum_weight > 0 else 0.0)
            if max_drop > 0 and self.sum_weight > 0:
                rate = min(rate, max_drop * inv_avg / self.sum_weight)
            probs = [rate * w * inv_avg for w in self.tree_weights[:n]]
        for i, p in enumerate(probs):
            if self.drop_rng.rand() < p:
                drops.append(self.init_iters + i)
                if max_drop > 0 and len(drops) >= max_drop:
                    break
        return drops

    def train_one_iter(self, grad=None, hess=None) -> bool:
        cfg = self.config
        K = self.num_tree_per_iteration
        drops = self._drops()
        k_drop = len(drops)
        # the dropped trees leave the train scores only; the validation
        # scores are corrected by the normalisation
        for it in drops:
            for k in range(K):
                self._tree_to_scores(it * K + k, -1.0, valid=False)
        base_lr = float(cfg.learning_rate)
        if cfg.xgboost_dart_mode:
            self.shrinkage_rate = (base_lr if k_drop == 0
                                   else base_lr / (base_lr + k_drop))
        else:
            self.shrinkage_rate = base_lr / (1.0 + k_drop)
        stop = super().train_one_iter(grad, hess)
        if k_drop > 0:
            kf = float(k_drop)
            final = (kf / (kf + base_lr) if cfg.xgboost_dart_mode
                     else kf / (kf + 1.0))
            for it in drops:
                for k in range(K):
                    t = it * K + k
                    self._tree_to_scores(t, final, valid=False)
                    self._tree_to_scores(t, final - 1.0, train=False)
                    self._scale_tree(t, final)
                if not cfg.uniform_drop:
                    self.tree_weights[it - self.init_iters] *= final
            if not cfg.uniform_drop:
                self.sum_weight = sum(self.tree_weights)
        if not cfg.uniform_drop:
            self.tree_weights.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        self.last_drops = drops
        return stop

    def rollback_one_iter(self) -> None:
        n = len(self.models)
        super().rollback_one_iter()
        if (len(self.models) < n and not self.config.uniform_drop
                and self.tree_weights):
            self.sum_weight -= self.tree_weights.pop()

    def _scale_tree(self, t: int, factor: float) -> None:
        """Tree ``t`` times ``factor``: the host tree's values in f64, its
        device record's in f32 (JAX ``DART._scale_tree``)."""
        tree = self.models[t]
        tree.leaf_value = tree.leaf_value * factor
        tree.internal_value = tree.internal_value * factor
        dt = self.device_trees[t]
        dt["delta"] = dt["delta"] * factor


class RF(GBDT):
    """Random forest (JAX boosting.py ``RF``; reference: rf.hpp): every
    tree grown at shrinkage 1 from the gradients at the init score, taken
    once, with the eager draws; the train scores keep the running sum, as
    the JAX package's do, and predictions average the iterations."""

    eager_engine = True

    def __init__(self, config: Config, train_data: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction], device):
        if config.bagging_freq <= 0 or config.bagging_fraction >= 1.0:
            if config.feature_fraction >= 1.0:
                log.fatal("Random forest mode requires bagging "
                          "(bagging_freq > 0 and bagging_fraction < 1) or "
                          "feature_fraction < 1")
        super().__init__(config, train_data, objective, device)
        self.average_output = True
        self.shrinkage_rate = 1.0
        self._base_grad = None

    def _gradients(self, ghi):
        """The gradients at the init score (``init_scores``, 0 with a
        dataset init_score), computed at the first iteration and kept: the
        same f32 values as the JAX package's ``get_gradients(base)``."""
        if self._base_grad is None:
            obj, N, K = self.objective, self.num_data, \
                self.num_tree_per_iteration
            if K > 1:
                base = torch.zeros((K, N), dtype=torch.float32,
                                   device=self.device)
                for k in range(K):
                    if abs(self.init_scores[k]) > K_EPSILON:
                        base[k] = base[k] + self.init_scores[k]
                self._base_grad = obj.class_gradients(base)
            elif not hasattr(obj, "gradients_from_payload"):
                self._base_grad = obj.get_gradients(torch.full(
                    (N,), self.init_scores[0], dtype=torch.float32,
                    device=self.device))
            else:
                self._payload_gradients(
                    ghi, torch.full_like(ghi[3], self.init_scores[0]))
                self._base_grad = (scores_from_phys(ghi, N, 0),
                                   scores_from_phys(ghi, N, 1))
        return self._base_grad


def create_boosting(config: Config, train_data: Optional[BinnedDataset],
                    objective: Optional[ObjectiveFunction], device) -> GBDT:
    """The engine of ``config.boosting`` (JAX boosting.py
    ``create_boosting``; reference: Boosting::CreateBoosting)."""
    engines = {"gbdt": GBDT, "dart": DART, "rf": RF}
    if config.boosting not in engines:
        log.fatal("Unknown boosting type %s", config.boosting)
    return engines[config.boosting](config, train_data, objective, device)
