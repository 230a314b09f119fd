"""Objective functions: every pointwise objective, multiclass and ranking.

Port of lightgbm_tpu/models/objective.py (the regression family, binary,
cross-entropy, multiclass softmax and one-vs-all, ``create_objective``,
boost-from-average).  A pointwise objective's gradients are elementwise
f32 PyTorch on the training device, computed in the physical row order
of the fused iteration from the payload rows named by
``payload_fields`` (models/boosting.py).  The L1 family
(``regression_l1``, ``quantile``, ``mape``) renews each leaf's value to
a percentile of its rows' residuals after the tree
(``renew_leaf_alpha``; models/renew.py).  The multiclass objectives
compute all K classes' gradients at once from the (K, N) scores in
original row order (``class_gradients``).  The ranking objectives
(``lambdarank``, ``rank_xendcg``) compute each query bucket's lambdas in
plain PyTorch from the scores in original row order (``get_gradients``),
as the JAX package computes them in XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..dataset import Metadata
from ..utils import log
from ..utils import random as jrandom

K_EPSILON = 1e-15


class ObjectiveFunction:
    """Base objective (reference: include/LightGBM/objective_function.h)."""

    name = "custom"
    num_model_per_iteration = 1
    # L1-family leaf renewal: the percentile of the residuals a leaf's
    # value is renewed to after the tree, None for no renewal
    renew_leaf_alpha: Optional[float] = None
    # row-aligned attribute tensors the gradients read; they ride the
    # partition payload (rows 4.. of part_ghi)
    payload_fields = ()
    # every hessian is one (JAX ``is_constant_hessian``): quantized
    # training then makes every integer hessian 1
    is_constant_hessian = False
    # the JAX package's fused physical-order iteration runs this objective
    # (its concrete class defines gradients_from_payload); where it does
    # not, the JAX package samples and quantizes in its eager iteration,
    # and with quantized gradients the port draws as that iteration does
    reference_fused = True

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.num_data = 0

    def init(self, metadata: Metadata, device) -> None:
        self.num_data = metadata.num_data
        if metadata.label is None:
            log.fatal("Label should not be None for objective %s", self.name)
        self.label = torch.as_tensor(metadata.label, dtype=torch.float32,
                                     device=device)
        self.weight = (torch.as_tensor(metadata.weight, dtype=torch.float32,
                                       device=device)
                       if metadata.weight is not None else None)

    def payload(self):
        """(name, tensor) of the payload rows in order, absent ones skipped."""
        return [(n, getattr(self, n)) for n in self.payload_fields
                if getattr(self, n) is not None]

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw):
        return raw

    def renew_weights_from_payload(self, label, weight):
        """The weights of the renewal's percentile, from the payload."""
        return weight

    def to_string(self) -> str:
        return self.name

    def _mean_label(self) -> float:
        if self.weight is not None:
            return float(torch.sum(self.label * self.weight)
                         / torch.sum(self.weight))
        return float(torch.mean(self.label))


def _weighted(grad, hess, weight):
    if weight is not None:
        return grad * weight, hess * weight
    return grad, hess


class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp RegressionL2loss."""
    name = "regression"
    payload_fields = ("label", "weight")
    is_constant_hessian = True

    def __init__(self, config: Config):
        super().__init__(config)
        if bool(config.reg_sqrt):
            raise NotImplementedError(
                "lightgbm_tpu_torch does not support reg_sqrt yet")

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        if self.weight is not None:
            self.is_constant_hessian = False

    def gradients_from_payload(self, score, label, weight=None):
        return _weighted(score - label, torch.ones_like(score), weight)

    def boost_from_score(self, class_id):
        return self._mean_label()


class _L1Family(ObjectiveFunction):
    """Objectives whose leaves are renewed (JAX ``is_renew_tree_output``);
    the frontier keeps payload row 7, so two payload rows at most."""
    payload_fields = ("label", "weight")

    def _label_percentile(self, weights, alpha) -> float:
        return weighted_percentile_host(
            self.label.cpu().numpy(),
            None if weights is None else weights.cpu().numpy(), alpha)


class RegressionL1(_L1Family, RegressionL2):
    """reference: regression_objective.hpp RegressionL1loss."""
    name = "regression_l1"
    renew_leaf_alpha = 0.5

    def gradients_from_payload(self, score, label, weight=None):
        return _weighted(torch.sign(score - label), torch.ones_like(score),
                         weight)

    def boost_from_score(self, class_id):
        return self._label_percentile(self.weight, 0.5)


class RegressionHuber(RegressionL2):
    """reference: regression_objective.hpp RegressionHuberLoss."""
    name = "huber"
    reference_fused = False

    def __init__(self, config: Config):
        super().__init__(config)
        self.alpha = float(config.alpha)

    def gradients_from_payload(self, score, label, weight=None):
        diff = score - label
        grad = torch.where(torch.abs(diff) <= self.alpha, diff,
                           torch.sign(diff) * self.alpha)
        return _weighted(grad, torch.ones_like(score), weight)


class RegressionFair(ObjectiveFunction):
    """reference: regression_objective.hpp RegressionFairLoss."""
    name = "fair"
    payload_fields = ("label", "weight")
    reference_fused = False

    def __init__(self, config: Config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def gradients_from_payload(self, score, label, weight=None):
        x = score - label
        ax = torch.abs(x)
        grad = self.c * x / (ax + self.c)
        hess = self.c * self.c / ((ax + self.c) ** 2)
        return _weighted(grad, hess, weight)


class RegressionPoisson(ObjectiveFunction):
    """reference: regression_objective.hpp RegressionPoissonLoss."""
    name = "poisson"
    payload_fields = ("label", "weight")

    def __init__(self, config: Config):
        super().__init__(config)
        self.max_delta_step = float(config.poisson_max_delta_step)

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        if float(np.min(np.asarray(metadata.label))) < 0:
            log.fatal("[poisson]: at least one target label is negative")

    def gradients_from_payload(self, score, label, weight=None):
        exp_score = torch.exp(score)
        return _weighted(exp_score - label,
                         exp_score * math.exp(self.max_delta_step), weight)

    def boost_from_score(self, class_id):
        return math.log(max(self._mean_label(), 1e-20))

    def convert_output(self, raw):
        return torch.exp(raw)


class RegressionQuantile(_L1Family):
    """reference: regression_objective.hpp RegressionQuantileloss."""
    name = "quantile"

    def __init__(self, config: Config):
        super().__init__(config)
        self.alpha = self.renew_leaf_alpha = float(config.alpha)

    def gradients_from_payload(self, score, label, weight=None):
        grad = torch.where(score - label >= 0, 1.0 - self.alpha,
                           -self.alpha).to(torch.float32)
        return _weighted(grad, torch.ones_like(score), weight)

    def boost_from_score(self, class_id):
        return self._label_percentile(self.weight, self.alpha)


class RegressionMAPE(_L1Family):
    """reference: regression_objective.hpp RegressionMAPELOSS; the
    renewal's weights are the label weights 1 / max(1, |label|)."""
    name = "mape"
    renew_leaf_alpha = 0.5

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        self.label_weight = self.renew_weights_from_payload(self.label,
                                                            self.weight)

    def renew_weights_from_payload(self, label, weight):
        lw = 1.0 / torch.clamp_min(torch.abs(label), 1.0)
        return lw * weight if weight is not None else lw

    def gradients_from_payload(self, score, label, weight=None):
        lw = self.renew_weights_from_payload(label, weight)
        grad = torch.sign(score - label) * lw
        hess = weight if weight is not None else torch.ones_like(score)
        return grad, hess

    def boost_from_score(self, class_id):
        return self._label_percentile(self.label_weight, 0.5)


class RegressionGamma(RegressionPoisson):
    """reference: regression_objective.hpp RegressionGammaLoss."""
    name = "gamma"

    def gradients_from_payload(self, score, label, weight=None):
        exp_neg = torch.exp(-score)
        return _weighted(1.0 - label * exp_neg, label * exp_neg, weight)


class RegressionTweedie(RegressionPoisson):
    """reference: regression_objective.hpp RegressionTweedieLoss."""
    name = "tweedie"

    def __init__(self, config: Config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def gradients_from_payload(self, score, label, weight=None):
        e1 = torch.exp((1.0 - self.rho) * score)
        e2 = torch.exp((2.0 - self.rho) * score)
        grad = -label * e1 + e2
        hess = -label * (1.0 - self.rho) * e1 + (2.0 - self.rho) * e2
        return _weighted(grad, hess, weight)


class BinaryLogloss(ObjectiveFunction):
    """reference: binary_objective.hpp BinaryLogloss."""
    name = "binary"
    payload_fields = ("signed_label_weight",)

    def __init__(self, config: Config, is_pos=None):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self._is_pos = is_pos or (lambda lbl: lbl > 0)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time")
        self.need_train = True

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        pos = self._is_pos(np.asarray(metadata.label))
        cnt_pos = int(pos.sum())
        cnt_neg = self.num_data - cnt_pos
        self.need_train = cnt_pos > 0 and cnt_neg > 0
        if not self.need_train:
            log.warning("Contains only one class")
        w_neg, w_pos = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        pos_t = torch.as_tensor(pos, device=device)
        self.sign_label = torch.where(pos_t, 1.0, -1.0).to(torch.float32)
        lw = torch.where(pos_t, w_pos, w_neg).to(torch.float32)
        if self.weight is not None:
            lw = lw * self.weight
        # label sign and weight in ONE payload row: sign(slw) is the
        # label sign, |slw| the effective weight
        self.signed_label_weight = self.sign_label * lw

    def gradients_from_payload(self, score, signed_label_weight):
        sign_label = torch.where(signed_label_weight < 0, -1.0, 1.0).to(
            torch.float32)
        lw = torch.abs(signed_label_weight)
        response = (-sign_label * self.sigmoid) / (
            1.0 + torch.exp(sign_label * self.sigmoid * score))
        abs_response = torch.abs(response)
        grad = response * lw
        hess = abs_response * (self.sigmoid - abs_response) * lw
        if not self.need_train:
            return torch.zeros_like(grad), torch.zeros_like(hess)
        return grad, hess

    def boost_from_score(self, class_id):
        pos = (self.sign_label > 0).to(torch.float32)
        if self.weight is not None:
            suml = float(torch.sum(pos * self.weight))
            sumw = float(torch.sum(self.weight))
        else:
            suml = float(torch.sum(pos))
            sumw = float(self.num_data)
        pavg = suml / max(sumw, K_EPSILON)
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        init_score = math.log(pavg / (1.0 - pavg)) / self.sigmoid
        log.info("[binary:BoostFromScore]: pavg=%f -> initscore=%f", pavg,
                 init_score)
        return init_score

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def to_string(self):
        return f"binary sigmoid:{self.sigmoid:g}"


class CrossEntropy(ObjectiveFunction):
    """reference: xentropy_objective.hpp CrossEntropy (labels in [0, 1])."""
    name = "cross_entropy"
    payload_fields = ("label", "weight")

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        lbl = np.asarray(metadata.label)
        if lbl.min() < 0 or lbl.max() > 1:
            log.fatal("[cross_entropy]: label must be in interval [0, 1]")

    def gradients_from_payload(self, score, label, weight=None):
        z = torch.sigmoid(score)
        return _weighted(z - label, z * (1.0 - z), weight)

    def boost_from_score(self, class_id):
        pavg = min(max(self._mean_label(), K_EPSILON), 1.0 - K_EPSILON)
        return math.log(pavg / (1.0 - pavg))

    def convert_output(self, raw):
        return torch.sigmoid(raw)


class CrossEntropyLambda(CrossEntropy):
    """reference: xentropy_objective.hpp CrossEntropyLambda
    (:223-252)."""
    name = "cross_entropy_lambda"
    reference_fused = False

    def init(self, metadata: Metadata, device) -> None:
        ObjectiveFunction.init(self, metadata, device)

    def gradients_from_payload(self, score, label, weight=None):
        w = weight if weight is not None else torch.ones_like(score)
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - label / torch.clamp_min(z, K_EPSILON)) * w / (1.0 + enf)
        c = 1.0 / torch.clamp_min(1.0 - z, K_EPSILON)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / torch.clamp_min(d2 * d2, K_EPSILON)) * (1.0 + w * epf - c)
        return grad, a * (1.0 + label * b)

    def convert_output(self, raw):
        return torch.log1p(torch.exp(raw))


class _Multiclass(ObjectiveFunction):
    """K trees an iteration; the gradients of all K classes come at once
    from the (K, N) scores in original row order (``class_gradients``),
    and nothing rides the payload."""
    reference_fused = False

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = self.num_model_per_iteration = int(config.num_class)

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        lbl = np.asarray(metadata.label).astype(np.int32)
        if lbl.min() < 0 or lbl.max() >= self.num_class:
            log.fatal("Label must be in [0, %d), but found %d in label",
                      self.num_class,
                      int(lbl.min() if lbl.min() < 0 else lbl.max()))
        self.label_int = torch.as_tensor(lbl, device=device).long()


class MulticlassSoftmax(_Multiclass):
    """reference: multiclass_objective.hpp MulticlassSoftmax."""
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.factor = self.num_class / max(self.num_class - 1, 1)

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        lbl = self.label_int.cpu().numpy()
        if metadata.weight is not None:
            w = np.asarray(metadata.weight, dtype=np.float64)
            counts = np.bincount(lbl, weights=w, minlength=self.num_class)
            sum_weight = float(w.sum())
        else:
            counts = np.bincount(lbl, minlength=self.num_class).astype(
                np.float64)
            sum_weight = float(len(lbl))
        self.class_init_probs = counts / max(sum_weight, K_EPSILON)
        self.onehot = torch.nn.functional.one_hot(
            self.label_int, self.num_class).T.to(torch.float32)

    def class_gradients(self, score):
        """(K, N) grad and hess from the (K, N) scores before the
        iteration: the softmax couples the classes."""
        m = torch.max(score, dim=0).values
        e = torch.exp(score - m)
        p = e / torch.sum(e, dim=0)
        grad = p - self.onehot
        hess = self.factor * p * (1.0 - p)
        if self.weight is not None:
            return grad * self.weight, hess * self.weight
        return grad, hess

    def boost_from_score(self, class_id):
        return math.log(max(K_EPSILON, self.class_init_probs[class_id]))

    def convert_output(self, raw):
        return torch.softmax(raw, dim=-1)

    def to_string(self):
        return f"multiclass num_class:{self.num_class}"


class MulticlassOVA(_Multiclass):
    """reference: multiclass_objective.hpp MulticlassOVA: one binary
    logloss a class, its positives the rows of that class."""
    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.binaries = [BinaryLogloss(config, is_pos=_class_is(k))
                         for k in range(self.num_class)]

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        for b in self.binaries:
            b.init(metadata, device)

    def class_gradients(self, score):
        out = [b.gradients_from_payload(score[k], b.signed_label_weight)
               for k, b in enumerate(self.binaries)]
        return (torch.stack([g for g, _ in out]),
                torch.stack([h for _, h in out]))

    def boost_from_score(self, class_id):
        return self.binaries[class_id].boost_from_score(0)

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def to_string(self):
        return (f"multiclassova num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid:g}")


def _class_is(k):
    return lambda lbl: lbl == k


# ---------------------------------------------------------------------------
# Ranking (reference: src/objective/rank_objective.hpp)
# ---------------------------------------------------------------------------
def query_buckets(query_boundaries):
    """Queries bucketed by their size padded to a power of two, at least
    2 (JAX ``LambdarankNDCG.init``): ``[(P, queries, doc_idx)]`` in
    increasing P, ``doc_idx`` the (Q_b, P) int32 row of each query's
    documents, -1 in the padding."""
    qb = np.asarray(query_boundaries)
    sizes = np.diff(qb)
    by_p = {}
    for q, sz in enumerate(sizes):
        p = 1
        while p < sz:
            p <<= 1
        by_p.setdefault(max(p, 2), []).append(q)
    out = []
    for p, qs in sorted(by_p.items()):
        qs = np.asarray(qs)
        doc_idx = np.full((len(qs), p), -1, dtype=np.int32)
        cols = np.arange(p)
        mask = cols[None, :] < sizes[qs][:, None]
        doc_idx[mask] = (qb[qs][:, None] + cols[None, :])[mask]
        out.append((p, qs, doc_idx))
    return out


# the (P, P) f32 temporaries a query's pairwise lambdas hold at once, and
# the bytes a chunk of queries may take (JAX vmaps a whole bucket: on the
# card a 2,048-wide bucket of thousands of queries would not fit)
PAIR_TEMPS = 20
PAIR_BUDGET = 1 << 30


class QueryBucket:
    """One bucket's queries (``qs``) on the device, in chunks of at most
    ``PAIR_BUDGET`` bytes of pairwise temporaries (one chunk unless
    ``pairwise``): each chunk's (Q, P) document rows (``idx``, padding
    at row 0), valid mask, and the flat positions ``sel`` of its valid
    slots with their rows ``rows``, so results scatter back with no host
    sync."""

    def __init__(self, P, qs, doc_idx, device, pairwise):
        self.P, self.qs = P, qs
        step = (max(1, PAIR_BUDGET // (PAIR_TEMPS * P * P * 4)) if pairwise
                else len(doc_idx))
        self.chunks = []
        for lo in range(0, len(doc_idx), step):
            d = doc_idx[lo:lo + step]
            flat = d.reshape(-1)
            sel = np.nonzero(flat >= 0)[0]
            self.chunks.append((
                lo, torch.as_tensor(np.maximum(d, 0).astype(np.int64),
                                    device=device),
                torch.as_tensor(d >= 0, device=device),
                torch.as_tensor(sel, device=device),
                torch.as_tensor(flat[sel].astype(np.int64), device=device)))


def label_gains(config: Config) -> np.ndarray:
    """``label_gain`` as f64 (the reference's default 2^i - 1 for i <
    32)."""
    if config.label_gain:
        return np.asarray([float(x) for x in
                           str(config.label_gain).split(",")])
    return 2.0 ** np.arange(32) - 1.0


class LambdarankNDCG(ObjectiveFunction):
    """LambdaRank with NDCG weighting (reference: rank_objective.hpp
    LambdarankNDCG; JAX models/objective.py ``LambdarankNDCG``): each
    bucket's queries as batched (Q, P, P) f32 pairwise matrices in
    plain PyTorch on the scores' device, in chunks (``QueryBucket``).  The
    gradients read the scores in original row order, so the iteration
    takes the eager route (``reference_fused``): GBDT gathers them into
    the physical order.  With positions, the unbiased variant adds the
    learned per-position bias to the scores and takes a Newton step on
    the biases after each gradient."""

    name = "lambdarank"
    reference_fused = False

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.norm = bool(config.lambdarank_norm)
        self.truncation_level = int(config.lambdarank_truncation_level)
        self.label_gain = label_gains(config)

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        qb = np.asarray(metadata.query_boundaries)
        sizes = np.diff(qb)
        lbl = np.asarray(metadata.label).astype(np.int32)
        if lbl.max() >= len(self.label_gain):
            log.fatal("Label %d exceeds label_gain size %d", int(lbl.max()),
                      len(self.label_gain))
        # per-query inverse max DCG at the truncation level (reference:
        # DCGCalculator::CalMaxDCGAtK)
        gains = self.label_gain[lbl]
        inv_max_dcg = np.zeros(len(sizes), dtype=np.float64)
        for q in range(len(sizes)):
            g = np.sort(gains[qb[q]:qb[q + 1]])[::-1][:self.truncation_level]
            dcg = np.sum(g / np.log2(np.arange(2, len(g) + 2)))
            inv_max_dcg[q] = 1.0 / dcg if dcg > 0 else 0.0
        self.buckets = [QueryBucket(*b, device, pairwise=True)
                        for b in query_buckets(qb)]
        self.inv_max_dcg = [torch.as_tensor(
            inv_max_dcg[b.qs].astype(np.float32), device=device)
            for b in self.buckets]
        self.label_gain_dev = torch.as_tensor(
            self.label_gain.astype(np.float32), device=device)
        self.label_int = torch.as_tensor(lbl, device=device).long()
        # position bias state (reference: rank_objective.hpp:43-56)
        self.positions = None
        if metadata.positions is not None:
            self.positions = torch.as_tensor(metadata.positions,
                                             device=device).long()
            self.pos_biases = torch.zeros(len(metadata.position_ids),
                                          dtype=torch.float32, device=device)
            self.position_bias_regularization = float(
                self.config.lambdarank_position_bias_regularization)
            self.bias_learning_rate = float(self.config.learning_rate)

    def _chunk_lambdas(self, score_all, idx, valid, inv_max_dcg, P):
        """(Q, P) lambdas and hessians in each query's document order
        (JAX ``_bucket_grad_fn``'s ``one_query``, batched)."""
        dev = score_all.device
        score = torch.where(valid, score_all[idx], -math.inf)
        lbl = torch.where(valid, self.label_int[idx], -1)
        # argsort(-score, stable=True): the first iteration's scores all
        # tie, and order-preserving ties decide its lambdas
        order = torch.sort(-score, dim=1, stable=True).indices
        ss = score.gather(1, order)
        sl = lbl.gather(1, order)
        svalid = valid.gather(1, order)
        gains = self.label_gain_dev[torch.clamp_min(sl, 0)]
        pos = torch.arange(P, device=dev)
        discount = 1.0 / torch.log2(2.0 + pos.to(torch.float32))
        upper = ((pos[:, None] < pos[None, :])
                 & (pos[:, None] < self.truncation_level))
        upper = upper & svalid[:, :, None] & svalid[:, None, :]
        li, lj = sl[:, :, None], sl[:, None, :]
        sym = (upper | upper.transpose(1, 2)) & (li != lj)
        del upper
        delta_ndcg = (torch.abs(gains[:, :, None] - gains[:, None, :])
                      * torch.abs(discount[:, None] - discount[None, :])
                      * inv_max_dcg[:, None, None])
        i_is_high = li > lj
        si, sj = ss[:, :, None], ss[:, None, :]
        delta_score = torch.where(i_is_high, si - sj, sj - si)
        if self.norm:
            best = ss[:, 0]
            worst_i = torch.clamp_min(svalid.sum(1) - 1, 0)
            worst = ss.gather(1, worst_i[:, None])[:, 0]
            scale = torch.where((best != worst)[:, None, None],
                                1.0 / (0.01 + torch.abs(delta_score)), 1.0)
            delta_ndcg = delta_ndcg * scale
            del scale
        p_lambda0 = 1.0 / (1.0 + torch.exp(self.sigmoid * delta_score))
        del delta_score
        p_hess0 = p_lambda0 * (1.0 - p_lambda0)
        p_lambda = -self.sigmoid * delta_ndcg * p_lambda0
        p_hess = self.sigmoid * self.sigmoid * delta_ndcg * p_hess0
        del p_lambda0, p_hess0, delta_ndcg
        zero = torch.zeros((), device=dev)
        lam_pair = torch.where(sym, p_lambda, zero)
        lam_sorted = torch.where(i_is_high, lam_pair, -lam_pair).sum(2)
        hes_sorted = torch.where(sym, p_hess, zero).sum(2)
        if self.norm:
            sum_lambdas = -lam_pair.sum((1, 2))
            nf = torch.where(sum_lambdas > 0, torch.log2(1.0 + sum_lambdas)
                             / torch.clamp_min(sum_lambdas, K_EPSILON), 1.0)
            lam_sorted = lam_sorted * nf[:, None]
            hes_sorted = hes_sorted * nf[:, None]
        # unsort back to query-document order
        lam = torch.zeros_like(lam_sorted).scatter_(1, order, lam_sorted)
        hes = torch.zeros_like(hes_sorted).scatter_(1, order, hes_sorted)
        return lam, hes

    def get_gradients(self, score):
        """(N,) f32 grad and hess from the (N,) scores in original row
        order."""
        if self.positions is not None:
            # unbiased lambdarank (reference: rank_objective.hpp:66-71)
            score = score + self.pos_biases[self.positions]
        grad = torch.zeros_like(score)
        hess = torch.zeros_like(score)
        for b, inv in zip(self.buckets, self.inv_max_dcg):
            for lo, idx, valid, sel, rows in b.chunks:
                lam, hes = self._chunk_lambdas(score, idx, valid,
                                               inv[lo:lo + len(idx)], b.P)
                grad[rows] = lam.reshape(-1)[sel]
                hess[rows] = hes.reshape(-1)[sel]
        if self.positions is not None:
            self._update_position_bias(grad, hess)
        return grad, hess

    def _update_position_bias(self, grad, hess):
        """Newton-Raphson step on the per-position bias factors with L2
        regularization (reference: UpdatePositionBiasFactors,
        rank_objective.hpp:290-328)."""
        npos = len(self.pos_biases)
        seg = self.positions
        z = torch.zeros(npos, dtype=torch.float32, device=grad.device)
        first = z.index_add(0, seg, -grad)
        second = z.index_add(0, seg, -hess)
        counts = z.index_add(0, seg, torch.ones_like(grad))
        reg = self.position_bias_regularization
        first = first - self.pos_biases * reg * counts
        second = second - reg * counts
        self.pos_biases = self.pos_biases + \
            self.bias_learning_rate * first / (torch.abs(second) + 0.001)


class RankXENDCG(ObjectiveFunction):
    """XE-NDCG (reference: rank_objective.hpp RankXENDCG; JAX
    models/objective.py ``RankXENDCG``): per query the gradients of a
    softmax cross-entropy against gumbel-perturbed relevance targets.
    Iteration ``i``'s noise for bucket ``b`` is ``jax.random.gumbel`` of
    ``fold_in(fold_in(PRNGKey(objective_seed), i), b)`` over the bucket's
    whole padded (Q_b, P) block, as JAX draws it."""

    name = "rank_xendcg"
    reference_fused = False

    def __init__(self, config: Config):
        super().__init__(config)
        self.seed = int(config.objective_seed)
        self._iter = 0

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        self.buckets = [QueryBucket(*b, device, pairwise=False)
                        for b in query_buckets(metadata.query_boundaries)]

    def get_gradients(self, score):
        self._iter += 1
        key = jrandom.fold_in(jrandom.PRNGKey(self.seed), self._iter)
        grad = torch.zeros_like(score)
        hess = torch.zeros_like(score)
        for bi, b in enumerate(self.buckets):
            (_, idx, valid, sel, rows), = b.chunks
            s = torch.where(valid, score[idx], -math.inf)
            lbl = torch.where(valid, self.label[idx], 0.0)
            eps = jrandom.torch_gumbel(jrandom.fold_in(key, bi), s.shape,
                                       score.device)
            # gumbel-perturbed relevance -> the target distribution
            phi = torch.where(valid, (2.0 ** lbl - 1.0) + eps, -math.inf)
            rho_tgt = torch.where(valid, torch.softmax(phi, dim=1), 0.0)
            rho = torch.where(valid, torch.softmax(s, dim=1), 0.0)
            g = rho - rho_tgt
            h = torch.clamp_min(rho * (1.0 - rho), K_EPSILON)
            grad[rows] = g.reshape(-1)[sel]
            hess[rows] = h.reshape(-1)[sel]
        return grad, hess


def weighted_percentile_host(values: np.ndarray,
                             weights: Optional[np.ndarray],
                             alpha: float) -> float:
    """Percentile matching the reference PercentileFun /
    WeightedPercentileFun (regression_objective.hpp:18-88); a copy of
    the JAX package's ``_weighted_percentile_host``."""
    n = len(values)
    if n == 0:
        return 0.0
    if n == 1:
        return float(values[0])
    if weights is None:
        v = values[np.argsort(values)]
        float_pos = (n - 1) * alpha
        lo = int(math.floor(float_pos))
        bias = float_pos - lo
        if lo + 1 >= n:
            return float(v[-1])
        return float(v[lo] + (v[lo + 1] - v[lo]) * bias)
    order = np.argsort(values, kind="stable")
    v = values[order]
    cdf = np.cumsum(weights[order].astype(np.float64))
    threshold = alpha * cdf[-1]
    pos = min(int(np.searchsorted(cdf, threshold, side="right")), n - 1)
    if pos == 0 or pos == n - 1:
        return float(v[pos])
    v1, v2 = float(v[pos - 1]), float(v[pos])
    if cdf[pos + 1] - cdf[pos] >= 1.0:
        return float((threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos])
                     * (v2 - v1) + v1)
    return v2


_OBJECTIVES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """reference: ObjectiveFunction::CreateObjectiveFunction."""
    name = config.objective
    if name in ("none", "custom", ""):
        return None
    cls = _OBJECTIVES.get(name)
    if cls is None:
        raise NotImplementedError(
            f"lightgbm_tpu_torch does not support objective={name!r} yet")
    return cls(config)
