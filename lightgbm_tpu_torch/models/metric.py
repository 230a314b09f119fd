"""Evaluation metrics: the regression, binary, cross-entropy, multiclass
and ranking metrics of the JAX package, by its names.

Port of lightgbm_tpu/models/metric.py.  Pointwise losses are f32
PyTorch on the scores' device; AUC and average precision sort the
scores and sum in float64 on the scores' device too (the tie-aware
sorted cumulative sums of the reference's AUCMetric::Eval and
AveragePrecisionMetric::Eval).  Each metric reads one float back, but
``auc_mu``, which the JAX package too computes on the host in numpy
float64.  Multiclass metrics take (N, K) scores.  NDCG and MAP sort
each query bucket's scores on the device and read back one (buckets, k)
block of f32 sums an evaluation.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Metadata
from ..utils import log
from .objective import QueryBucket, label_gains, query_buckets

K_EPSILON = 1e-15


class Metric:
    name = "metric"
    is_max_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, device) -> None:
        self.num_data = metadata.num_data
        self.metadata = metadata
        self.label = torch.as_tensor(metadata.label, dtype=torch.float32,
                                     device=device)
        self.weight = (torch.as_tensor(metadata.weight, dtype=torch.float32,
                                       device=device)
                       if metadata.weight is not None else None)

    def eval(self, score, objective) -> List[Tuple[str, float]]:
        raise NotImplementedError


class _PointwiseMetric(Metric):
    """The (weighted) mean of an f32 loss a row, summed in float64."""

    def point_loss(self, pred, label):
        raise NotImplementedError

    def transform(self, value: float) -> float:
        return value

    def eval(self, score, objective):
        pred = objective.convert_output(score) if objective else score
        loss = self.point_loss(pred, self.label)
        f64 = torch.float64
        if self.weight is not None:
            v = float(torch.sum(loss * self.weight, dtype=f64)
                      / torch.clamp_min(torch.sum(self.weight, dtype=f64),
                                        K_EPSILON))
        else:
            v = float(torch.sum(loss, dtype=f64)) / max(loss.numel(), 1)
        return [(self.name, self.transform(v))]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def point_loss(self, pred, label):
        return (pred - label) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def transform(self, value):
        return math.sqrt(value)


class L1Metric(_PointwiseMetric):
    name = "l1"

    def point_loss(self, pred, label):
        return torch.abs(pred - label)


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def point_loss(self, pred, label):
        alpha = float(self.config.alpha)
        delta = label - pred
        return torch.where(delta >= 0, alpha * delta, (alpha - 1.0) * delta)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def point_loss(self, pred, label):
        alpha = float(self.config.alpha)
        diff = pred - label
        return torch.where(torch.abs(diff) <= alpha, 0.5 * diff * diff,
                           alpha * (torch.abs(diff) - 0.5 * alpha))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def point_loss(self, pred, label):
        c = float(self.config.fair_c)
        x = torch.abs(pred - label)
        return c * x - c * c * torch.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def point_loss(self, pred, label):
        return pred - label * torch.log(torch.clamp_min(pred, 1e-10))


class MAPEMetric(_PointwiseMetric):
    name = "mape"

    def point_loss(self, pred, label):
        return torch.abs((label - pred) / torch.clamp_min(torch.abs(label),
                                                          1.0))


class GammaMetric(_PointwiseMetric):
    name = "gamma"

    def point_loss(self, pred, label):
        # psi = 1, so lgamma(1 / psi) = 0 (JAX metric.py GammaMetric)
        theta = -1.0 / torch.clamp_min(pred, 1e-10)
        b = -torch.log(-theta)
        c = torch.log(label) - torch.log(label)
        return -((label * theta - b) + c)


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"

    def point_loss(self, pred, label):
        tmp = label / torch.clamp_min(pred, 1e-9)
        return tmp - torch.log(tmp) - 1.0

    def transform(self, value):
        return value * 2.0


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def point_loss(self, pred, label):
        rho = float(self.config.tweedie_variance_power)
        lp = torch.log(torch.clamp_min(pred, 1e-10))
        a = label * torch.exp((1.0 - rho) * lp) / (1.0 - rho)
        b = torch.exp((2.0 - rho) * lp) / (2.0 - rho)
        return -a + b


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def point_loss(self, pred, label):
        p = torch.clamp(pred, K_EPSILON, 1.0 - K_EPSILON)
        return -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def point_loss(self, pred, label):
        return ((pred > 0.5).to(torch.float32) != label).to(torch.float32)


def _descending(score, label, weight):
    """Scores (f64), labels and weights (f64, ones when None) in
    descending score order, ties in row order."""
    s = score.to(torch.float64)
    order = torch.argsort(s, descending=True, stable=True)
    w = (torch.ones_like(s) if weight is None
         else weight[order].to(torch.float64))
    return s[order], label[order], w


def weighted_auc(score: torch.Tensor, label: torch.Tensor,
                 weight: Optional[torch.Tensor]) -> float:
    """Tie-aware weighted AUC in float64 on the scores' device (reference:
    AUCMetric::Eval): each run of tied scores adds the trapezoid between
    the (fp, tp) sums before and after it."""
    s, y, w = _descending(score, label, weight)
    pos = y > 0
    tp = torch.cumsum(torch.where(pos, w, 0.0), 0)
    fp = torch.cumsum(torch.where(pos, 0.0, w), 0)
    n = s.numel()
    differs = s[1:] != s[:-1]
    true = torch.ones(1, dtype=torch.bool, device=s.device)
    is_start = torch.cat([true, differs])
    is_end = torch.cat([differs, true])
    idx = torch.arange(n, device=s.device)
    # the first row of each row's run of ties, and the sums before it
    first = torch.cummax(torch.where(is_start, idx, 0), 0).values
    zero = torch.zeros(1, dtype=torch.float64, device=s.device)
    prev_tp = torch.cat([zero, tp[:-1]])[first]
    prev_fp = torch.cat([zero, fp[:-1]])[first]
    area = torch.sum(torch.where(is_end, (fp - prev_fp) * (tp + prev_tp)
                                 * 0.5, 0.0))
    total_p, total_n = tp[-1], fp[-1]
    return float(torch.where((total_p > 0) & (total_n > 0),
                             area / (total_p * total_n), 1.0))


class AUCMetric(Metric):
    name = "auc"
    is_max_better = True

    def eval(self, score, objective):
        return [(self.name, weighted_auc(score, self.label, self.weight))]


def weighted_average_precision(score: torch.Tensor, label: torch.Tensor,
                               weight: Optional[torch.Tensor]) -> float:
    """Weighted average precision in float64 on the scores' device: the
    precision at each row of the descending score order, averaged over
    the positives' weight (reference: AveragePrecisionMetric::Eval)."""
    _, y, w = _descending(score, label, weight)
    pos_w = torch.where(y > 0, w, 0.0)
    precision = torch.cumsum(pos_w, 0) / torch.clamp(torch.cumsum(w, 0),
                                                     min=K_EPSILON)
    return float(torch.sum(precision * pos_w)
                 / torch.clamp(torch.sum(pos_w), min=K_EPSILON))


class AveragePrecisionMetric(AUCMetric):
    name = "average_precision"

    def eval(self, score, objective):
        return [(self.name, weighted_average_precision(score, self.label,
                                                       self.weight))]


class CrossEntropyMetric(BinaryLoglossMetric):
    name = "xentropy"


class CrossEntropyLambdaMetric(_PointwiseMetric):
    """The log loss of z = 1 - exp(-log1p(exp(raw))) on raw scores."""
    name = "xentlambda"

    def eval(self, score, objective):
        return super().eval(score, None)

    def point_loss(self, score, label):
        z = 1.0 - torch.exp(-torch.log1p(torch.exp(score)))
        return -(label * torch.log(torch.clamp_min(z, K_EPSILON))
                 + (1.0 - label) * torch.log(torch.clamp_min(1.0 - z,
                                                             K_EPSILON)))


class KLDivMetric(_PointwiseMetric):
    name = "kullback_leibler"

    def point_loss(self, pred, label):
        p = torch.clamp(pred, K_EPSILON, 1.0 - K_EPSILON)
        y = torch.clamp(label, 0.0, 1.0)
        ce = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
        ent = torch.where((y > 0) & (y < 1),
                          -(y * torch.log(y) + (1.0 - y) * torch.log(1.0 - y)),
                          0.0)
        return ce - ent


class _MulticlassMetric(_PointwiseMetric):
    """A pointwise loss of each row's (K,) scores and its class."""

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        self.label_int = self.label.to(torch.int64)


class MultiLoglossMetric(_MulticlassMetric):
    name = "multi_logloss"

    def point_loss(self, pred, label):
        p_true = torch.gather(pred, 1, self.label_int[:, None])[:, 0]
        return -torch.log(torch.clamp_min(p_true, K_EPSILON))


class MultiErrorMetric(_MulticlassMetric):
    """Error when the true class' raw score is not within the top k."""
    name = "multi_error"

    def eval(self, score, objective):
        return super().eval(score, None)

    def point_loss(self, score, label):
        true = torch.gather(score, 1, self.label_int[:, None])
        num_better = torch.sum(score > true, dim=1)
        return (num_better >= int(self.config.multi_error_top_k)).to(
            torch.float32)


class AucMuMetric(Metric):
    """AUC-mu (reference: multiclass_metric.hpp AucMuMetric, Kleiman &
    Page 2019), on the host in numpy float64 as the JAX package computes
    it: the mean over class pairs (i, j) of the AUC of the rows' raw
    scores projected on the difference of the weight rows i and j
    (``auc_mu_weights``, K*K row-major with a zero diagonal; else 1 off
    the diagonal), ties counted half."""
    name = "auc_mu"
    is_max_better = True

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        K = self.K = int(self.config.num_class)
        spec = str(self.config.auc_mu_weights or "").strip()
        if spec:
            vals = [float(v) for v in spec.replace(" ", "").split(",") if v]
            if len(vals) != K * K:
                log.fatal("auc_mu_weights must have %d elements, found %d",
                          K * K, len(vals))
            W = np.asarray(vals, dtype=np.float64).reshape(K, K)
            np.fill_diagonal(W, 0.0)
        else:
            W = 1.0 - np.eye(K)
        self.W = W
        self.label_np = np.asarray(metadata.label).astype(np.int64)
        self.weight_np = (None if metadata.weight is None
                          else np.asarray(metadata.weight, np.float32))

    def eval(self, score, objective):
        score = score.cpu().numpy().astype(np.float64)
        return [(self.name, float(auc_mu(score, self.label_np,
                                         self.weight_np, self.W)))]


def auc_mu(score: np.ndarray, lbl: np.ndarray, w: Optional[np.ndarray],
           W: np.ndarray) -> float:
    """AUC-mu of (N, K) float64 raw scores (JAX metric.py AucMuMetric)."""
    K = W.shape[0]
    total = 0.0
    for i in range(K):
        ii = np.nonzero(lbl == i)[0]
        if len(ii) == 0:
            continue
        for j in range(i + 1, K):
            jj = np.nonzero(lbl == j)[0]
            if len(jj) == 0:
                continue
            v = W[i] - W[j]
            idx = np.concatenate([ii, jj])
            dist = (v[i] - v[j]) * (score[idx] @ v)
            is_i = lbl[idx] == i
            wi = w[idx] if w is not None else np.ones(len(idx))
            order = np.lexsort((~is_i, dist))   # ties: class j first
            d_s, i_s, w_s = dist[order], is_i[order], wi[order]
            wj = np.where(~i_s, w_s, 0.0)
            cum_j = np.concatenate([[0.0], np.cumsum(wj)])[:-1]
            # each run of tied distances counts its class-j weight half
            grp = np.concatenate([[True], np.abs(np.diff(d_s)) > 1e-15])
            gid = np.cumsum(grp) - 1
            grp_j = np.zeros(gid[-1] + 1)
            np.add.at(grp_j, gid, wj)
            start_cum = cum_j[np.nonzero(grp)[0]]
            s_ij = np.sum(np.where(
                i_s, w_s * (start_cum[gid] + 0.5 * grp_j[gid]), 0.0))
            den_i = np.sum(wi[:len(ii)]) if w is not None else len(ii)
            den_j = np.sum(w[jj]) if w is not None else len(jj)
            total += (s_ij / den_i) / den_j
    return (2.0 * total / K) / (K - 1)


# ---------------------------------------------------------------------------
# Ranking metrics (reference: src/metric/rank_metric.hpp, dcg_calculator.cpp)
# ---------------------------------------------------------------------------
class _RankMetric(Metric):
    """Queries bucketed by padded size as the ranking objectives bucket
    them; each bucket's per-``k`` sums are f32 on the scores' device, read
    back once an evaluation and totalled in f64 on the host (JAX
    ``NDCGMetric.eval``)."""
    is_max_better = True

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        if metadata.query_boundaries is None:
            log.fatal("The %s metric requires query information",
                      self.name.upper())
        self.eval_at = list(self.config.eval_at_list) or [1, 2, 3, 4, 5]
        self.num_queries = metadata.num_queries
        self.buckets = [QueryBucket(*b, device, pairwise=False)
                        for b in query_buckets(metadata.query_boundaries)]

    def bucket_sums(self, b, s, idx, valid):
        raise NotImplementedError

    def eval(self, score, objective):
        sums = []
        for b, bucket in enumerate(self.buckets):
            (_, idx, valid, _, _), = bucket.chunks
            sums.append(self.bucket_sums(
                b, torch.where(valid, score[idx], -math.inf), idx, valid))
        totals = (torch.stack(sums).cpu().numpy().astype(np.float64).sum(0)
                  if sums else np.zeros(len(self.eval_at)))
        return [(f"{self.name}@{k}", totals[ki] / self.num_queries)
                for ki, k in enumerate(self.eval_at)]


class NDCGMetric(_RankMetric):
    """NDCG@k (JAX models/metric.py ``NDCGMetric``): 1 for a query whose
    ideal DCG is 0."""
    name = "ndcg"

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        gains = label_gains(self.config)
        qb = np.asarray(metadata.query_boundaries)
        sizes = np.diff(qb)
        gain_of = gains[np.asarray(metadata.label).astype(np.int32)]
        self.idcg = []
        for bucket in self.buckets:
            idcg = np.zeros((len(bucket.qs), len(self.eval_at)))
            for row, q in enumerate(bucket.qs):
                n = sizes[q]
                g_sorted = np.sort(gain_of[qb[q]:qb[q + 1]])[::-1]
                disc = 1.0 / np.log2(np.arange(2, n + 2))
                for ki, k in enumerate(self.eval_at):
                    kk = min(k, n)
                    idcg[row, ki] = np.sum(g_sorted[:kk] * disc[:kk])
            self.idcg.append(torch.as_tensor(idcg.astype(np.float32),
                                             device=device))
        self.gains_dev = torch.as_tensor(gain_of.astype(np.float32),
                                         device=device)

    def bucket_sums(self, b, s, idx, valid):
        P = self.buckets[b].P
        g = torch.where(valid, self.gains_dev[idx], 0.0)
        order = torch.sort(-s, dim=1, stable=True).indices
        g_sorted = g.gather(1, order)
        disc = 1.0 / torch.log2(2.0 + torch.arange(
            P, dtype=torch.float32, device=s.device))
        out = []
        for ki, k in enumerate(self.eval_at):
            kk = min(k, P)
            dcg = torch.sum(g_sorted[:, :kk] * disc[:kk], dim=1)
            idcg = self.idcg[b][:, ki]
            ndcg = torch.where(idcg > 0, dcg / torch.clamp_min(idcg,
                                                               K_EPSILON),
                               1.0)
            out.append(ndcg.sum())
        return torch.stack(out)


class MapMetric(_RankMetric):
    """MAP@k (JAX models/metric.py ``MapMetric``): a document is relevant
    when its label is above 0; the average precision's denominator is
    min(relevant documents, k), at least 1."""
    name = "map"

    def bucket_sums(self, b, s, idx, valid):
        P = self.buckets[b].P
        y = torch.where(valid, self.label[idx] > 0, False)
        order = torch.sort(-s, dim=1, stable=True).indices
        y_sorted = y.gather(1, order).to(torch.float32)
        cum_rel = torch.cumsum(y_sorted, dim=1)
        prec = cum_rel / torch.arange(1, P + 1, dtype=torch.float32,
                                      device=s.device)
        out = []
        for k in self.eval_at:
            kk = min(k, P)
            ap_num = torch.sum(prec[:, :kk] * y_sorted[:, :kk], dim=1)
            denom = torch.clamp(cum_rel[:, -1], max=float(kk)).clamp_min(1.0)
            out.append(torch.sum(ap_num / denom))
        return torch.stack(out)


_METRICS = {
    "l2": L2Metric, "mse": L2Metric, "rmse": RMSEMetric, "l1": L1Metric,
    "mae": L1Metric, "quantile": QuantileMetric, "huber": HuberMetric,
    "fair": FairMetric, "poisson": PoissonMetric, "mape": MAPEMetric,
    "gamma": GammaMetric, "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    "ndcg": NDCGMetric, "map": MapMetric,
    "xentropy": CrossEntropyMetric, "xentlambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivMetric,
}
_DEFAULT_METRIC_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "xentropy", "cross_entropy_lambda": "xentlambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


def create_metrics(config: Config, for_objective: Optional[str] = None):
    """reference: Metric::CreateMetric."""
    names = list(config.metric_list)
    if not names and for_objective:
        names = [_DEFAULT_METRIC_FOR_OBJECTIVE.get(for_objective, "")]
    out = []
    for name in names:
        if name in ("", "custom", "none"):
            continue
        cls = _METRICS.get(name)
        if cls is None:
            raise NotImplementedError(
                f"lightgbm_tpu_torch does not support metric={name!r} yet")
        out.append(cls(config))
    return out
