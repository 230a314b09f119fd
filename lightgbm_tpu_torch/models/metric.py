"""Evaluation metrics of the binary and L2 objectives: binary_logloss,
binary_error, auc, average_precision, l2, rmse, l1.

Port of lightgbm_tpu/models/metric.py.  Pointwise losses are f32
PyTorch on the scores' device; AUC and average precision sort the
scores and sum in float64 on the scores' device too (the tie-aware
sorted cumulative sums of the reference's AUCMetric::Eval and
AveragePrecisionMetric::Eval).  Each metric reads one float back.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from ..config import Config
from ..dataset import Metadata

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
    def point_loss(self, pred, label):
        raise NotImplementedError

    def transform(self, value: float) -> float:
        return value

    def eval(self, score, objective):
        pred = objective.convert_output(score) if objective else score
        loss = self.point_loss(pred, self.label)
        if self.weight is not None:
            v = float(torch.sum(loss * self.weight)) / max(
                float(torch.sum(self.weight)), K_EPSILON)
        else:
            v = float(torch.sum(loss)) / max(loss.numel(), 1)
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


_METRICS = {"l2": L2Metric, "rmse": RMSEMetric, "l1": L1Metric,
            "binary_logloss": BinaryLoglossMetric,
            "binary_error": BinaryErrorMetric, "auc": AUCMetric,
            "average_precision": AveragePrecisionMetric}
_DEFAULT_METRIC_FOR_OBJECTIVE = {"regression": "l2",
                                 "binary": "binary_logloss"}


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
