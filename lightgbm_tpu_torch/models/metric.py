"""Evaluation metrics of the slice: binary_logloss, auc, l2, rmse.

Port of lightgbm_tpu/models/metric.py.  Pointwise losses are f32
PyTorch on the scores' device, reduced to a Python float; AUC runs on
the host in float64 (the tie-aware sorted cumulative sums of the
reference's AUCMetric::Eval).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
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


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def point_loss(self, pred, label):
        p = torch.clamp(pred, K_EPSILON, 1.0 - K_EPSILON)
        return -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))


def weighted_auc(score: np.ndarray, label: np.ndarray,
                 weight: Optional[np.ndarray]) -> float:
    """Tie-aware weighted AUC in float64 (reference: AUCMetric::Eval)."""
    s = np.asarray(score, np.float64)
    order = np.argsort(-s, kind="stable")
    s = s[order]
    y = np.asarray(label, np.float64)[order]
    w = (np.ones_like(s) if weight is None
         else np.asarray(weight, np.float64)[order])
    tp = np.cumsum(w * (y > 0))
    fp = np.cumsum(w * (y <= 0))
    is_end = np.append(s[1:] != s[:-1], True)
    tp_e, fp_e = tp[is_end], fp[is_end]
    prev_tp = np.concatenate([[0.0], tp_e[:-1]])
    prev_fp = np.concatenate([[0.0], fp_e[:-1]])
    area = float(np.sum((fp_e - prev_fp) * (tp_e + prev_tp) * 0.5))
    total_p, total_n = tp[-1], fp[-1]
    if total_p > 0 and total_n > 0:
        return area / (total_p * total_n)
    return 1.0


class AUCMetric(Metric):
    name = "auc"
    is_max_better = True

    def eval(self, score, objective):
        return [(self.name, weighted_auc(
            score.detach().cpu().numpy(), self.metadata.label,
            self.metadata.weight))]


_METRICS = {"l2": L2Metric, "rmse": RMSEMetric,
            "binary_logloss": BinaryLoglossMetric, "auc": AUCMetric}
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
