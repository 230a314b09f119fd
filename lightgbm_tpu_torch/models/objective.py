"""Objective functions of the slice: binary logloss and L2 regression.

Port of lightgbm_tpu/models/objective.py (``BinaryLogloss``,
``RegressionL2``, ``create_objective``, boost-from-average).  Gradients
are elementwise f32 PyTorch on the training device, computed in the
physical row order of the fused iteration from the payload rows named
by ``payload_fields`` (models/boosting.py).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..dataset import Metadata
from ..utils import log

K_EPSILON = 1e-15


class ObjectiveFunction:
    """Base objective (reference: include/LightGBM/objective_function.h)."""

    name = "custom"
    # row-aligned attribute tensors the gradients read; they ride the
    # partition payload (rows 4.. of part_ghi)
    payload_fields = ()

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

    def to_string(self) -> str:
        return self.name


class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp RegressionL2loss."""
    name = "regression"
    payload_fields = ("label", "weight")

    def __init__(self, config: Config):
        super().__init__(config)
        if bool(config.reg_sqrt):
            raise NotImplementedError(
                "lightgbm_tpu_torch does not support reg_sqrt yet")

    def gradients_from_payload(self, score, label, weight=None):
        grad = score - label
        hess = torch.ones_like(score)
        if weight is not None:
            return grad * weight, hess * weight
        return grad, hess

    def boost_from_score(self, class_id):
        if self.weight is not None:
            return float(torch.sum(self.label * self.weight)
                         / torch.sum(self.weight))
        return float(torch.mean(self.label))


class BinaryLogloss(ObjectiveFunction):
    """reference: binary_objective.hpp BinaryLogloss."""
    name = "binary"
    payload_fields = ("signed_label_weight",)

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time")
        self.need_train = True

    def init(self, metadata: Metadata, device) -> None:
        super().init(metadata, device)
        pos = np.asarray(metadata.label) > 0
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


_OBJECTIVES = {"regression": RegressionL2, "binary": BinaryLogloss}


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
