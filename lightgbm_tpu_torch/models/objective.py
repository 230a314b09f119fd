"""Objective functions: every pointwise objective and multiclass.

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
original row order (``class_gradients``).
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
