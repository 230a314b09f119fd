"""Python API of the port: ``Dataset`` and ``Booster``.

Port of the slice's surface of lightgbm_tpu/basic.py: a ``Dataset``
over an all-numerical matrix, and a ``Booster`` that trains
(``update``), predicts, and writes / reads the reference's model text
(``model_to_string``, ``save_model``, ``_load_model_string``) -- the same
text the JAX package writes and reads.  Training and prediction run on
``Config.torch_device()``: the card unless ``device_type='cpu'``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .dataset import BinnedDataset
from .models.boosting import GBDT
from .models.objective import create_objective
from .models.tree import Tree
from .utils import log
from .utils.log import LightGBMError


def _to_matrix(data) -> np.ndarray:
    if isinstance(data, str):
        raise NotImplementedError(
            "lightgbm_tpu_torch does not load data files yet; pass a matrix")
    if hasattr(data, "to_numpy"):
        data = data.to_numpy()
    mat = np.asarray(data)
    if mat.dtype == object or not np.issubdtype(mat.dtype, np.number):
        raise NotImplementedError(
            "lightgbm_tpu_torch trains all-numerical matrices only")
    return mat


class Dataset:
    """Training data wrapper (reference: basic.py Dataset); binning runs
    lazily at ``construct`` so params from ``train()`` still apply."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        if group is not None:
            raise NotImplementedError(
                "lightgbm_tpu_torch does not support group (ranking) yet")
        if isinstance(categorical_feature, (list, tuple)) and \
                categorical_feature:
            raise NotImplementedError(
                "lightgbm_tpu_torch does not support categorical_feature yet")
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.params = dict(params) if params else {}
        self._inner: Optional[BinnedDataset] = None

    def construct(self, extra_params: Optional[Dict[str, Any]] = None
                  ) -> "Dataset":
        if self._inner is not None:
            return self
        params = dict(extra_params or {})
        params.update(self.params)
        cfg = Config(params)
        cfg.check_supported()
        names = None
        if isinstance(self.feature_name, list):
            names = list(self.feature_name)
        elif hasattr(self.data, "columns"):
            names = [str(c) for c in self.data.columns]
        ref = None
        if self.reference is not None:
            ref = self.reference.construct(extra_params)._inner
        self._inner = BinnedDataset.from_matrix(
            _to_matrix(self.data), cfg, label=self.label, weight=self.weight,
            init_score=self.init_score, feature_names=names, reference=ref)
        return self

    def num_data(self) -> int:
        return (self._inner.num_data if self._inner is not None
                else _to_matrix(self.data).shape[0])

    def num_feature(self) -> int:
        return (self._inner.num_total_features if self._inner is not None
                else _to_matrix(self.data).shape[1])

    def get_label(self):
        return None if self.label is None else np.asarray(self.label)


class Booster:
    """Booster (reference: basic.py Booster)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.config = Config(self.params)
        self.train_set = train_set
        self.best_iteration = -1
        self._gbdt: Optional[GBDT] = None
        if train_set is not None:
            self.config.check_supported()
            device = self.config.torch_device()
            train_set.construct(self.params)
            self._gbdt = GBDT(self.config, train_set._inner,
                              create_objective(self.config), device)
        elif model_file is not None:
            with open(model_file) as fh:
                self._load_model_string(fh.read())
        elif model_str is not None:
            self._load_model_string(model_str)
        else:
            log.fatal("Booster requires train_set, model_file or model_str")

    # ------------------------------------------------------------------
    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when no further split was possible."""
        if fobj is not None:
            raise NotImplementedError(
                "lightgbm_tpu_torch does not support custom objectives yet")
        return self._gbdt.train_one_iter()

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def eval_train(self, feval=None):
        if feval is not None:
            raise NotImplementedError(
                "lightgbm_tpu_torch does not support feval yet")
        return [("training", name, val, is_max)
                for name, val, is_max in self._gbdt.eval_train()]

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs) -> np.ndarray:
        if pred_leaf or pred_contrib:
            raise NotImplementedError(
                "lightgbm_tpu_torch predicts raw and converted scores only")
        if num_iteration is None or num_iteration == 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        mat = np.asarray(_to_matrix(data), dtype=np.float64)
        if mat.ndim == 1:
            mat = mat.reshape(1, -1)
        if mat.shape[1] != self.num_feature():
            raise LightGBMError(
                f"The number of features in data ({mat.shape[1]}) is not "
                f"the same as it was in training data ({self.num_feature()})")
        return self._gbdt.predict(mat, raw_score=raw_score,
                                  start_iteration=start_iteration,
                                  num_iteration=num_iteration)

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        g = self._gbdt
        out = np.zeros(g.max_feature_idx + 1, dtype=np.float64)
        for t in g.models:
            n = t.num_nodes()
            for f, gain in zip(t.split_feature[:n], t.split_gain[:n]):
                out[int(f)] += 1.0 if importance_type == "split" else gain
        return out

    # ------------------------------------------------------------------
    def model_to_string(self, num_iteration: int = -1,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        """reference: GBDT::SaveModelToString (gbdt_model_text.cpp)."""
        g = self._gbdt
        lines = ["tree", "version=v4", f"num_class={g.num_class}",
                 f"num_tree_per_iteration={g.num_tree_per_iteration}",
                 f"label_index={g.label_idx}",
                 f"max_feature_idx={g.max_feature_idx}"]
        if g.objective is not None:
            lines.append(f"objective={g.objective.to_string()}")
        lines.append("feature_names=" + " ".join(g.feature_names))
        infos = ([bm.feature_info() for bm in g.train_data.bin_mappers]
                 if g.train_data is not None else [])
        lines.append("feature_infos=" + " ".join(infos))
        total = len(g.models)
        end = total if num_iteration < 0 else min(
            total, start_iteration + num_iteration)
        tree_strs = [g.models[i].to_string(i - start_iteration)
                     for i in range(start_iteration, end)]
        lines.append("tree_sizes=" + " ".join(str(len(s) + 1)
                                              for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n" + "\n".join(tree_strs)
        body += "end of trees\n"
        imp_type = ("gain" if int(self.config.saved_feature_importance_type
                                  or 0) == 1 else "split")
        imp = self.feature_importance(imp_type)
        pairs = sorted(((imp[i], g.feature_names[i]) for i in range(len(imp))
                        if imp[i] > 0), key=lambda x: -x[0])
        body += "\nfeature_importances:\n"
        for v, n in pairs:
            body += (f"{n}={int(v)}\n" if imp_type == "split"
                     else f"{n}={float(v):g}\n")
        body += ("\nparameters:\n" + self.config.save_to_string()
                 + "\nend of parameters\n")
        return body

    def save_model(self, filename: str, num_iteration: int = -1,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration,
                                          importance_type))
        return self

    def _load_model_string(self, text: str) -> None:
        """reference: GBDT::LoadModelFromString.  The model's saved
        params are restored, except ``device_type``: a loaded model
        predicts on the device this Booster's own params ask for."""
        header: Dict[str, str] = {}
        for line in text.split("\n"):
            line = line.strip()
            if line.startswith("Tree="):
                break
            if "=" in line:
                k, v = line.split("=", 1)
                header[k.strip()] = v.strip()
        saved: Dict[str, Any] = {}
        if "\nparameters:" in text:
            psec = text.split("\nparameters:", 1)[1]
            for pline in psec.split("end of parameters", 1)[0].split("\n"):
                pline = pline.strip()
                if pline.startswith("[") and pline.endswith("]") \
                        and ":" in pline:
                    k, v = pline[1:-1].split(":", 1)
                    saved[k.strip()] = v.strip()
        saved.pop("task", None)
        saved.pop("device_type", None)
        saved["objective"] = header.get(
            "objective", saved.get("objective", "regression")).split(" ")[0]
        saved["num_class"] = int(header.get("num_class", 1))
        if int(header.get("num_tree_per_iteration", 1)) != 1 or \
                "average_output" in header:
            raise NotImplementedError(
                "lightgbm_tpu_torch loads single-output GBDT models only")
        device = self.config.torch_device()
        saved.update({k: v for k, v in self.params.items()
                      if Config.canonical_name(k) == "device_type"})
        self.config = Config(saved)
        g = GBDT(self.config, None, create_objective(self.config), device)
        g.label_idx = int(header.get("label_index", 0))
        g.max_feature_idx = int(header.get("max_feature_idx", 0))
        g.feature_names = header.get("feature_names", "").split()
        for blk in text.split("Tree=")[1:]:
            g.models.append(Tree.from_string(
                "Tree=" + blk.split("end of trees")[0]))
        g.iter = len(g.models)
        self._gbdt = g
