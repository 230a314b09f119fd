"""Python API of the port: ``Dataset`` and ``Booster``.

Port of lightgbm_tpu/basic.py: a ``Dataset`` over a matrix, a pandas
DataFrame or a CSV / TSV / LibSVM file (utils/textio.py), its categorical
columns named by ``categorical_feature`` (ints, names or the config
string) or, for a DataFrame, found by their dtype (category, object,
string and bool columns become integer codes; ``pandas_categorical``
keeps each one's categories, rides the model text and encodes every
later frame -- validation, prediction -- with the training codes), with
``create_valid`` for validation sets binned like the training set, and
for ranking its query groups (``group`` / ``set_group``, a LibSVM file's
``qid:`` runs or a CSV / TSV ``group_column``) and presentation
positions (``position``); a
``Booster`` that trains (``update``, with a custom objective ``fobj`` or
``boost(grad, hess)``; GBDT, DART or random forest by ``boosting``),
rolls the last iteration back (``rollback_one_iter``), evaluates the
training and validation sets (built-in metrics and ``feval``), continues
from a model (``_continue_from``), predicts raw and converted scores and leaf
indices, and writes / reads the reference's model text
(``model_to_string``, ``save_model``, ``_load_model_string``) -- the same
text the JAX package writes and reads.  Training and prediction run on
``Config.torch_device()``: the card unless ``device_type='cpu'``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .dataset import BinnedDataset
from .models.boosting import GBDT, RF, create_boosting
from .models.objective import create_objective
from .models.tree import Tree
from .utils import log
from .utils.log import LightGBMError
from .utils.textio import load_text_file


def _is_cat_dtype(dt: str) -> bool:
    return (dt == "category" or dt in ("object", "bool", "boolean")
            or dt.startswith("str"))


def _dataframe_to_matrix(df, pandas_categorical=None):
    """pandas DataFrame -> (matrix, auto categorical column indices,
    pandas_categorical) (JAX basic.py ``_dataframe_to_matrix``).

    category/object/str/bool dtype columns are encoded as integer codes;
    missing/unseen values become NaN.  The per-column category lists are
    persisted in the model (reference: basic.py _data_from_pandas +
    the `pandas_categorical` model-file line written by the Python
    wrapper) so predict-time frames are mapped with the TRAINING codes."""
    cols = []
    auto_cats = []
    maps_out = []
    cat_i = 0
    for j, name in enumerate(df.columns):
        col = df[name]
        dt = str(col.dtype)
        if not _is_cat_dtype(dt):
            cols.append(np.asarray(col, dtype=np.float64))
            continue
        if pandas_categorical is not None:   # predict: reuse training maps
            if cat_i >= len(pandas_categorical):
                raise ValueError(
                    "DataFrame has more categorical columns than the model "
                    "was trained with")
            lookup = {v: i for i, v in enumerate(pandas_categorical[cat_i])}
            codes = np.array([float(lookup.get(v, -1))
                              for v in col.tolist()], dtype=np.float64)
        elif dt == "category":
            maps_out.append(list(col.cat.categories))
            codes = np.asarray(col.cat.codes, dtype=np.float64)
        else:
            seen: Dict[Any, int] = {}
            vals = col.tolist()
            codes = np.empty(len(vals), dtype=np.float64)
            for i, v in enumerate(vals):
                if v is None or (isinstance(v, float) and np.isnan(v)):
                    codes[i] = -1
                    continue
                if v not in seen:
                    seen[v] = len(seen)
                codes[i] = seen[v]
            maps_out.append(list(seen.keys()))
        cols.append(np.where(codes < 0, np.nan, codes))
        auto_cats.append(j)
        cat_i += 1
    mat = np.column_stack(cols) if cols else np.zeros((len(df), 0))
    if pandas_categorical is None:
        pandas_categorical = maps_out
    return mat, auto_cats, pandas_categorical


def _is_frame(data) -> bool:
    return hasattr(data, "columns") and hasattr(data, "dtypes")


def _to_matrix(data, pandas_categorical=None) -> np.ndarray:
    if isinstance(data, str):
        raise NotImplementedError(
            "lightgbm_tpu_torch reads a file path only as the data of a "
            "Dataset it constructs; pass a matrix")
    if _is_frame(data):
        return _dataframe_to_matrix(data, pandas_categorical)[0]
    if hasattr(data, "to_numpy"):
        data = data.to_numpy()
    mat = np.asarray(data)
    if mat.dtype == object or not np.issubdtype(mat.dtype, np.number):
        raise NotImplementedError(
            "lightgbm_tpu_torch trains all-numerical matrices only")
    return mat


def _resolve_categoricals(categorical_feature, names, cfg) -> List[int]:
    """The categorical_feature spec (ints, names, or the config string)
    as column indices (JAX basic.py ``_resolve_categoricals``)."""
    cats: List[int] = []
    if isinstance(categorical_feature, (list, tuple)):
        for c in categorical_feature:
            if isinstance(c, str) and names and c in names:
                cats.append(names.index(c))
            elif isinstance(c, int):
                cats.append(c)
    elif cfg.categorical_feature:
        cats = [int(x) for x in str(cfg.categorical_feature).split(",")
                if x.strip().lstrip("-").isdigit()]
    return cats


class Dataset:
    """Training data wrapper (reference: basic.py Dataset); binning runs
    lazily at ``construct`` so params from ``train()`` still apply."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.position = position
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._inner: Optional[BinnedDataset] = None
        self.pandas_categorical: Optional[List[List[Any]]] = None

    def construct(self, extra_params: Optional[Dict[str, Any]] = None
                  ) -> "Dataset":
        if self._inner is not None:
            return self
        params = dict(extra_params or {})
        params.update(self.params)
        cfg = Config(params)
        cfg.check_supported()
        if isinstance(self.data, str):
            self._load_file(cfg)
        names = None
        if isinstance(self.feature_name, list):
            names = list(self.feature_name)
        elif hasattr(self.data, "columns"):
            names = [str(c) for c in self.data.columns]
        ref = None
        if self.reference is not None:
            ref = self.reference.construct(extra_params)._inner
        auto_cats: List[int] = []
        self.pandas_categorical = None
        if _is_frame(self.data):
            # a validation frame is encoded with the training codes
            # (reference: _data_from_pandas with pandas_categorical)
            ref_maps = (self.reference.pandas_categorical
                        if self.reference is not None else None)
            mat, auto_cats, self.pandas_categorical = \
                _dataframe_to_matrix(self.data, ref_maps)
        else:
            mat = _to_matrix(self.data)
        cats = _resolve_categoricals(self.categorical_feature, names, cfg)
        if not cats and not isinstance(self.categorical_feature,
                                       (list, tuple)) \
                and not cfg.categorical_feature:
            cats = auto_cats   # pandas category dtypes ("auto" mode)
        self._inner = BinnedDataset.from_matrix(
            mat, cfg, label=self.label, weight=self.weight,
            init_score=self.init_score, feature_names=names,
            categorical_features=cats, reference=ref, group=self.group,
            position=self.position)
        return self

    def _load_file(self, cfg: Config) -> None:
        """A text file as ``data`` (JAX basic.py Dataset.construct): its
        matrix, and its label, weight, query groups (a LibSVM file's
        ``qid:`` runs, a CSV / TSV ``group_column``) and header names
        where the caller gave none."""
        loaded = load_text_file(
            self.data, has_header=bool(cfg.header),
            label_column=cfg.label_column, weight_column=cfg.weight_column,
            group_column=cfg.group_column, ignore_column=cfg.ignore_column)
        if self.label is None:
            self.label = loaded.label
        if self.weight is None:
            self.weight = loaded.weight
        if self.group is None:
            self.group = loaded.group
        self.data = loaded.X
        if loaded.feature_names and not isinstance(self.feature_name, list):
            self.feature_name = loaded.feature_names

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._inner is not None and label is not None:
            self._inner.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.set_weight(weight)
        return self

    def set_group(self, group) -> "Dataset":
        """Per-query sizes, in row order (ranking)."""
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_group(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.set_init_score(init_score)
        return self

    def num_data(self) -> int:
        return (self._inner.num_data if self._inner is not None
                else _to_matrix(self.data).shape[0])

    def num_feature(self) -> int:
        return (self._inner.num_total_features if self._inner is not None
                else _to_matrix(self.data).shape[1])

    def get_label(self):
        if self._inner is not None and self._inner.metadata.label is not None:
            return np.asarray(self._inner.metadata.label)
        return None if self.label is None else np.asarray(self.label)

    def get_weight(self):
        return self.weight

    def get_group(self):
        return self.group


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
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._valid_names: List[str] = []
        self._valid_sets: List[Dataset] = []
        # the train set's eval-row name; train() sets the valid_names
        # entry when the train set is evaluated (callback.py
        # _is_train_row)
        self._train_data_name = "training"
        self._init_booster: Optional["Booster"] = None
        self._gbdt: Optional[GBDT] = None
        # the training frame's category lists (a model text's
        # pandas_categorical line), which encode every frame predicted
        self.pandas_categorical: Optional[List[List[Any]]] = None
        if train_set is not None:
            self.config.check_supported()
            device = self.config.torch_device()
            train_set.construct(self.params)
            self._gbdt = create_boosting(self.config, train_set._inner,
                                         create_objective(self.config),
                                         device)
            self.pandas_categorical = train_set.pandas_categorical
        elif model_file is not None:
            with open(model_file) as fh:
                self._load_model_string(fh.read())
        elif model_str is not None:
            self._load_model_string(model_str)
        else:
            log.fatal("Booster requires train_set, model_file or model_str")

    # ------------------------------------------------------------------
    def _continue_from(self, init_model) -> "Booster":
        """Continued training: seed this fresh booster with the trees of
        ``init_model`` (a Booster, a model file path or a model string)
        and, as train scores, its raw prediction of the raw train rows
        (JAX basic.py _continue_from)."""
        if isinstance(init_model, Booster):
            init_bst = init_model
        elif isinstance(init_model, str) and "\n" in init_model:
            init_bst = Booster(params=self._device_params(),
                               model_str=init_model)
        else:
            init_bst = Booster(params=self._device_params(),
                               model_file=init_model)
        ig = init_bst._gbdt
        if not ig.models:
            return self
        if isinstance(self._gbdt, RF):
            # RF's gradients at the init score cannot come from a loaded
            # model (JAX basic.py _continue_from)
            raise ValueError(
                "init_model continuation is not supported for boosting=rf")
        raw = self._raw_matrix(self.train_set, init_bst)
        if raw is None:
            raise ValueError(
                "continued training needs the raw train rows to score the "
                "init model; the train Dataset no longer holds them")
        self._gbdt.continue_from(ig.models, ig.predict_raw(raw))
        self._init_booster = init_bst
        return self

    def _device_params(self) -> Dict[str, Any]:
        return {k: v for k, v in self.params.items()
                if Config.canonical_name(k) == "device_type"}

    def _raw_matrix(self, dataset: Optional[Dataset], init_bst: "Booster"):
        """The raw rows of ``dataset`` for the init model to score, a frame
        encoded with the init model's own category lists (JAX basic.py
        ``_raw_matrix``)."""
        if dataset is None or dataset.data is None or isinstance(
                dataset.data, str):
            return None
        cats = (init_bst.pandas_categorical
                if init_bst.pandas_categorical is not None
                else self.pandas_categorical)
        return _to_matrix(dataset.data, cats)

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct(self.params)
        extra = None
        if self._init_booster is not None:
            raw = self._raw_matrix(data, self._init_booster)
            if raw is None:
                raise ValueError("continued training needs the raw rows of "
                                 "validation sets to score the init model")
            extra = self._init_booster._gbdt.predict_raw(raw)
        self._gbdt.add_valid_data(data._inner, extra_score=extra)
        self._valid_names.append(name)
        self._valid_sets.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when no further split was possible.
        ``fobj(scores, train_set) -> (grad, hess)`` sees the train scores
        in original row order, (N, K) for K classes, and returns (N, K)
        or N * K class-major values."""
        if fobj is not None:
            grad, hess = fobj(self._gbdt.scores.cpu().numpy().copy(),
                              self.train_set)
            return self.boost(grad, hess)
        return self._gbdt.train_one_iter()

    def boost(self, grad, hess) -> bool:
        """One iteration on the given gradients (original row order)."""
        return self._gbdt.train_one_iter(grad, hess)

    def rollback_one_iter(self) -> "Booster":
        """Take the last iteration out of the model and the scores."""
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """New params for the next iterations: the config and the
        shrinkage rate (the learner keeps the params it was built with)."""
        self.params.update(params)
        self.config = Config(self.params)
        if self._gbdt is not None:
            self._gbdt.config = self.config
            self._gbdt.shrinkage_rate = float(self.config.learning_rate)
        return self

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def eval_train(self, feval=None):
        out = [(self._train_data_name, name, val, is_max)
               for name, val, is_max in self._gbdt.eval_train()]
        if feval is not None:
            out += self._custom_eval(feval, self._train_data_name, train=True)
        return out

    def eval_valid(self, feval=None):
        out = []
        for vi, vname in enumerate(self._valid_names):
            out += [(vname, name, val, is_max)
                    for name, val, is_max in self._gbdt.eval_valid(vi)]
            if feval is not None:
                out += self._custom_eval(feval, vname, valid_index=vi)
        return out

    def _custom_eval(self, feval, dataset_name, train=False, valid_index=0):
        """``feval(scores, dataset)`` -> (name, value, is_higher_better) or
        a list of them, on raw scores in original row order, (N, K) for K
        classes."""
        if train:
            score, dataset = self._gbdt.scores, self.train_set
        else:
            score = self._gbdt.valid_score(valid_index)
            dataset = self._valid_sets[valid_index]
        score = score.cpu().numpy().copy()
        out = []
        for f in (feval if isinstance(feval, list) else [feval]):
            res = f(score, dataset)
            for name, val, is_max in ([res] if isinstance(res, tuple)
                                      else res):
                out.append((dataset_name, name, val, is_max))
        return out

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs) -> np.ndarray:
        if pred_contrib:
            raise NotImplementedError(
                "lightgbm_tpu_torch does not support pred_contrib yet")
        if num_iteration is None or num_iteration == 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        mat = np.asarray(_to_matrix(data, self.pandas_categorical),
                         dtype=np.float64)
        if mat.ndim == 1:
            mat = mat.reshape(1, -1)
        if mat.shape[1] != self.num_feature():
            raise LightGBMError(
                f"The number of features in data ({mat.shape[1]}) is not "
                f"the same as it was in training data ({self.num_feature()})")
        if pred_leaf:
            return self._gbdt.predict_leaf_index(mat, start_iteration,
                                                 num_iteration)
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
        if g.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(g.feature_names))
        infos = ([bm.feature_info() for bm in g.train_data.bin_mappers]
                 if g.train_data is not None else [])
        lines.append("feature_infos=" + " ".join(infos))
        # iterations of K class trees, class-major
        K = g.num_tree_per_iteration
        total = len(g.models)
        end = total if num_iteration < 0 else min(
            total, (start_iteration + num_iteration) * K)
        tree_strs = [g.models[i].to_string(i - start_iteration * K)
                     for i in range(start_iteration * K, end)]
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
        if self.pandas_categorical is not None:
            # the final line, as the reference Python wrapper writes it
            # (basic.py _dump_pandas_categorical)
            body += ("pandas_categorical:"
                     + json.dumps(self.pandas_categorical, default=str)
                     + "\n")
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
        predicts on the device this Booster's own params ask for; a
        ``pandas_categorical`` line among the last restores the category
        lists."""
        for line in reversed(text.rstrip().split("\n")[-5:]):
            if line.startswith("pandas_categorical:"):
                self.pandas_categorical = json.loads(
                    line[len("pandas_categorical:"):])
                break
        header: Dict[str, str] = {}
        for line in text.split("\n"):
            line = line.strip()
            if line.startswith("Tree="):
                break
            if "=" in line:
                k, v = line.split("=", 1)
                header[k.strip()] = v.strip()
            elif line == "average_output":
                header["average_output"] = "1"
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
        device = self.config.torch_device()
        saved.update({k: v for k, v in self.params.items()
                      if Config.canonical_name(k) == "device_type"})
        self.config = Config(saved)
        g = GBDT(self.config, None, create_objective(self.config), device)
        K = int(header.get("num_tree_per_iteration", 1))
        if K != g.num_tree_per_iteration:
            raise LightGBMError(
                f"num_tree_per_iteration={K} does not fit objective="
                f"{header.get('objective')!r} and num_class="
                f"{saved['num_class']}")
        g.label_idx = int(header.get("label_index", 0))
        g.max_feature_idx = int(header.get("max_feature_idx", 0))
        g.feature_names = header.get("feature_names", "").split()
        g.average_output = "average_output" in header
        for blk in text.split("Tree=")[1:]:
            g.models.append(Tree.from_string(
                "Tree=" + blk.split("end of trees")[0]))
        g.iter = len(g.models) // K
        self._gbdt = g
