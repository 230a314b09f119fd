"""Host-side tree model: structure and text serde.

A copy of lightgbm_tpu/models/tree.py (the port imports nothing of the
JAX package): numerical and categorical splits and linear leaves
(``is_linear``: a leaf predicts ``leaf_const + leaf_coeff . x`` over its
``leaf_features``' raw values, ``leaf_value`` where one of them is NaN),
so both packages write and parse the same model text.  Prediction runs
on the device (ops/predict.py); ``predict_leaf`` is the host traversal
(the reference's NumericalDecision / CategoricalDecision), kept as the
oracle of the device walk.

Counterpart of the reference Tree (include/LightGBM/tree.h:25-729,
src/io/tree.cpp): training happens on the device (models/learner.py);
the finished tree is pulled to the host as flat arrays in the
reference's layout so that model files are interchangeable with the
reference's text format (src/io/tree.cpp Tree::ToString:340-408).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

K_ZERO_THRESHOLD = 1e-35

# decision_type bit layout (reference: include/LightGBM/tree.h:19-20,260-278)
K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2

MISSING_ZERO = 1
MISSING_NAN = 2


class Tree:
    """Flat-array binary tree (reference: include/LightGBM/tree.h:25)."""

    def __init__(self, num_leaves: int):
        n = max(num_leaves - 1, 0)
        self.num_leaves = num_leaves
        self.split_feature: np.ndarray = np.zeros(n, dtype=np.int32)
        self.threshold_bin: np.ndarray = np.zeros(n, dtype=np.int32)
        self.threshold: np.ndarray = np.zeros(n, dtype=np.float64)
        self.decision_type: np.ndarray = np.zeros(n, dtype=np.int8)
        self.left_child: np.ndarray = np.zeros(n, dtype=np.int32)
        self.right_child: np.ndarray = np.zeros(n, dtype=np.int32)
        self.split_gain: np.ndarray = np.zeros(n, dtype=np.float64)
        self.internal_value: np.ndarray = np.zeros(n, dtype=np.float64)
        self.internal_weight: np.ndarray = np.zeros(n, dtype=np.float64)
        self.internal_count: np.ndarray = np.zeros(n, dtype=np.int64)
        self.leaf_value: np.ndarray = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_weight: np.ndarray = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_count: np.ndarray = np.zeros(num_leaves, dtype=np.int64)
        self.shrinkage: float = 1.0
        # categorical nodes: threshold is an index into cat_boundaries;
        # cat_threshold holds each node's bitset of category values
        self.num_cat: int = 0
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        # linear leaves (reference: tree.h leaf_const_ / leaf_features_ /
        # leaf_coeff_; JAX tree.py)
        self.is_linear: bool = False
        self.leaf_const: np.ndarray = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_features: List[List[int]] = [[] for _ in
                                               range(num_leaves)]
        self.leaf_coeff: List[List[float]] = [[] for _ in range(num_leaves)]

    # -- decision bits --------------------------------------------------
    @staticmethod
    def pack_decision_type(categorical: bool, default_left: bool,
                           missing_type: int) -> int:
        """Decision bits: categorical, default_left, missing type."""
        d = 0
        if categorical:
            d |= K_CATEGORICAL_MASK
        if default_left:
            d |= K_DEFAULT_LEFT_MASK
        d |= (missing_type & 3) << 2
        return d

    def is_categorical_node(self) -> np.ndarray:
        """(nodes,) bool: the categorical internal nodes."""
        n = self.num_nodes()
        return (self.decision_type[:n] & K_CATEGORICAL_MASK) != 0

    # -- prediction on raw feature values (the host oracle) --------------
    def predict_leaf(self, data: np.ndarray) -> np.ndarray:
        """Leaf index per row (reference: tree.h NumericalDecision:335,
        CategoricalDecision:400)."""
        n = data.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)
        active = np.ones(n, dtype=bool)
        result = np.zeros(n, dtype=np.int32)
        for _ in range(self.num_leaves * 2):
            if not active.any():
                break
            nid = node[active]
            fval = data[active, self.split_feature[nid]].astype(np.float64)
            dtp = self.decision_type[nid]
            is_cat = (dtp & K_CATEGORICAL_MASK) != 0
            dleft = (dtp & K_DEFAULT_LEFT_MASK) != 0
            mtype = (dtp.astype(np.int32) >> 2) & 3
            nan_mask = np.isnan(fval)
            fv = np.where(nan_mask & (mtype != MISSING_NAN), 0.0, fval)
            is_missing = (((mtype == MISSING_ZERO)
                           & (np.abs(fv) <= K_ZERO_THRESHOLD))
                          | ((mtype == MISSING_NAN) & nan_mask))
            goes_left = np.where(is_missing, dleft,
                                 fv <= self.threshold[nid])
            if is_cat.any():
                goes_left = np.where(
                    is_cat, self.categorical_decision(nid, fval), goes_left)
            nxt = np.where(goes_left, self.left_child[nid],
                           self.right_child[nid])
            leaf_hit = nxt < 0
            act_idx = np.nonzero(active)[0]
            result[act_idx[leaf_hit]] = ~nxt[leaf_hit]
            node[act_idx] = np.where(leaf_hit, node[act_idx], nxt)
            still = np.zeros(n, dtype=bool)
            still[act_idx[~leaf_hit]] = True
            active = still
        return result

    def predict(self, data: np.ndarray) -> np.ndarray:
        """Raw output per row on the host (f64 leaf values; a linear
        tree's leaf models)."""
        if self.is_linear:
            return self._linear_output(data, self.predict_leaf(data))
        if self.num_leaves <= 1:
            return np.full(data.shape[0], self.leaf_value[0]
                           if len(self.leaf_value) else 0.0)
        return self.leaf_value[self.predict_leaf(data)]

    def _linear_output(self, data: np.ndarray, leaf: np.ndarray
                       ) -> np.ndarray:
        """Each row's linear leaf output in f64, the constant leaf value
        where one of its leaf's features is NaN (reference: tree.cpp
        PredictLinear; JAX tree.py ``_linear_output``): the host oracle
        of ops/predict.py ``linear_output``."""
        out = np.empty(len(leaf), dtype=np.float64)
        for lf in np.unique(leaf):
            sel = leaf == lf
            feats = self.leaf_features[lf]
            if not feats:
                out[sel] = self.leaf_const[lf]
                continue
            sub = data[np.ix_(sel, np.asarray(feats, dtype=np.intp))] \
                .astype(np.float64)
            vals = self.leaf_const[lf] + sub.dot(
                np.asarray(self.leaf_coeff[lf], dtype=np.float64))
            nan_rows = np.isnan(sub).any(axis=1)
            out[sel] = np.where(nan_rows, self.leaf_value[lf], vals)
        return out

    def categorical_decision(self, nid, fval) -> np.ndarray:
        """Bitset membership of raw values at categorical nodes ``nid``
        (reference: tree.h CategoricalDecision): the value is truncated
        toward zero; NaN, a negative or a value past int32 or past the
        node's bitset goes right."""
        nid = np.asarray(nid)
        is_cat = (self.decision_type[nid] & K_CATEGORICAL_MASK) != 0
        tv = np.trunc(fval)
        ok = is_cat & np.isfinite(fval) & (tv >= 0) & (tv < 2.0 ** 31)
        iv = np.where(ok, tv, 0).astype(np.int64)
        cat_idx = np.where(is_cat, self.threshold[nid], 0).astype(np.int64)
        bounds = np.asarray(self.cat_boundaries, dtype=np.int64)
        words = (np.asarray(self.cat_threshold, dtype=np.uint32)
                 if self.cat_threshold else np.zeros(1, dtype=np.uint32))
        lo = bounds[np.minimum(cat_idx, len(bounds) - 1)]
        hi = bounds[np.minimum(cat_idx + 1, len(bounds) - 1)]
        word = iv // 32
        in_set = word < (hi - lo)
        widx = np.minimum(lo + word, len(words) - 1)
        bit = (words[widx] >> (iv % 32).astype(np.uint32)) & 1
        return ok & in_set & (bit != 0)

    # -- serialization ---------------------------------------------------
    def to_string(self, tree_index: int) -> str:
        """reference: Tree::ToString (src/io/tree.cpp:340)."""
        def join(arr, fmt="{:g}"):
            return " ".join(fmt.format(x) for x in arr)

        lines = [f"Tree={tree_index}",
                 f"num_leaves={self.num_leaves}",
                 f"num_cat={self.num_cat}"]
        if self.num_leaves > 1:
            lines.append("split_feature=" + join(self.split_feature, "{:d}"))
            lines.append("split_gain=" + join(self.split_gain))
            lines.append("threshold=" + " ".join(
                repr(float(t)) for t in self.threshold))
            lines.append("decision_type=" + join(self.decision_type, "{:d}"))
            lines.append("left_child=" + join(self.left_child, "{:d}"))
            lines.append("right_child=" + join(self.right_child, "{:d}"))
            lines.append("leaf_value=" + " ".join(
                repr(float(v)) for v in self.leaf_value[:self.num_leaves]))
            lines.append("leaf_weight=" + join(self.leaf_weight[:self.num_leaves]))
            lines.append("leaf_count=" + join(self.leaf_count[:self.num_leaves], "{:d}"))
            lines.append("internal_value=" + join(self.internal_value))
            lines.append("internal_weight=" + join(self.internal_weight))
            lines.append("internal_count=" + join(self.internal_count, "{:d}"))
            if self.num_cat > 0:
                lines.append("cat_boundaries=" + join(self.cat_boundaries,
                                                      "{:d}"))
                lines.append("cat_threshold=" + join(self.cat_threshold,
                                                     "{:d}"))
        else:
            lines.append("leaf_value=" + repr(float(
                self.leaf_value[0] if len(self.leaf_value) else 0.0)))
        lines.append(f"is_linear={int(self.is_linear)}")
        if self.is_linear:
            # reference: Tree::ToString's linear block (tree.cpp:377-399)
            lines.append("leaf_const=" + " ".join(
                repr(float(v)) for v in self.leaf_const[:self.num_leaves]))
            lines.append("num_features=" + join(
                [len(c) for c in self.leaf_coeff[:self.num_leaves]], "{:d}"))
            lines.append("leaf_features=" + " ".join(
                " ".join(str(f) for f in feats)
                for feats in self.leaf_features[:self.num_leaves]))
            lines.append("leaf_coeff=" + " ".join(
                " ".join(repr(float(c)) for c in coefs)
                for coefs in self.leaf_coeff[:self.num_leaves]))
        lines.append(f"shrinkage={self.shrinkage:g}")
        lines.append("")
        lines.append("")
        return "\n".join(lines)

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v

        num_leaves = int(kv.get("num_leaves", 1))
        t = cls(num_leaves)
        t.num_cat = int(kv.get("num_cat", 0))

        def parse(key, dtype, n):
            if key not in kv or not kv[key].strip():
                return np.zeros(n, dtype=dtype)
            return np.asarray([dtype(x) for x in kv[key].split()], dtype=dtype)

        if num_leaves > 1:
            n = num_leaves - 1
            t.split_feature = parse("split_feature", np.int32, n)
            t.split_gain = parse("split_gain", np.float64, n)
            t.threshold = parse("threshold", np.float64, n)
            t.decision_type = parse("decision_type", np.int8, n)
            t.left_child = parse("left_child", np.int32, n)
            t.right_child = parse("right_child", np.int32, n)
            t.leaf_value = parse("leaf_value", np.float64, num_leaves)
            t.leaf_weight = parse("leaf_weight", np.float64, num_leaves)
            t.leaf_count = parse("leaf_count", np.int64, num_leaves)
            t.internal_value = parse("internal_value", np.float64, n)
            t.internal_weight = parse("internal_weight", np.float64, n)
            t.internal_count = parse("internal_count", np.int64, n)
            if t.num_cat > 0:
                t.cat_boundaries = [int(x) for x in
                                    kv["cat_boundaries"].split()]
                t.cat_threshold = [int(x) for x in
                                   kv["cat_threshold"].split()]
        else:
            t.leaf_value = np.asarray([float(kv.get("leaf_value", 0.0))])
        t.shrinkage = float(kv.get("shrinkage", 1.0))
        t.is_linear = bool(int(kv.get("is_linear", 0)))
        if t.is_linear:
            t.leaf_const = parse("leaf_const", np.float64, num_leaves)
            nfeat = parse("num_features", np.int64, num_leaves)
            flat_f = [int(x) for x in kv.get("leaf_features", "").split()]
            flat_c = [float(x) for x in kv.get("leaf_coeff", "").split()]
            pos = 0
            for i in range(num_leaves):
                k = int(nfeat[i])
                t.leaf_features[i] = flat_f[pos:pos + k]
                t.leaf_coeff[i] = flat_c[pos:pos + k]
                pos += k
        return t

    def to_json(self) -> dict:
        """The tree as a dict (reference: Tree::ToJSON, tree.cpp:411;
        JAX tree.py ``to_json``), a linear leaf with its model."""
        out = {"num_leaves": int(self.num_leaves),
               "num_cat": int(self.num_cat), "shrinkage": self.shrinkage}
        if self.num_leaves == 1:
            out["tree_structure"] = {"leaf_value": float(
                self.leaf_value[0] if len(self.leaf_value) else 0.0)}
        else:
            out["tree_structure"] = self._node_json(0)
        return out

    def _cats_of_node(self, node: int) -> List[int]:
        """A categorical node's bitset as its category values."""
        cat_idx = int(self.threshold[node])
        lo = self.cat_boundaries[cat_idx]
        hi = self.cat_boundaries[cat_idx + 1]
        return [(w - lo) * 32 + b for w in range(lo, hi) for b in range(32)
                if (self.cat_threshold[w] >> b) & 1]

    def _node_json(self, node: int) -> dict:
        if node >= 0:
            d = int(self.decision_type[node])
            cat = bool(d & K_CATEGORICAL_MASK)
            thr = ("||".join(str(c) for c in self._cats_of_node(node))
                   if cat else float(self.threshold[node]))
            return {
                "split_index": int(node),
                "split_feature": int(self.split_feature[node]),
                "split_gain": float(self.split_gain[node]),
                "threshold": thr,
                "decision_type": "==" if cat else "<=",
                "default_left": bool(d & K_DEFAULT_LEFT_MASK),
                "missing_type": ["None", "Zero", "NaN"][(d >> 2) & 3],
                "internal_value": float(self.internal_value[node]),
                "internal_weight": float(self.internal_weight[node]),
                "internal_count": int(self.internal_count[node]),
                "left_child": self._node_json(int(self.left_child[node])),
                "right_child": self._node_json(int(self.right_child[node])),
            }
        leaf = ~node
        out = {"leaf_index": int(leaf),
               "leaf_value": float(self.leaf_value[leaf]),
               "leaf_weight": float(self.leaf_weight[leaf]),
               "leaf_count": int(self.leaf_count[leaf])}
        if self.is_linear:
            out["leaf_const"] = float(self.leaf_const[leaf])
            out["leaf_features"] = list(self.leaf_features[leaf])
            out["leaf_coeff"] = [float(c) for c in self.leaf_coeff[leaf]]
        return out

    def apply_shrinkage(self, rate: float) -> None:
        """reference: Tree::Shrinkage (tree.h); a linear leaf's constant
        and coefficients too."""
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        if self.is_linear:
            self.leaf_const = self.leaf_const * rate
            self.leaf_coeff = [[c * rate for c in cs]
                               for cs in self.leaf_coeff]
        self.shrinkage *= rate

    def num_nodes(self) -> int:
        return max(self.num_leaves - 1, 0)


def _cat_bitsets(t: Tree, nodes, sets, bin_mappers) -> np.ndarray:
    """The categorical ``nodes``' sets of bins (``sets``, W int32 words a
    node) as bitsets of category values appended to ``t.cat_threshold``
    / ``t.cat_boundaries`` in node order (a node's words up to its
    largest category); returns each node's index into them."""
    feats = t.split_feature[nodes]
    tables = {}
    for f in np.unique(feats):
        b2c = np.asarray(bin_mappers[int(f)].bin_2_categorical, np.int64)
        tab = np.full(32 * sets.shape[1], -1, np.int64)
        tab[:min(len(b2c), len(tab))] = b2c[:len(tab)]
        tables[int(f)] = tab
    words = sets[nodes].astype(np.int64) & 0xFFFFFFFF
    member = ((words[:, :, None] >> np.arange(32)) & 1).reshape(
        len(nodes), -1) != 0
    vals = np.where(member, np.stack([tables[int(f)] for f in feats]), -1)
    top = vals.max(axis=1)
    nw = np.where(top >= 0, top // 32 + 1, 1)
    start = np.concatenate([[0], np.cumsum(nw)])
    row, col = np.nonzero(vals >= 0)
    cats = vals[row, col]
    out = np.bincount(start[row] + cats // 32,
                      weights=(np.int64(1) << (cats % 32)).astype(np.float64),
                      minlength=int(start[-1]))
    base = len(t.cat_threshold)
    t.cat_threshold.extend(out.astype(np.int64).tolist())
    t.cat_boundaries.extend((base + start[1:]).tolist())
    t.num_cat += len(nodes)
    return np.arange(t.num_cat - len(nodes), t.num_cat, dtype=np.float64)


def tree_from_device_record(record: Dict[str, np.ndarray], num_nodes: int,
                            bin_mappers, shrinkage: float = 1.0) -> Tree:
    """Convert the device learner's state record into a host Tree.

    Maps bin thresholds back to real-valued thresholds via the feature's
    BinMapper upper bounds (reference: BinMapper::BinToValue used by
    Tree::RealThreshold); a categorical node's threshold is an index into
    ``cat_boundaries``, its set a bitset of category values in
    ``cat_threshold`` (reference: Tree::SplitCategorical; JAX
    models/tree.py).  ``node_cat_set`` holds each node's set as W words
    of bins (the learner's width: 8 up to 256 bins).
    """
    num_leaves = num_nodes + 1
    t = Tree(num_leaves)
    if num_nodes == 0:
        t.leaf_value = np.asarray([0.0])
        return t
    nslice = slice(0, num_nodes)
    t.split_feature = np.asarray(record["node_feature"][nslice], dtype=np.int32)
    t.threshold_bin = np.asarray(record["node_threshold"][nslice], dtype=np.int32)
    t.left_child = np.asarray(record["node_left"][nslice], dtype=np.int32)
    t.right_child = np.asarray(record["node_right"][nslice], dtype=np.int32)
    t.split_gain = np.asarray(record["node_gain"][nslice], dtype=np.float64)
    t.internal_value = np.asarray(record["node_internal_value"][nslice], dtype=np.float64)
    t.internal_weight = np.asarray(record["node_internal_weight"][nslice], dtype=np.float64)
    t.internal_count = np.asarray(record["node_internal_count"][nslice], dtype=np.int64)
    default_left = np.asarray(record["node_default_left"][nslice])
    missing = np.asarray(record["node_missing_type"][nslice], dtype=np.int32)
    node_is_cat = np.asarray(
        record.get("node_is_cat", np.zeros(num_nodes, bool))[nslice])
    t.decision_type = np.asarray(
        [Tree.pack_decision_type(bool(ic), bool(dl) and not ic, int(mt))
         for ic, dl, mt in zip(node_is_cat, default_left, missing)],
        dtype=np.int8)
    # real-valued thresholds from bin upper bounds; categorical nodes
    # index their bitset of category values
    thresholds = np.zeros(num_nodes, dtype=np.float64)
    cat_nodes = np.nonzero(node_is_cat)[0]
    if len(cat_nodes):
        thresholds[cat_nodes] = _cat_bitsets(
            t, cat_nodes, np.asarray(record["node_cat_set"]), bin_mappers)
    for i in np.nonzero(~node_is_cat)[0]:
        bm = bin_mappers[int(t.split_feature[i])]
        b = int(t.threshold_bin[i])
        ub = bm.bin_upper_bound
        b = min(b, len(ub) - 1)
        v = ub[b]
        if math.isinf(v) or math.isnan(v):
            v = bm.bin_upper_bound[max(b - 1, 0)] if len(ub) > 1 else 0.0
            v = max(v, bm.max_val) + 1.0 if math.isinf(v) or math.isnan(v) else v
        thresholds[i] = v
    t.threshold = thresholds
    t.leaf_value = np.asarray(record["leaf_value"][:num_leaves], dtype=np.float64)
    t.leaf_weight = np.asarray(record["leaf_sum_h"][:num_leaves], dtype=np.float64)
    cnt_key = "leaf_cnt_g" if "leaf_cnt_g" in record else "leaf_cnt"
    t.leaf_count = np.asarray(record[cnt_key][:num_leaves], dtype=np.int64)
    if shrinkage != 1.0:
        t.apply_shrinkage(shrinkage)
    return t
