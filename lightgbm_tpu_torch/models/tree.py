"""Host-side tree model: structure and text serde.

A copy of the numerical, constant-leaf part of lightgbm_tpu/models/tree.py
(the port imports nothing of the JAX package), so both packages write and
parse the same model text.  Categorical and linear trees are not part of
the port's slice: parsing one raises NotImplementedError.  Prediction runs
on the device (ops/predict.py).

Counterpart of the reference Tree (include/LightGBM/tree.h:25-729,
src/io/tree.cpp): training happens on the device (models/learner.py);
the finished tree is pulled to the host as flat arrays in the
reference's layout so that model files are interchangeable with the
reference's text format (src/io/tree.cpp Tree::ToString:340-408).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

# decision_type bit layout (reference: include/LightGBM/tree.h:19-20,260-278)
K_DEFAULT_LEFT_MASK = 2


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

    # -- decision bits --------------------------------------------------
    @staticmethod
    def pack_decision_type(default_left: bool, missing_type: int) -> int:
        """Numerical decision bits: default_left, missing type."""
        d = 0
        if default_left:
            d |= K_DEFAULT_LEFT_MASK
        d |= (missing_type & 3) << 2
        return d

    # -- serialization ---------------------------------------------------
    def to_string(self, tree_index: int) -> str:
        """reference: Tree::ToString (src/io/tree.cpp:340)."""
        def join(arr, fmt="{:g}"):
            return " ".join(fmt.format(x) for x in arr)

        lines = [f"Tree={tree_index}",
                 f"num_leaves={self.num_leaves}",
                 "num_cat=0"]
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
        else:
            lines.append("leaf_value=" + repr(float(
                self.leaf_value[0] if len(self.leaf_value) else 0.0)))
        lines.append("is_linear=0")
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

        for key in ("num_cat", "is_linear"):
            if int(kv.get(key, 0)) != 0:
                raise NotImplementedError(
                    f"lightgbm_tpu_torch loads numerical constant-leaf trees "
                    f"only ({key}={kv[key]})")
        num_leaves = int(kv.get("num_leaves", 1))
        t = cls(num_leaves)

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
        else:
            t.leaf_value = np.asarray([float(kv.get("leaf_value", 0.0))])
        t.shrinkage = float(kv.get("shrinkage", 1.0))
        return t

    def apply_shrinkage(self, rate: float) -> None:
        """reference: Tree::Shrinkage (tree.h)."""
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        self.shrinkage *= rate

    def num_nodes(self) -> int:
        return max(self.num_leaves - 1, 0)


def tree_from_device_record(record: Dict[str, np.ndarray], num_nodes: int,
                            bin_mappers, shrinkage: float = 1.0) -> Tree:
    """Convert the device learner's state record into a host Tree.

    Maps bin thresholds back to real-valued thresholds via the feature's
    BinMapper upper bounds (reference: BinMapper::BinToValue used by
    Tree::RealThreshold).
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
    t.decision_type = np.asarray(
        [Tree.pack_decision_type(bool(dl), int(mt))
         for dl, mt in zip(default_left, missing)], dtype=np.int8)
    # real-valued thresholds from bin upper bounds
    thresholds = np.zeros(num_nodes, dtype=np.float64)
    for i in range(num_nodes):
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
