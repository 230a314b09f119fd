"""Tree traversal on the device, in plain PyTorch.

Port of lightgbm_tpu/ops/predict.py.  All rows advance one level per
step; finished rows hold their (negative) leaf reference.  The JAX
package runs these loops as plain XLA (no Pallas kernel), so plain
PyTorch is their counterpart here.  The number of steps is the tree's
depth, computed on the host from its child arrays, so traversal needs
no device-to-host sync.

``predict_leaf_thridx`` walks any tree, trained in this process or
loaded, by its real-valued thresholds: the host maps raw values to
per-feature threshold-index space with float64 searchsorted (v <= t_k
iff #thresholds-below-v <= k), so the device compares integers with the
exact f64 semantics of the reference's NumericalDecision (tree.h).  A
categorical node tests the raw value's category, truncated to an int
on the host (-1 for NaN, a negative value or one past int32), against
the node's bitset of category values (the reference's
CategoricalDecision: an unseen or missing category goes right).

``predict_leaf_binned`` walks a tree the learner grew over a binned
matrix (the validation sets' scores after each tree, and a past tree
over the train rows, models/boosting.py), by the bin-space decision of the partition
(ops/partition.py ``decide_left``, a categorical node's set of bins
included).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .partition import CAT_WORDS, bin_words, decide_left

K_ZERO_THRESHOLD = 1e-35


def tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """Levels from the root to the deepest leaf (0 for a stump)."""
    if len(left) == 0:
        return 0
    depth, frontier = 0, [0]
    while frontier:
        depth += 1
        frontier = [c for n in frontier for c in (left[n], right[n]) if c >= 0]
    return depth


def _walk(n: int, node: Dict[str, np.ndarray], device, decide,
          depth: Optional[int] = None) -> torch.Tensor:
    """Level loop: ``decide(nid)`` -> goes-left for the rows; ``depth``
    levels (from the host child arrays when not given)."""
    if len(node["left"]) == 0:
        return torch.zeros(n, dtype=torch.long, device=device)
    if depth is None:
        depth = tree_depth(np.asarray(node["left"]), np.asarray(node["right"]))
    left = torch.as_tensor(node["left"], device=device).long()
    right = torch.as_tensor(node["right"], device=device).long()
    cur = torch.zeros(n, dtype=torch.long, device=device)
    for _ in range(depth):
        nid = cur.clamp(min=0)
        nxt = torch.where(decide(nid), left[nid], right[nid])
        cur = torch.where(cur >= 0, nxt, cur)
    return -(cur + 1)


class ThresholdIndex:
    """Threshold-index space of a list of trees: the numerical nodes'
    thresholds per feature, and the features of categorical nodes."""

    def __init__(self, trees: List):
        per_f: Dict[int, set] = {}
        cat_f: set = set()
        for tr in trees:
            n = tr.num_nodes()
            for f, th, ic in zip(tr.split_feature[:n], tr.threshold[:n],
                                 tr.is_categorical_node()):
                if ic:
                    cat_f.add(int(f))
                else:
                    per_f.setdefault(int(f), set()).add(float(th))
        self.features = sorted(per_f)
        self.col = {f: i for i, f in enumerate(self.features)}
        self.thr = [np.asarray(sorted(per_f[f]), np.float64)
                    for f in self.features]
        self.cat_features = sorted(cat_f)
        self.ccol = {f: i for i, f in enumerate(self.cat_features)}

    def pack_values(self, data: np.ndarray, device) -> torch.Tensor:
        """(Fu, n) int32: b*4 + nan*2 + zeroish per (used feature, row)."""
        data = np.asarray(data, np.float64)
        out = np.zeros((max(len(self.features), 1), data.shape[0]), np.int32)
        for i, f in enumerate(self.features):
            v = data[:, f]
            nan = np.isnan(v)
            veff = np.where(nan, 0.0, v)
            b = np.searchsorted(self.thr[i], veff, side="left")
            zeroish = np.abs(veff) <= K_ZERO_THRESHOLD
            out[i] = b * 4 + nan * 2 + zeroish
        return torch.as_tensor(out, device=device)

    def pack_categories(self, data: np.ndarray, device) -> torch.Tensor:
        """(Fc, n) int64: the category of each (categorical feature, row),
        the value truncated toward zero, -1 for NaN, a negative value or
        one past int32."""
        data = np.asarray(data, np.float64)
        out = np.full((max(len(self.cat_features), 1), data.shape[0]), -1,
                      np.int64)
        for i, f in enumerate(self.cat_features):
            v = data[:, f]
            tv = np.trunc(np.where(np.isfinite(v), v, -1.0))
            ok = (tv >= 0) & (tv < 2.0 ** 31)
            out[i] = np.where(ok, tv, -1).astype(np.int64)
        return torch.as_tensor(out, device=device)

    def nodes(self, tree) -> Dict[str, np.ndarray]:
        n = tree.num_nodes()
        feats = tree.split_feature[:n]
        dt = tree.decision_type[:n].astype(np.int32)
        is_cat = tree.is_categorical_node()
        bounds = np.asarray(tree.cat_boundaries, np.int64)
        cidx = np.where(is_cat, tree.threshold[:n], 0).astype(np.int64)
        cidx = np.minimum(cidx, max(len(bounds) - 2, 0))
        return {
            "col": np.asarray([0 if ic else self.col[int(f)]
                               for f, ic in zip(feats, is_cat)], np.int64),
            "kidx": np.asarray([
                0 if ic else int(np.searchsorted(self.thr[self.col[int(f)]],
                                                 th))
                for f, th, ic in zip(feats, tree.threshold[:n], is_cat)],
                np.int64),
            "default_left": (dt >> 1) & 1, "mtype": (dt >> 2) & 3,
            "left": tree.left_child[:n], "right": tree.right_child[:n],
            "b0": np.asarray([int(np.searchsorted(t, 0.0)) for t in self.thr],
                             np.int64),
            "is_cat": is_cat.astype(np.int64),
            "ccol": np.asarray([self.ccol[int(f)] if ic else 0
                                for f, ic in zip(feats, is_cat)], np.int64),
            "cat_lo": bounds[cidx] if len(bounds) > 1 else np.zeros(
                n, np.int64),
            "cat_nw": (bounds[cidx + 1] - bounds[cidx]) if len(bounds) > 1
            else np.zeros(n, np.int64),
            "cat_words": np.asarray(tree.cat_threshold or [0],
                                    np.int64) & 0xFFFFFFFF,
        }


def predict_leaf_thridx(packed_vals: torch.Tensor,
                        node: Dict[str, np.ndarray],
                        cat_vals: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Leaf index per row of a tree (see module doc); ``cat_vals`` is
    ``ThresholdIndex.pack_categories`` when the tree has categorical
    nodes."""
    dev = packed_vals.device
    t = {k: torch.as_tensor(np.asarray(node[k]).astype(np.int64), device=dev)
         for k in ("col", "kidx", "default_left", "mtype", "b0")}
    rows = torch.arange(packed_vals.shape[1], device=dev)
    has_cat = bool(np.any(node.get("is_cat", 0)))
    if has_cat:
        c = {k: torch.as_tensor(np.asarray(node[k]), device=dev)
             for k in ("is_cat", "ccol", "cat_lo", "cat_nw", "cat_words")}

    def decide(nid):
        col = t["col"][nid]
        pv = packed_vals[col, rows].long()
        b, is_nan, zeroish = pv >> 2, (pv & 2) != 0, (pv & 1) != 0
        mtype = t["mtype"][nid]
        b_eff = torch.where(is_nan & (mtype != 2), t["b0"][col], b)
        miss = torch.where(mtype == 2, is_nan, (mtype == 1) & zeroish)
        left = torch.where(miss, t["default_left"][nid] != 0,
                           b_eff <= t["kidx"][nid])
        if not has_cat:
            return left
        iv = cat_vals[c["ccol"][nid], rows]
        word = torch.clamp(iv, min=0) >> 5
        ok = (iv >= 0) & (word < c["cat_nw"][nid])
        widx = torch.clamp(c["cat_lo"][nid] + word,
                           max=c["cat_words"].shape[0] - 1)
        bit = (c["cat_words"][widx] >> (torch.clamp(iv, min=0) & 31)) & 1
        return torch.where(c["is_cat"][nid] != 0, ok & (bit != 0), left)

    return _walk(packed_vals.shape[1], node, dev, decide)


# the per-node fields of a bin-space traversal, in the order of the
# packed (10, nodes) matrix (lightgbm_tpu/ops/predict.py
# predict_leaf_binned_t)
BINNED_NODE_FIELDS = ("col", "bin_start", "is_bundled", "num_bin",
                      "default_bin", "missing_type", "threshold",
                      "default_left", "left", "right", "is_cat")
# after them, a categorical node's set: W rows of bitset words of bins


def pack_binned_nodes(node: Dict[str, np.ndarray], device) -> torch.Tensor:
    """The node fields as one (11 + W, nodes) int32 matrix on ``device``
    (W the sets' words, ``cat_set`` (nodes, W)): one gather a level reads
    a row's node.  From the host, the copy to the card is pinned and
    asynchronous (no sync)."""
    n = len(node["left"])
    cat = np.asarray(node.get("cat_set", np.zeros((n, CAT_WORDS))),
                     np.int64).astype(np.int32).reshape(n, -1)
    mat = torch.from_numpy(np.concatenate([np.stack([
        np.asarray(node.get(k, np.zeros(n))).astype(np.int32)
        for k in BINNED_NODE_FIELDS]), cat.T]))
    if torch.device(device).type == "cuda":
        return mat.pin_memory().to(device, non_blocking=True)
    return mat.to(device)


def predict_leaf_binned(binned: torch.Tensor, node: Dict[str, np.ndarray],
                        depth: Optional[int] = None,
                        packed: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Leaf index (int64) of every row of an (n, G) bin matrix (uint8
    or uint16).

    ``node`` holds the per-internal-node arrays of BINNED_NODE_FIELDS
    (children >= 0 internal, < 0 ~leaf); ``depth`` is the tree's depth
    (``tree_depth`` of the host child arrays when not given), so the
    loop needs no sync; ``packed`` is ``pack_binned_nodes(node)`` when
    the caller has it on the device already."""
    n = binned.shape[0]
    dev = binned.device
    if len(node["left"]) == 0:
        return torch.zeros(n, dtype=torch.long, device=dev)
    if depth is None:
        depth = tree_depth(np.asarray(node["left"]), np.asarray(node["right"]))
    if packed is None:
        packed = pack_binned_nodes(node, dev)
    rows = torch.arange(n, device=dev)
    has_cat = bool(np.any(node.get("is_cat", 0)))
    # uint16 bins are gathered as their int16 bits (ops/partition.py
    # bin_words; decide_left widens them)
    src = bin_words(binned)

    def colv(col):
        v = src[rows, col.long()]
        return v.view(torch.uint16) if binned.dtype == torch.uint16 else v

    def decide(nid):
        (col, bstart, isb, nb, dbin, mtype, thr, dl, _, _,
         iscat) = packed[:len(BINNED_NODE_FIELDS), nid]
        cat = (packed[len(BINNED_NODE_FIELDS):, nid] if has_cat else ())
        return decide_left(colv(col), bstart, isb, nb, dbin, mtype, thr, dl,
                           iscat if has_cat else 0, *cat)

    return _walk(n, {"left": packed[8], "right": packed[9]}, dev, decide,
                 depth)


def predict_leaf_binned_t(binned_t: torch.Tensor,
                          node: Dict[str, np.ndarray],
                          depth: Optional[int] = None,
                          packed: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``predict_leaf_binned`` over a transposed (G, n) bin matrix (the
    learner's physical bin rows, models/boosting.py ``_tree_to_scores``)."""
    return predict_leaf_binned(binned_t.T, node, depth, packed)
