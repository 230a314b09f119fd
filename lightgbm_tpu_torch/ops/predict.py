"""Tree traversal on the device, in plain PyTorch.

Port of lightgbm_tpu/ops/predict.py.  All rows advance one level per
step; finished rows hold their (negative) leaf reference.  The JAX
package runs these loops as plain XLA (no Pallas kernel), so plain
PyTorch is their counterpart here.  The number of steps is the tree's
depth, computed on the host from its child arrays, so traversal needs
no device-to-host sync.

``predict_leaf_thridx`` walks any numerical tree, trained in this
session or loaded, by its real-valued thresholds: the host maps raw
values to per-feature threshold-index space with float64 searchsorted
(v <= t_k iff #thresholds-below-v <= k), so the device compares
integers with the exact f64 semantics of the reference's
NumericalDecision (tree.h).

``predict_leaf_binned`` walks a tree the learner just grew over a
binned matrix (the validation sets' scores after each tree,
models/boosting.py), by the bin-space decision of the partition
(ops/partition.py ``decide_left``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .partition import decide_left

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
    """Threshold-index space of a list of numerical trees."""

    def __init__(self, trees: List):
        per_f: Dict[int, set] = {}
        for tr in trees:
            for f, th in zip(tr.split_feature[:tr.num_nodes()],
                             tr.threshold[:tr.num_nodes()]):
                per_f.setdefault(int(f), set()).add(float(th))
        self.features = sorted(per_f)
        self.col = {f: i for i, f in enumerate(self.features)}
        self.thr = [np.asarray(sorted(per_f[f]), np.float64)
                    for f in self.features]

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

    def nodes(self, tree) -> Dict[str, np.ndarray]:
        n = tree.num_nodes()
        feats = tree.split_feature[:n]
        dt = tree.decision_type[:n].astype(np.int32)
        return {
            "col": np.asarray([self.col[int(f)] for f in feats], np.int64),
            "kidx": np.asarray([
                int(np.searchsorted(self.thr[self.col[int(f)]], th))
                for f, th in zip(feats, tree.threshold[:n])], np.int64),
            "default_left": (dt >> 1) & 1, "mtype": (dt >> 2) & 3,
            "left": tree.left_child[:n], "right": tree.right_child[:n],
            "b0": np.asarray([int(np.searchsorted(t, 0.0)) for t in self.thr],
                             np.int64),
        }


def predict_leaf_thridx(packed_vals: torch.Tensor,
                        node: Dict[str, np.ndarray]) -> torch.Tensor:
    """Leaf index per row of a numerical tree (see module doc)."""
    dev = packed_vals.device
    t = {k: torch.as_tensor(np.asarray(node[k]).astype(np.int64), device=dev)
         for k in ("col", "kidx", "default_left", "mtype", "b0")}
    rows = torch.arange(packed_vals.shape[1], device=dev)

    def decide(nid):
        col = t["col"][nid]
        pv = packed_vals[col, rows].long()
        b, is_nan, zeroish = pv >> 2, (pv & 2) != 0, (pv & 1) != 0
        mtype = t["mtype"][nid]
        b_eff = torch.where(is_nan & (mtype != 2), t["b0"][col], b)
        miss = torch.where(mtype == 2, is_nan, (mtype == 1) & zeroish)
        return torch.where(miss, t["default_left"][nid] != 0,
                           b_eff <= t["kidx"][nid])

    return _walk(packed_vals.shape[1], node, dev, decide)


# the per-node fields of a bin-space traversal, in the order of the
# packed (10, nodes) matrix (lightgbm_tpu/ops/predict.py
# predict_leaf_binned_t)
BINNED_NODE_FIELDS = ("col", "bin_start", "is_bundled", "num_bin",
                      "default_bin", "missing_type", "threshold",
                      "default_left", "left", "right")


def pack_binned_nodes(node: Dict[str, np.ndarray], device) -> torch.Tensor:
    """The node fields as one (10, nodes) int32 matrix on ``device``: one
    gather a level reads a row's node.  From the host, the copy to the
    card is pinned and asynchronous (no sync)."""
    mat = torch.from_numpy(np.stack([
        np.asarray(node[k]).astype(np.int32) for k in BINNED_NODE_FIELDS]))
    if torch.device(device).type == "cuda":
        return mat.pin_memory().to(device, non_blocking=True)
    return mat.to(device)


def predict_leaf_binned(binned: torch.Tensor, node: Dict[str, np.ndarray],
                        depth: Optional[int] = None,
                        packed: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Leaf index (int64) of every row of an (n, G) bin matrix.

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

    def decide(nid):
        (col, bstart, isb, nb, dbin, mtype, thr, dl,
         _, _) = packed[:, nid]
        return decide_left(binned[rows, col.long()], bstart, isb, nb, dbin,
                           mtype, thr, dl)

    return _walk(n, {"left": packed[8], "right": packed[9]}, dev, decide,
                 depth)


def predict_leaf_binned_t(binned_t: torch.Tensor,
                          node: Dict[str, np.ndarray],
                          depth: Optional[int] = None) -> torch.Tensor:
    """``predict_leaf_binned`` over a transposed (G, n) bin matrix."""
    return predict_leaf_binned(binned_t.T, node, depth)
