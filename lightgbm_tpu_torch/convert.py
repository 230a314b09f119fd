"""Carry state from the JAX package into the port.

For a GBDT the state is the model and the binned data.  Nothing here
imports JAX: callers hand over plain text and numpy arrays.

``booster_from_model_string`` loads model text written by
``lightgbm_tpu`` (the port's own ``model_to_string`` writes the same
format, so it loads back there too).  ``dataset_from_arrays`` builds a
port ``BinnedDataset`` from the arrays of a JAX ``BinnedDataset``: its
binned matrix, its bin mappers as ``BinMapper.to_dict()`` dicts, the
feature order of its groups, and the label -- so both packages' learners
can be fed identical bins.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .basic import Booster
from .config import Config
from .dataset import BinnedDataset, Metadata, groups_from_order
from .ops.binning import BinMapper


def booster_from_model_string(text: str,
                              params: Optional[Dict[str, Any]] = None
                              ) -> Booster:
    """A port Booster for model text from either package; ``params``
    may set ``device_type`` for prediction."""
    return Booster(params=params, model_str=text)


def dataset_from_arrays(binned: np.ndarray, mappers: Sequence[dict],
                        group_features: Sequence[int], label,
                        weight=None, feature_names: Optional[List[str]] = None,
                        params: Optional[Dict[str, Any]] = None
                        ) -> BinnedDataset:
    """A port BinnedDataset over an already-binned (N, G) matrix."""
    binned = np.ascontiguousarray(binned)
    if binned.dtype != np.uint8:
        raise NotImplementedError("lightgbm_tpu_torch trains uint8 bins only")
    ds = BinnedDataset(Config(params or {}))
    ds.num_data = binned.shape[0]
    ds.bin_mappers = [BinMapper.from_dict(m) for m in mappers]
    ds.num_total_features = len(ds.bin_mappers)
    ds.feature_names = list(feature_names or [
        f"Column_{i}" for i in range(ds.num_total_features)])
    ds.used_features = [f for f, bm in enumerate(ds.bin_mappers)
                        if not bm.is_trivial]
    ds.groups = groups_from_order(ds.bin_mappers, group_features)
    if binned.shape[1] != len(ds.groups):
        raise ValueError(f"binned has {binned.shape[1]} columns for "
                         f"{len(ds.groups)} groups")
    ds.binned = binned
    ds.metadata = Metadata(ds.num_data)
    ds.metadata.set_label(label)
    ds.metadata.set_weight(weight)
    return ds
