"""Carry state from the JAX package into the port.

For a GBDT the state is the model and the binned data.  Nothing here
imports JAX: callers hand over plain text and numpy arrays.

``booster_from_model_string`` loads model text written by
``lightgbm_tpu`` (the port's own ``model_to_string`` writes the same
format, so it loads back there too).  ``dataset_from_arrays`` builds a
port ``BinnedDataset`` from the arrays of a JAX ``BinnedDataset``: its
binned matrix, its bin mappers as ``BinMapper.to_dict()`` dicts, its
groups (EFB bundles with their bin offsets) and the label -- so both
packages' learners can be fed identical bins.  The matrix is uint8, or
uint16 when a group has more than 256 bins, as the JAX package stores
it.  A mapper's ``bin_type``
says whether its feature is categorical (the dataset's
``feature_meta_arrays()["is_categorical"]`` follows from it), so JAX's
categorical mappers and their bins come across as they are.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .basic import Booster
from .config import Config
from .dataset import BinnedDataset, Metadata, groups_from_spec
from .ops.binning import BinMapper


def booster_from_model_string(text: str,
                              params: Optional[Dict[str, Any]] = None
                              ) -> Booster:
    """A port Booster for model text from either package; ``params``
    may set ``device_type`` for prediction."""
    return Booster(params=params, model_str=text)


def dataset_from_arrays(binned: np.ndarray, mappers: Sequence[dict],
                        groups: Sequence, label,
                        weight=None, feature_names: Optional[List[str]] = None,
                        params: Optional[Dict[str, Any]] = None
                        ) -> BinnedDataset:
    """A port BinnedDataset over an already-binned (N, G) matrix;
    ``groups`` one entry a column, the JAX dataset's group as
    ``(feature_indices, bin_offsets, num_total_bin)`` (a singleton is
    ``([f], [0], num_bin)``; dataset.py ``groups_from_spec``)."""
    binned = np.ascontiguousarray(binned)
    ds = BinnedDataset(Config(params or {}))
    ds.num_data = binned.shape[0]
    ds.bin_mappers = [BinMapper.from_dict(m) for m in mappers]
    ds.num_total_features = len(ds.bin_mappers)
    ds.feature_names = list(feature_names or [
        f"Column_{i}" for i in range(ds.num_total_features)])
    ds.used_features = [f for f, bm in enumerate(ds.bin_mappers)
                        if not bm.is_trivial]
    ds.groups = groups_from_spec(groups)
    if binned.shape[1] != len(ds.groups):
        raise ValueError(f"binned has {binned.shape[1]} columns for "
                         f"{len(ds.groups)} groups")
    if binned.dtype != ds.bin_dtype:
        raise ValueError(f"binned is {binned.dtype}; groups of up to "
                         f"{ds.max_group_bins} bins are "
                         f"{ds.bin_dtype.__name__}")
    ds.binned = binned
    ds.metadata = Metadata(ds.num_data)
    ds.metadata.set_label(label)
    ds.metadata.set_weight(weight)
    return ds
