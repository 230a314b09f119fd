"""Binned training data: per-feature bin mappers and the packed bin matrix.

Port of the host construction path of lightgbm_tpu/dataset.py (the
``construct_device=off`` oracle of ops/construct.py): bin finding from a
row sample, EFB candidate grouping, and the packed (num_data, num_groups)
uint8 matrix.  Bins and group order are bit-identical to the JAX
package.  This slice trains all-numerical data without EFB bundles:
a dataset whose features would bundle raises NotImplementedError, so the
learner's per-feature histogram view is the plain per-group slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .config import Config
from .ops.binning import BinMapper
from .utils import log


class Metadata:
    """Per-row side data: label / weight / init_score
    (reference: include/LightGBM/dataset.h Metadata)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label) -> None:
        arr = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(arr) != self.num_data:
            log.fatal("Length of label (%d) != num_data (%d)", len(arr),
                      self.num_data)
        self.label = arr

    def set_weight(self, weight) -> None:
        if weight is None:
            self.weight = None
            return
        arr = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(arr) != self.num_data:
            log.fatal("Length of weight (%d) != num_data (%d)", len(arr),
                      self.num_data)
        self.weight = arr

    def set_init_score(self, init_score) -> None:
        self.init_score = (None if init_score is None else
                           np.asarray(init_score, np.float64).reshape(-1))


class FeatureGroupInfo:
    """One packed bin column (reference: feature_group.h FeatureGroup).
    In this slice every group holds exactly one feature."""

    def __init__(self, feature_indices: List[int], num_total_bin: int,
                 bin_offsets: List[int]):
        self.feature_indices = feature_indices
        self.num_total_bin = num_total_bin
        self.bin_offsets = bin_offsets


class BinnedDataset:
    """The training matrix in binned form (reference: dataset.h Dataset)."""

    def __init__(self, config: Config):
        self.config = config
        self.num_data = 0
        self.num_total_features = 0
        self.feature_names: List[str] = []
        self.bin_mappers: List[BinMapper] = []
        self.used_features: List[int] = []
        self.groups: List[FeatureGroupInfo] = []
        self.binned: Optional[np.ndarray] = None     # (num_data, G) uint8
        self.metadata: Optional[Metadata] = None

    # -- construction ---------------------------------------------------
    @staticmethod
    def from_matrix(data, config: Config, label=None, weight=None,
                    init_score=None,
                    feature_names: Optional[List[str]] = None,
                    reference: Optional["BinnedDataset"] = None
                    ) -> "BinnedDataset":
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("Data must be 2-dimensional")
        ds = BinnedDataset(config)
        ds.num_data, ds.num_total_features = data.shape
        ds.feature_names = feature_names or [
            f"Column_{i}" for i in range(ds.num_total_features)]
        ds.metadata = Metadata(ds.num_data)
        if label is not None:
            ds.metadata.set_label(label)
        ds.metadata.set_weight(weight)
        ds.metadata.set_init_score(init_score)
        if reference is not None:
            ds.bin_mappers = reference.bin_mappers
            ds.used_features = reference.used_features
            ds.groups = reference.groups
            ds.feature_names = reference.feature_names
        else:
            ds._construct_mappers(data)
            ds._build_groups(data)
        ds.binned = ds.bin_matrix(data)
        return ds

    def _construct_mappers(self, data: np.ndarray) -> None:
        """Bin boundaries from a row sample (reference:
        DatasetLoader::ConstructBinMappersFromTextData; the JAX
        package's per-feature host loop)."""
        cfg = self.config
        n = self.num_data
        sample_cnt = min(n, cfg.bin_construct_sample_cnt)
        rng = np.random.RandomState(cfg.data_random_seed)
        if sample_cnt < n:
            sample_idx = np.sort(rng.choice(n, size=sample_cnt,
                                            replace=False))
        else:
            sample_idx = np.arange(n)
        max_bin_by_feature = None
        if cfg.max_bin_by_feature:
            max_bin_by_feature = [int(x) for x in
                                  str(cfg.max_bin_by_feature).split(",")]
        filter_cnt = int(cfg.min_data_in_leaf * sample_cnt / max(n, 1))
        self.bin_mappers = []
        for f in range(self.num_total_features):
            col = np.asarray(data[sample_idx, f], dtype=np.float64)
            nonzero = col[(np.abs(col) > 1e-35) | np.isnan(col)]
            mb = (max_bin_by_feature[f] if max_bin_by_feature
                  and f < len(max_bin_by_feature) else cfg.max_bin)
            bm = BinMapper()
            bm.find_bin(nonzero, total_sample_cnt=len(col), max_bin=mb,
                        min_data_in_bin=cfg.min_data_in_bin,
                        min_split_data=filter_cnt,
                        pre_filter=cfg.feature_pre_filter,
                        use_missing=cfg.use_missing,
                        zero_as_missing=cfg.zero_as_missing)
            self.bin_mappers.append(bm)
        self.used_features = [f for f in range(self.num_total_features)
                              if not self.bin_mappers[f].is_trivial]
        if not self.used_features:
            log.warning("There are no meaningful features which satisfy "
                        "the provided configuration.")

    def _build_groups(self, data: np.ndarray) -> None:
        """EFB grouping (reference: dataset.cpp FindGroups): dense
        features first, then the sparse candidates in the greedy
        coloring's order.  Any multi-feature bundle raises."""
        self.groups = []
        sparse, dense = [], []
        for f in self.used_features:
            bm = self.bin_mappers[f]
            if (self.config.enable_bundle and bm.most_freq_bin == 0
                    and bm.default_bin == 0):
                sparse.append(f)
            else:
                dense.append(f)
        for f in dense:
            self.groups.append(FeatureGroupInfo(
                [f], self.bin_mappers[f].num_bin, [0]))
        if not sparse:
            return
        n = self.num_data
        rng = np.random.RandomState(self.config.data_random_seed)
        sample = (rng.choice(n, size=50000, replace=False) if n > 50000
                  else np.arange(n))
        nz = {f: self.bin_mappers[f].values_to_bins(data[sample, f])
              != self.bin_mappers[f].most_freq_bin for f in sparse}
        counts = {f: int(nz[f].sum()) for f in sparse}
        order = sorted(sparse, key=lambda f: -counts[f])
        bundles: List[List[int]] = []
        masks: List[np.ndarray] = []
        nbins: List[int] = []
        max_search = 100
        for f in order:
            nb_add = self.bin_mappers[f].num_bin - 1
            probe = (range(len(bundles)) if len(bundles) <= max_search
                     else rng.choice(len(bundles), size=max_search,
                                     replace=False))
            for bi in probe:
                if nbins[bi] + nb_add > 256:
                    continue
                if int((masks[bi] & nz[f]).sum()) == 0:
                    raise NotImplementedError(
                        "lightgbm_tpu_torch does not support EFB bundles "
                        f"yet (features {bundles[bi]} and {f} would "
                        "bundle); pass enable_bundle=False")
            bundles.append([f])
            masks.append(nz[f].copy())
            nbins.append(1 + nb_add)
        for (f,) in bundles:
            self.groups.append(FeatureGroupInfo(
                [f], self.bin_mappers[f].num_bin, [0]))

    def bin_matrix(self, data) -> np.ndarray:
        """Bin raw rows with this dataset's mappers into the packed
        (n, num_groups) uint8 layout."""
        data = np.asarray(data)
        if self.max_group_bins > 256:
            raise NotImplementedError(
                "lightgbm_tpu_torch trains uint8 bins only (max_bin <= 256)")
        out = np.zeros((data.shape[0], len(self.groups)), dtype=np.uint8)
        for g, grp in enumerate(self.groups):
            f = grp.feature_indices[0]
            out[:, g] = self.bin_mappers[f].values_to_bins(data[:, f])
        return out

    # -- views used by the tree learner ---------------------------------
    def feature_meta_arrays(self) -> Dict[str, np.ndarray]:
        """Per used-feature metadata, enumerated in group order."""
        feats = [grp.feature_indices[0] for grp in self.groups]
        bms = [self.bin_mappers[f] for f in feats]
        return {
            "feature": np.asarray(feats, dtype=np.int32),
            "group": np.arange(len(feats), dtype=np.int32),
            "num_bin": np.asarray([b.num_bin for b in bms], np.int32),
            "missing_type": np.asarray([b.missing_type for b in bms],
                                       np.int32),
            "default_bin": np.asarray([b.default_bin for b in bms],
                                      np.int32),
        }

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def max_group_bins(self) -> int:
        return max((g.num_total_bin for g in self.groups), default=2)


def groups_from_order(bin_mappers: Sequence[BinMapper],
                      group_features: Sequence[int]
                      ) -> List[FeatureGroupInfo]:
    """Singleton groups in a given feature order (used by convert.py)."""
    return [FeatureGroupInfo([int(f)], bin_mappers[int(f)].num_bin, [0])
            for f in group_features]
