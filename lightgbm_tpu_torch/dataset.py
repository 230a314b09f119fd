"""Binned training data: per-feature bin mappers and the packed bin matrix.

Port of the host construction path of lightgbm_tpu/dataset.py (the
``construct_device=off`` oracle of ops/construct.py): bin finding from a
row sample, EFB candidate grouping, and the packed (num_data, num_groups)
matrix: uint8 while every group has at most 256 bins, else uint16 for
the whole matrix (JAX ``_bin_dtype``: ``max_bin`` or
``max_bin_by_feature`` past 255, or a categorical of more than 256
levels).  Bins and group order are bit-identical to the JAX package.
Features that are mutually exclusive in the sample share one column (an
EFB bundle); the learner then reads its per-feature
histograms through ops/feat_view.py, which rebuilds each bundled
feature's default bin from the leaf's totals.  Categorical features
(``categorical_features``, column indices) get the JAX package's
most-frequent-first mappers and bundle by the same rule as the rest.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .config import Config
from .ops.binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper
from .utils import log


class Metadata:
    """Per-row side data: label / weight / query groups / positions /
    init_score (reference: include/LightGBM/dataset.h Metadata; JAX
    dataset.py ``Metadata``)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # int32 [nq+1]
        self.init_score: Optional[np.ndarray] = None
        self.positions: Optional[np.ndarray] = None         # int32 ids/row
        self.position_ids: Optional[List[str]] = None       # id -> label

    def set_position(self, position) -> None:
        """Per-row presentation positions for unbiased lambdarank
        (reference: Metadata::SetPosition), factorized to compact ids in
        order of first appearance."""
        if position is None:
            self.positions = None
            self.position_ids = None
            return
        vals = np.asarray(position).reshape(-1)
        if vals.shape[0] != self.num_data:
            log.fatal("Length of position (%d) != num_data (%d)",
                      vals.shape[0], self.num_data)
        uniq, first, inv = np.unique(vals, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        remap = np.empty(len(uniq), dtype=np.int32)
        remap[order] = np.arange(len(uniq), dtype=np.int32)
        self.positions = remap[inv.reshape(-1)]
        self.position_ids = [str(uniq[o]) for o in order]

    def set_group(self, group) -> None:
        """Per-query sizes (the reference's query counts), in row order."""
        if group is None:
            self.query_boundaries = None
            return
        arr = np.asarray(group, dtype=np.int64).reshape(-1)
        if arr.sum() != self.num_data:
            log.fatal("Sum of query counts (%d) != num_data (%d)", arr.sum(),
                      self.num_data)
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(arr)]).astype(np.int32)

    @property
    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)

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


# an EFB bundle's bins stay within one uint8 column (JAX dataset.py
# _bundle_greedy's max_group_bins); a feature of more bins stands alone
# in its group, and the matrix is then uint16
MAX_GROUP_BINS = 256


class FeatureGroupInfo:
    """One packed bin column (reference: feature_group.h FeatureGroup):
    one feature, or an EFB bundle of several with their bin offsets."""

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
        # (num_data, G), uint8 or uint16 (``bin_dtype``)
        self.binned: Optional[np.ndarray] = None
        # linear trees: the raw matrix, f32 and contiguous (JAX
        # ``raw_data``), which the leaf fits and the linear score
        # updates read
        self.raw_data: Optional[np.ndarray] = None
        self.metadata: Optional[Metadata] = None

    # -- construction ---------------------------------------------------
    @staticmethod
    def from_matrix(data, config: Config, label=None, weight=None,
                    init_score=None,
                    feature_names: Optional[List[str]] = None,
                    categorical_features: Optional[Sequence[int]] = None,
                    reference: Optional["BinnedDataset"] = None,
                    group=None, position=None) -> "BinnedDataset":
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
        ds.metadata.set_group(group)
        ds.metadata.set_init_score(init_score)
        ds.metadata.set_position(position)
        if reference is not None:
            ds.bin_mappers = reference.bin_mappers
            ds.used_features = reference.used_features
            ds.groups = reference.groups
            ds.feature_names = reference.feature_names
            ds.binned = ds.bin_matrix(data)
        else:
            ds._construct_mappers(data, categorical_features or [])
            cols = ds._used_columns(data)
            ds._build_groups(cols)
            ds.binned = ds._pack_groups(cols, ds.num_data)
        if config.linear_tree:
            ds.raw_data = np.ascontiguousarray(data, dtype=np.float32)
        return ds

    def _construct_mappers(self, data: np.ndarray,
                           categorical_features: Sequence[int]) -> None:
        """Bin boundaries from a row sample (reference:
        DatasetLoader::ConstructBinMappersFromTextData; the JAX
        package's per-feature host loop); the columns in
        ``categorical_features`` get categorical mappers."""
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
        cat_set = set(int(c) for c in categorical_features)
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
                        bin_type=(BIN_CATEGORICAL if f in cat_set
                                  else BIN_NUMERICAL),
                        use_missing=cfg.use_missing,
                        zero_as_missing=cfg.zero_as_missing)
            self.bin_mappers.append(bm)
        self.used_features = [f for f in range(self.num_total_features)
                              if not self.bin_mappers[f].is_trivial]
        if not self.used_features:
            log.warning("There are no meaningful features which satisfy "
                        "the provided configuration.")

    def _used_columns(self, data: np.ndarray) -> Dict[int, np.ndarray]:
        """Each used feature's bins over all rows: uint8, or uint16 for a
        feature of more than 256 bins."""
        out = {}
        for f in self.used_features:
            bm = self.bin_mappers[f]
            dtype = np.uint8 if bm.num_bin <= MAX_GROUP_BINS else np.uint16
            out[f] = bm.values_to_bins(data[:, f]).astype(dtype)
        return out

    def _build_groups(self, cols: Dict[int, np.ndarray]) -> None:
        """EFB grouping (JAX dataset.py ``_build_groups`` /
        ``_bundle_sparse``; reference: dataset.cpp FindGroups).  A feature
        whose most frequent and default bins are both 0 is a candidate;
        the others are dense and come first, one group each.  The
        candidates bundle by the greedy coloring of ``_bundle_greedy``
        over their non-default rows in a sample of at most 50,000 rows,
        drawn with the JAX package's rng consumption: one ``choice`` for
        the sample, then the probe draws."""
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
        nz = {f: cols[f][sample] != self.bin_mappers[f].most_freq_bin
              for f in sparse}
        self._bundle_greedy(sparse, nz, rng)

    def _bundle_greedy(self, sparse: List[int], nz: Dict[int, np.ndarray],
                       rng) -> None:
        """The greedy coloring (JAX dataset.py ``_bundle_greedy``): in
        the order of falling non-default counts, a feature joins the first
        bundle it has no common non-default row with (max_conflict_rate
        0) and whose bins stay within 256; with more than 100 bundles it
        probes 100 drawn at random.  A bundle's column: bin 0 is every
        feature at its default, feature i takes ``[offset_i, offset_i +
        num_bin_i - 1)``."""
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
                if nbins[bi] + nb_add > MAX_GROUP_BINS:
                    continue
                if int((masks[bi] & nz[f]).sum()) == 0:
                    bundles[bi].append(f)
                    masks[bi] |= nz[f]
                    nbins[bi] += nb_add
                    break
            else:
                bundles.append([f])
                masks.append(nz[f].copy())
                nbins.append(1 + nb_add)
        for bundle in bundles:
            bundle.sort()
            if len(bundle) == 1:
                f = bundle[0]
                self.groups.append(FeatureGroupInfo(
                    [f], self.bin_mappers[f].num_bin, [0]))
                continue
            offsets, cur = [], 1
            for f in bundle:
                offsets.append(cur)
                bm = self.bin_mappers[f]
                cur += bm.num_bin - (1 if bm.most_freq_bin == 0 else 0)
            self.groups.append(FeatureGroupInfo(bundle, cur, offsets))

    def bin_matrix(self, data) -> np.ndarray:
        """Bin raw rows with this dataset's mappers into the packed
        (n, num_groups) layout of ``bin_dtype`` (validation sets get the
        training set's groups)."""
        return self._pack_groups(self._used_columns(np.asarray(data)),
                                 np.shape(data)[0])

    def _pack_groups(self, cols: Dict[int, np.ndarray], n: int
                     ) -> np.ndarray:
        """Per-feature bin columns packed into the (n, num_groups) matrix of
        ``bin_dtype`` (JAX dataset.py ``_pack_groups``): in a bundle, a
        feature's bins other than its most frequent shift by its offset
        (minus 1 when that bin is 0), and a row where two features
        conflict takes the later feature's bin."""
        out = np.zeros((n, len(self.groups)), dtype=self.bin_dtype)
        for g, grp in enumerate(self.groups):
            if len(grp.feature_indices) == 1:
                out[:, g] = cols[grp.feature_indices[0]]
                continue
            acc = np.zeros(n, dtype=np.int32)
            for f, offset in zip(grp.feature_indices, grp.bin_offsets):
                bm = self.bin_mappers[f]
                c = np.asarray(cols[f], dtype=np.int32)
                shifted = c + offset - (1 if bm.most_freq_bin == 0 else 0)
                acc = np.where(c != bm.most_freq_bin, shifted, acc)
            out[:, g] = acc
        return out

    # -- views used by the tree learner ---------------------------------
    def feature_meta_arrays(self) -> Dict[str, np.ndarray]:
        """Per used-feature metadata, enumerated in (group, sub-feature)
        order (JAX dataset.py ``feature_meta_arrays``): a bundled
        feature's bin b other than its default lives at column bin
        ``bin_start + b`` of its group."""
        feats, group, bin_start = [], [], []
        for g, grp in enumerate(self.groups):
            for f, offset in zip(grp.feature_indices, grp.bin_offsets):
                bm = self.bin_mappers[f]
                feats.append(f)
                group.append(g)
                bin_start.append(0 if len(grp.feature_indices) == 1 else
                                 offset - (1 if bm.most_freq_bin == 0
                                           else 0))
        bms = [self.bin_mappers[f] for f in feats]
        return {
            "feature": np.asarray(feats, dtype=np.int32),
            "group": np.asarray(group, dtype=np.int32),
            "bin_start": np.asarray(bin_start, dtype=np.int32),
            "num_bin": np.asarray([b.num_bin for b in bms], np.int32),
            "missing_type": np.asarray([b.missing_type for b in bms],
                                       np.int32),
            "default_bin": np.asarray([b.default_bin for b in bms],
                                      np.int32),
            "is_categorical": np.asarray(
                [int(b.bin_type == BIN_CATEGORICAL) for b in bms], np.int32),
        }

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def max_group_bins(self) -> int:
        return max((g.num_total_bin for g in self.groups), default=2)

    @property
    def bin_dtype(self):
        """The bin matrix's dtype (JAX dataset.py ``_bin_dtype``): uint8
        while every group has at most 256 bins, else uint16."""
        return np.uint8 if self.max_group_bins <= 256 else np.uint16


def groups_from_spec(groups: Sequence) -> List[FeatureGroupInfo]:
    """Groups from ``(features, bin_offsets, num_total_bin)`` triples, as
    the JAX package's ``FeatureGroupInfo`` holds them (used by
    convert.py)."""
    return [FeatureGroupInfo([int(f) for f in feats], int(total),
                             [int(o) for o in offsets])
            for feats, offsets, total in groups]
