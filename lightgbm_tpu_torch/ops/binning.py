"""Feature binning (host side, NumPy).

A copy of lightgbm_tpu/ops/binning.py, kept here so the port imports
nothing of the JAX package; the bins it produces are bit-identical.

Re-implementation of the reference BinMapper
(src/io/bin.cpp:78-505, include/LightGBM/bin.h:84-259): density-aware greedy
equal-count binning from sampled values, zero-as-a-bin handling, missing-value
handling (None/Zero/NaN), and most-frequent-first categorical bins.
Forced bin bounds are not carried over.

Binning runs once on the host at Dataset construction; the result is a packed
integer bin matrix that lives in device memory for the whole training run.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from ..utils import log

# reference: include/LightGBM/meta.h:50-56
K_ZERO_THRESHOLD = 1e-35
K_EPSILON = 1e-15
K_SPARSE_THRESHOLD = 0.8  # reference: include/LightGBM/bin.h kSparseThreshold

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1


def _next_after_up(a: float) -> float:
    return math.nextafter(a, math.inf)


def _double_equal_ordered(a: float, b: float) -> bool:
    return b <= _next_after_up(a)


def greedy_find_bin(distinct_values: Sequence[float], counts: Sequence[int],
                    max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Greedy equal-count bin boundary search (reference: bin.cpp GreedyFindBin:78)."""
    num_distinct = len(distinct_values)
    bin_upper: List[float] = []
    assert max_bin > 0
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += counts[i]
            if cur_cnt >= min_data_in_bin:
                val = _next_after_up((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bin_upper or not _double_equal_ordered(bin_upper[-1], val):
                    bin_upper.append(val)
                    cur_cnt = 0
        bin_upper.append(math.inf)
        return bin_upper
    # more distinct values than bins: density-aware greedy packing
    if min_data_in_bin > 0:
        max_bin = min(max_bin, total_cnt // min_data_in_bin)
        max_bin = max(max_bin, 1)
    mean_bin_size = total_cnt / max_bin
    rest_bin_cnt = max_bin
    rest_sample_cnt = total_cnt
    is_big = [c >= mean_bin_size for c in counts]
    for i in range(num_distinct):
        if is_big[i]:
            rest_bin_cnt -= 1
            rest_sample_cnt -= counts[i]
    mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt > 0 else math.inf
    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin
    bin_cnt = 0
    lower_bounds[0] = distinct_values[0]
    cur_cnt = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= counts[i]
        cur_cnt += counts[i]
        if (is_big[i] or cur_cnt >= mean_bin_size or
                (is_big[i + 1] and cur_cnt >= max(1.0, mean_bin_size * 0.5))):
            upper_bounds[bin_cnt] = distinct_values[i]
            bin_cnt += 1
            lower_bounds[bin_cnt] = distinct_values[i + 1]
            if bin_cnt >= max_bin - 1:
                break
            cur_cnt = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt > 0 else math.inf
    bin_cnt += 1
    bin_upper = []
    for i in range(bin_cnt - 1):
        val = _next_after_up((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper or not _double_equal_ordered(bin_upper[-1], val):
            bin_upper.append(val)
    bin_upper.append(math.inf)
    return bin_upper


def find_bin_with_zero_as_one_bin(distinct_values: Sequence[float], counts: Sequence[int],
                                  max_bin: int, total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Bins with a dedicated zero bin (reference: bin.cpp FindBinWithZeroAsOneBin:242)."""
    num_distinct = len(distinct_values)
    left_cnt_data = 0
    cnt_zero = 0
    right_cnt_data = 0
    for i in range(num_distinct):
        if distinct_values[i] <= -K_ZERO_THRESHOLD:
            left_cnt_data += counts[i]
        elif distinct_values[i] > K_ZERO_THRESHOLD:
            right_cnt_data += counts[i]
        else:
            cnt_zero += counts[i]
    left_cnt = -1
    for i in range(num_distinct):
        if distinct_values[i] > -K_ZERO_THRESHOLD:
            left_cnt = i
            break
    if left_cnt < 0:
        left_cnt = num_distinct

    bin_upper: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        left_max_bin = int(left_cnt_data / max(total_sample_cnt - cnt_zero, 1) * (max_bin - 1))
        left_max_bin = max(1, left_max_bin)
        bin_upper = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                    left_max_bin, left_cnt_data, min_data_in_bin)
        if bin_upper:
            bin_upper[-1] = -K_ZERO_THRESHOLD

    right_start = -1
    for i in range(left_cnt, num_distinct):
        if distinct_values[i] > K_ZERO_THRESHOLD:
            right_start = i
            break
    right_max_bin = max_bin - 1 - len(bin_upper)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(distinct_values[right_start:], counts[right_start:],
                                       right_max_bin, right_cnt_data, min_data_in_bin)
        bin_upper.append(K_ZERO_THRESHOLD)
        bin_upper.extend(right_bounds)
    else:
        bin_upper.append(math.inf)
    assert len(bin_upper) <= max_bin
    return bin_upper


class BinMapper:
    """Maps one feature's raw values to integer bins (reference: bin.h:84)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: int = BIN_NUMERICAL
        self.bin_upper_bound: List[float] = []
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int = 3, min_split_data: int = 0,
                 pre_filter: bool = False, bin_type: int = BIN_NUMERICAL,
                 use_missing: bool = True,
                 zero_as_missing: bool = False) -> None:
        """Construct the bin mapping from sampled values (reference: bin.cpp:311).

        ``values`` are the sampled non-trivial values; zeros are implied by
        ``total_sample_cnt - len(values)`` like the reference's sparse sampling.
        """
        values = np.asarray(values, dtype=np.float64)
        na_cnt = int(np.isnan(values).sum())
        values = values[~np.isnan(values)]
        non_na_cnt = len(values)
        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            if na_cnt == 0:
                self.missing_type = MISSING_NONE
                na_cnt = 0
            else:
                self.missing_type = MISSING_NAN

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - non_na_cnt - na_cnt)
        # distinct values, with zero placed at its sorted position
        order = np.argsort(values, kind="stable")
        values = values[order]
        distinct_values: List[float] = []
        counts: List[int] = []
        if non_na_cnt == 0 or (values[0] > 0.0 and zero_cnt > 0):
            distinct_values.append(0.0)
            counts.append(zero_cnt)
        if non_na_cnt > 0:
            distinct_values.append(float(values[0]))
            counts.append(1)
        for i in range(1, non_na_cnt):
            prev, cur = float(values[i - 1]), float(values[i])
            if not _double_equal_ordered(prev, cur):
                if prev < 0.0 and cur > 0.0:
                    distinct_values.append(0.0)
                    counts.append(zero_cnt)
                distinct_values.append(cur)
                counts.append(1)
            else:
                distinct_values[-1] = cur  # use the larger value
                counts[-1] += 1
        if non_na_cnt > 0 and values[-1] < 0.0 and zero_cnt > 0:
            distinct_values.append(0.0)
            counts.append(zero_cnt)

        self.min_val = distinct_values[0] if distinct_values else 0.0
        self.max_val = distinct_values[-1] if distinct_values else 0.0
        cnt_in_bin: List[int] = []
        num_distinct = len(distinct_values)

        if bin_type == BIN_NUMERICAL:
            def bounds(mb, total):
                return find_bin_with_zero_as_one_bin(
                    distinct_values, counts, mb, total, min_data_in_bin)

            if self.missing_type == MISSING_ZERO:
                self.bin_upper_bound = bounds(max_bin, total_sample_cnt)
                if len(self.bin_upper_bound) == 2:
                    self.missing_type = MISSING_NONE
            elif self.missing_type == MISSING_NONE:
                self.bin_upper_bound = bounds(max_bin, total_sample_cnt)
            else:  # NaN: last bin reserved for NaN
                self.bin_upper_bound = bounds(max_bin - 1,
                                              total_sample_cnt - na_cnt)
                self.bin_upper_bound.append(math.nan)
            self.num_bin = len(self.bin_upper_bound)
            cnt_in_bin = [0] * self.num_bin
            i_bin = 0
            for i in range(num_distinct):
                while (i_bin < self.num_bin - 1 and
                       distinct_values[i] > self.bin_upper_bound[i_bin]):
                    i_bin += 1
                cnt_in_bin[i_bin] += counts[i]
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            # categorical: most-frequent-first bins, bin 0 = NaN/other
            distinct_int: List[int] = []
            counts_int: List[int] = []
            for v, c in zip(distinct_values, counts):
                iv = int(v)
                if iv < 0:
                    na_cnt += c
                    log.warning("Met negative value in categorical features, "
                                "will convert it to NaN")
                elif distinct_int and iv == distinct_int[-1]:
                    counts_int[-1] += c
                else:
                    distinct_int.append(iv)
                    counts_int.append(c)
            rest_cnt = total_sample_cnt - na_cnt
            self.num_bin = 1
            if rest_cnt > 0 and distinct_int:
                # sort by count descending (stable, like SortForPair)
                order2 = sorted(range(len(counts_int)),
                                key=lambda i: -counts_int[i])
                counts_int = [counts_int[i] for i in order2]
                distinct_int = [distinct_int[i] for i in order2]
                cut_cnt = int(round((total_sample_cnt - na_cnt) * 0.99))
                distinct_cnt = len(distinct_int) + (1 if na_cnt > 0 else 0)
                eff_max_bin = min(distinct_cnt, max_bin)
                self.bin_2_categorical = [-1]
                self.categorical_2_bin = {-1: 0}
                cnt_in_bin = [0]
                used_cnt = 0
                cur = 0
                while cur < len(distinct_int) and (used_cnt < cut_cnt or
                                                   self.num_bin < eff_max_bin):
                    if counts_int[cur] < min_data_in_bin and cur > 1:
                        break
                    self.bin_2_categorical.append(distinct_int[cur])
                    self.categorical_2_bin[distinct_int[cur]] = self.num_bin
                    used_cnt += counts_int[cur]
                    cnt_in_bin.append(counts_int[cur])
                    self.num_bin += 1
                    cur += 1
                if cur == len(distinct_int) and na_cnt == 0:
                    self.missing_type = MISSING_NONE
                else:
                    self.missing_type = MISSING_NAN
                cnt_in_bin[0] = int(total_sample_cnt - used_cnt)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and min_split_data > 0:
            if self._need_filter(cnt_in_bin, total_sample_cnt, min_split_data):
                self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = self.value_to_bin(0.0)
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            max_sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
            if self.most_freq_bin != self.default_bin and max_sparse_rate < K_SPARSE_THRESHOLD:
                self.most_freq_bin = self.default_bin
            self.sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
        else:
            self.sparse_rate = 1.0

    def _need_filter(self, cnt_in_bin: List[int], total_cnt: int,
                     filter_cnt: int) -> bool:
        """reference: bin.cpp NeedFilter:36."""
        if self.bin_type == BIN_NUMERICAL:
            sum_left = 0
            for i in range(len(cnt_in_bin) - 1):
                sum_left += cnt_in_bin[i]
                if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                    return False
            return True
        if len(cnt_in_bin) <= 2:
            for i in range(len(cnt_in_bin) - 1):
                sum_left = cnt_in_bin[i]
                if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                    return False
            return True
        return False

    # ------------------------------------------------------------------
    def value_to_bin(self, value: float) -> int:
        """Map one raw value to its bin (reference: bin.h ValueToBin:188)."""
        if self.bin_type == BIN_CATEGORICAL:
            if value is None or (isinstance(value, float) and math.isnan(value)):
                return 0
            return self.categorical_2_bin.get(int(value), 0)
        if value is None or math.isnan(value):
            if self.missing_type == MISSING_NAN:
                return self.num_bin - 1
            value = 0.0
        if (self.missing_type == MISSING_ZERO and
                -K_ZERO_THRESHOLD <= value <= K_ZERO_THRESHOLD):
            return self.default_bin
        # binary search over upper bounds
        lo, hi = 0, len(self.bin_upper_bound) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.bin_upper_bound[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def values_to_bins(self, values: np.ndarray,
                       oov_sentinel: bool = False) -> np.ndarray:
        """Vectorized ValueToBin over a column.

        oov_sentinel: categorical mappers only -- map out-of-vocabulary
        categories (and NaN) to the out-of-range bin ``num_bin`` instead
        of bin 0, a bin no category set holds, so a bin-space traversal
        sends them right as the reference's raw-value CategoricalDecision
        (tree.h) does.  Training and validation binning keep bin 0."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_CATEGORICAL:
            miss = np.int32(self.num_bin) if oov_sentinel else np.int32(0)
            if not self.categorical_2_bin:
                return np.full(values.shape, miss, dtype=np.int32)
            cats = np.array(list(self.categorical_2_bin.keys()), dtype=np.int64)
            bins = np.array(list(self.categorical_2_bin.values()), dtype=np.int32)
            iv = np.where(np.isnan(values), -1, values).astype(np.int64)
            sorter = np.argsort(cats)
            pos = np.searchsorted(cats[sorter], iv)
            pos = np.clip(pos, 0, len(cats) - 1)
            hit = cats[sorter[pos]] == iv
            return np.where(hit, bins[sorter[pos]], miss).astype(np.int32)
        nan_mask = np.isnan(values)
        vals = np.where(nan_mask, 0.0, values)
        bounds = np.asarray(self.bin_upper_bound, dtype=np.float64)
        n_search = len(bounds)
        if self.missing_type == MISSING_NAN:
            n_search -= 1  # last bound is NaN sentinel
        out = np.searchsorted(bounds[:max(n_search - 1, 0)], vals, side="left").astype(np.int32)
        # searchsorted(side=left) gives first idx with bounds[idx] >= v; LightGBM
        # uses v <= bound, identical for exact matches.
        if self.missing_type == MISSING_NAN:
            out = np.where(nan_mask, self.num_bin - 1, out)
        elif self.missing_type == MISSING_ZERO:
            zero = (vals >= -K_ZERO_THRESHOLD) & (vals <= K_ZERO_THRESHOLD)
            out = np.where(zero | nan_mask, self.default_bin, out)
        elif nan_mask.any():
            zero_bin = self.value_to_bin(0.0)
            out = np.where(nan_mask, zero_bin, out)
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative threshold value for a bin (used for model export)."""
        if self.bin_type == BIN_CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return self.bin_upper_bound[bin_idx]

    def bin_rep_values(self, width: int | None = None,
                       values: np.ndarray | None = None,
                       bins: np.ndarray | None = None) -> np.ndarray:
        """Per-bin representative raw value of the linear moment planes
        (JAX binning.py ``bin_rep_values``; linear_tree_mode
        leafwise_gain, ops/split_linear.py): with the raw training column
        ``values``, each bin's empirical mean of its finite values, else
        the bin's upper bound clipped to ``[min_val, max_val]``; 0 at the
        NaN bin and at the MISSING_ZERO default bin (missing rows carry
        no moment mass), and everywhere for a categorical or trivial
        mapper.  ``width`` right-pads with zeros.  ``bins``, when given, are
        ``values``' bins (``values_to_bins(values)``, as a Dataset holds
        them), which spares binning the column again.  f32."""
        n = self.num_bin
        out = np.zeros(max(int(width or 0), n), dtype=np.float32)
        if self.bin_type == BIN_CATEGORICAL or self.is_trivial:
            return out
        ub = np.asarray(self.bin_upper_bound, dtype=np.float64)[:n]
        hi = self.max_val if math.isfinite(self.max_val) else 0.0
        lo = self.min_val if math.isfinite(self.min_val) else 0.0
        ub = np.clip(np.nan_to_num(ub, nan=0.0, posinf=hi, neginf=lo),
                     min(lo, hi), max(lo, hi))
        out[:len(ub)] = ub.astype(np.float32)
        if values is not None and len(values):
            vals = np.asarray(values, dtype=np.float64).ravel()
            finite = np.isfinite(vals)
            if finite.any():
                bins = (self.values_to_bins(vals[finite]) if bins is None
                        else np.asarray(bins).ravel()[finite])
                cnt = np.bincount(bins, minlength=n).astype(np.float64)
                tot = np.bincount(bins, weights=vals[finite], minlength=n)
                filled = cnt[:n] > 0
                out[:n][filled] = (tot[:n][filled]
                                   / cnt[:n][filled]).astype(np.float32)
        if self.missing_type == MISSING_NAN:
            out[n - 1] = 0.0
        elif self.missing_type == MISSING_ZERO:
            out[self.default_bin] = 0.0
        return out

    def feature_info(self) -> str:
        """`feature_infos` entry for the model file (reference: gbdt_model_text)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_CATEGORICAL:
            cats = sorted(c for c in self.bin_2_categorical if c >= 0)
            return ":".join(str(c) for c in cats)
        return f"[{self.min_val:g}:{self.max_val:g}]"

    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "bin_upper_bound": list(self.bin_upper_bound),
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        bm = cls()
        bm.num_bin = d["num_bin"]
        bm.missing_type = d["missing_type"]
        bm.is_trivial = d["is_trivial"]
        bm.sparse_rate = d["sparse_rate"]
        bm.bin_type = d["bin_type"]
        bm.bin_upper_bound = list(d["bin_upper_bound"])
        bm.bin_2_categorical = list(d["bin_2_categorical"])
        bm.categorical_2_bin = {c: i for i, c in enumerate(bm.bin_2_categorical)}
        bm.min_val = d["min_val"]
        bm.max_val = d["max_val"]
        bm.default_bin = d["default_bin"]
        bm.most_freq_bin = d["most_freq_bin"]
        return bm
