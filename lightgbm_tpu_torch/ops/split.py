"""Best-split search semantics, as plain PyTorch on f32 tensors.

Port of lightgbm_tpu/ops/split.py for the all-numerical path:
``leaf_output`` / ``leaf_gain`` (reference: feature_histogram.hpp
CalculateSplittedLeafOutput:717, GetLeafGain:800) and
``find_best_split_fast``, the one-leaf search whose semantics the pair
kernel (ops/split_pair.py) reproduces for two sibling leaves:

  * forward scan (missing right) and reverse scan (missing left) with
    MissingType::Zero default-bin skipping and the NaN-bin exclusion;
  * the reference's scan-order tie-breaking as a flat candidate order
    (per feature the reverse scan's thresholds descending, then the
    forward scan's ascending; smaller feature first): the first maximum
    wins;
  * counts ride f32 (exact below 2^24 rows).

Every operation stays in f32: Python-float parameters combine with f32
tensors without promotion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

K_EPSILON = 1e-15

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


class SplitContext(NamedTuple):
    """Static per-feature metadata, (F,) int32 tensors."""
    num_bin: torch.Tensor
    missing_type: torch.Tensor
    default_bin: torch.Tensor


class BestSplit(NamedTuple):
    gain: torch.Tensor
    feature: torch.Tensor
    threshold: torch.Tensor
    default_left: torch.Tensor
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    left_count: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def threshold_l1(s, l1: float):
    mag = torch.clamp(torch.abs(s) - l1, min=0.0)
    return torch.where(s < 0, -mag, mag)


def leaf_output(sum_g, sum_h, l1: float, l2: float, max_delta_step: float):
    ret = -threshold_l1(sum_g, l1) / (sum_h + l2)
    if max_delta_step > 0:
        ret = torch.clamp(ret, -max_delta_step, max_delta_step)
    return ret


def leaf_gain(sum_g, sum_h, l1: float, l2: float, max_delta_step: float):
    s = threshold_l1(sum_g, l1)
    if max_delta_step > 0:
        out = leaf_output(sum_g, sum_h, l1, l2, max_delta_step)
        return -(2.0 * s * out + (sum_h + l2) * out * out)
    return s * s / (sum_h + l2)


SCAN_LANES = 32     # lanes of the pair kernel's warp scan
SCAN_BINS = 8       # bins a lane holds (256 bins / 32 lanes)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis of an f32 tensor, in f64
    with the pair kernel's blocked association (csrc/split_pair.cu), and
    rounded to f32 per bin, so the two agree bit for bit on the CPU and
    on the card.  The axis is padded with zeros to 32 lanes of at least
    8 bins; each lane's bins are summed from the left, the 32 lane totals
    scanned in 5 shifted-add steps, and each lane's exclusive offset
    added to its bins.  Elementwise f64 adds only (``torch.cumsum`` leaves
    its order on the card unspecified).  (A plain f32 scan over 256 bins
    rounds away low bits of the leaf totals; the f64 sums keep the prefix
    sums within one f32 rounding of the exact ones.)"""
    n = x.shape[-1]
    per = max(SCAN_BINS, -(-n // SCAN_LANES))
    xd = torch.nn.functional.pad(x.double(), (0, SCAN_LANES * per - n))
    xd = xd.view(*x.shape[:-1], SCAN_LANES, per)
    loc = [xd[..., 0]]
    for j in range(1, per):
        loc.append(loc[-1] + xd[..., j])
    tot = loc[-1]
    lane = torch.arange(SCAN_LANES, device=x.device)
    d = 1
    while d < SCAN_LANES:
        up = torch.nn.functional.pad(tot[..., :-d], (d, 0))
        tot = torch.where(lane >= d, tot + up, tot)
        d *= 2
    off = torch.nn.functional.pad(tot[..., :-1], (1, 0))
    out = off[..., None] + torch.stack(loc, dim=-1)
    return out.reshape(*x.shape[:-1], SCAN_LANES * per)[..., :n].float()


def find_best_split_fast(feat_hist, ctx: SplitContext, sum_g, sum_h,
                         num_data, l1: float, l2: float,
                         max_delta_step: float, min_gain_to_split: float,
                         min_data_in_leaf: int, min_sum_hessian: float,
                         feature_mask=None) -> BestSplit:
    """Best numerical split of one leaf from its (F, BF, 2) histogram."""
    F, BF, _ = feat_hist.shape
    dev = feat_hist.device
    G = feat_hist[..., 0]
    H = feat_hist[..., 1]
    f32 = torch.float32
    sum_g = torch.as_tensor(sum_g, dtype=f32, device=dev)
    sum_h_tot = torch.as_tensor(sum_h, dtype=f32, device=dev) + 2 * K_EPSILON
    num_data = torch.as_tensor(num_data, device=dev).to(f32)
    cnt_factor = num_data / sum_h_tot
    bins = torch.arange(BF, device=dev, dtype=torch.int32)[None, :]
    nb = ctx.num_bin[:, None]
    missing = ctx.missing_type[:, None]
    dflt = ctx.default_bin[:, None]
    in_range = bins < nb
    is_zero = missing == MISSING_ZERO
    is_nan = missing == MISSING_NAN
    two_scan = (nb > 2) & (missing != MISSING_NONE)
    cnt_bin = torch.floor(H * cnt_factor + 0.5) * in_range
    mask_f = in_range & ~(is_zero & (bins == dflt))
    bmax = nb - 1 - (is_nan & two_scan).to(torch.int32)
    mask_r = in_range & ~(two_scan & is_zero & (bins == dflt)) & (bins <= bmax)
    z = torch.zeros((), dtype=f32, device=dev)
    cs = prefix_sum(torch.stack([
        torch.where(mask_f, G, z), torch.where(mask_f, H, z),
        torch.where(mask_f, cnt_bin, z), torch.where(mask_r, G, z),
        torch.where(mask_r, H, z), torch.where(mask_r, cnt_bin, z)]))
    lg_f, lh_f, lc_f = cs[0], cs[1] + K_EPSILON, cs[2]
    rg_f, rh_f, rc_f = sum_g - lg_f, sum_h_tot - lh_f, num_data - lc_f
    rg_r = cs[3, :, -1:] - cs[3]
    rh_r = cs[4, :, -1:] - cs[4] + K_EPSILON
    rc_r = cs[5, :, -1:] - cs[5]
    lg_r, lh_r, lc_r = sum_g - rg_r, sum_h_tot - rh_r, num_data - rc_r
    args = (l1, l2, max_delta_step)
    gain_f = leaf_gain(lg_f, lh_f, *args) + leaf_gain(rg_f, rh_f, *args)
    gain_r = leaf_gain(lg_r, lh_r, *args) + leaf_gain(rg_r, rh_r, *args)
    min_gain_shift = leaf_gain(sum_g, sum_h_tot, *args) + min_gain_to_split
    mdl = float(min_data_in_leaf)

    def common_valid(lc, rc, lh, rh):
        return ((lc >= mdl) & (rc >= mdl) & (lh >= min_sum_hessian)
                & (rh >= min_sum_hessian))

    valid_f = (two_scan & in_range & (bins <= nb - 2)
               & ~(is_zero & (bins == dflt))
               & common_valid(lc_f, rc_f, lh_f, rh_f)
               & (gain_f > min_gain_shift))
    valid_r = (in_range & (bins <= bmax - 1)
               & ~(two_scan & is_zero & (bins == dflt - 1))
               & common_valid(lc_r, rc_r, lh_r, rh_r)
               & (gain_r > min_gain_shift))
    if feature_mask is not None:
        valid_f &= feature_mask[:, None]
        valid_r &= feature_mask[:, None]
    neg = torch.tensor(float("-inf"), dtype=f32, device=dev)
    gains = torch.cat([torch.where(valid_r, gain_r, neg).flip(1),
                       torch.where(valid_f, gain_f, neg)], dim=1)
    dl_r = (two_scan | ~is_nan).to(f32).expand(F, BF)
    stats = torch.stack([
        torch.cat([lg_r.flip(1), lg_f], 1), torch.cat([lh_r.flip(1), lh_f], 1),
        torch.cat([lc_r.flip(1), lc_f], 1),
        torch.cat([dl_r, torch.zeros_like(dl_r)], 1)]).reshape(4, -1)
    flat = gains.reshape(-1)
    widx = int(torch.argmax(flat))     # first maximum
    best_gain = flat[widx]
    lg, lh, lc, dl = stats[:, widx]
    best_f, r = divmod(widx, 2 * BF)
    best_t = BF - 1 - r if r < BF else r - BF
    rg, rh, rc = sum_g - lg, sum_h_tot - lh, num_data - lc
    gi = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return BestSplit(
        gain=torch.where(best_gain > neg, best_gain - min_gain_shift, neg),
        feature=gi(best_f), threshold=gi(best_t), default_left=dl > 0.5,
        left_sum_g=lg, left_sum_h=lh - K_EPSILON,
        right_sum_g=rg, right_sum_h=rh - K_EPSILON,
        left_count=lc.to(torch.int32), right_count=rc.to(torch.int32),
        left_output=leaf_output(lg, lh, *args),
        right_output=leaf_output(rg, rh, *args))
