// Best numerical split for two sibling leaves -- or for the C children of
// a frontier step in one launch -- on Hopper.
//
// Replaces the TPU kernel best_split_pair_pallas
// (lightgbm_tpu/ops/split_pallas.py).  Its plain PyTorch version is
// split_pair_plain in lightgbm_tpu_torch/ops/split_pair.py; the two run
// the same f32 operations in the same order (this file is compiled with
// --fmad=false) and the same f64 prefix sums (ops/split.py prefix_sum,
// blocked as below, rounded to f32 per bin), so they agree bit for bit
// with the plain version, on the CPU and on the card.
//
// What bounds it on this card: neither bytes nor operations.  The
// inputs are two (2F, BF) f32 histograms (57 KB at F=28, BF=256) and the
// work is a few thousand flops per row, four correctly rounded f32
// divisions a bin among them, so the kernel is launch- and
// latency-bound: its time is the longest chain of dependent steps one
// warp runs.  The design is one launch with no global scratch, no host
// round-trip and no serial loop over the bins:
//   one thread-block cluster per child (C of them, child c's rows at
//   c * F), of up to 8 blocks on 8 SMs; one
//   warp per work item, a (feature row, scan direction) pair -- the
//   forward and the reverse scan share no data, so two warps take a row
//   and each runs half the chain -- the warps striding over items when
//   2F exceeds 64.  A lane holds 8 consecutive bins (BF <= 256, bins
//   past BF zero; wider rows, uint16 data, take scan_best_wide: a lane
//   walks ceil(BF / 32) bins from device memory twice, with the same
//   association).  Each masked prefix sum (grad, hess and count of the
//   direction) is a local f64 scan over the lane's 8 bins, an exclusive
//   5-step shuffle scan of the 32 lane totals in f64, and a per-bin add
//   of the lane's offset rounded to f32.  Every lane then scores its
//   bins' candidates, and the warp reduces to its best by shuffles: the
//   maximum gain, then the minimum preference key among the candidates
//   that reach it (exact in any order).  The items reduce by the same
//   rule per warp, across a block's warps in shared memory, and across
//   the cluster's blocks through distributed shared memory -- the
//   reference's scan-order tie-break -- and one lane writes the 13
//   leafmat fields (int fields bitcast into f32).
//
// The monotone arm (the template's MONO, a launch argument: without
// monotone constraints it is not in the launched kernel): each child's
// outputs are clipped to its bounds (info columns IN_CMIN, IN_CMAX) and
// every gain, the leaf's shift among them, is taken at the clipped
// output; a candidate whose outputs go against its feature's direction
// (fmeta column FM_MONO) is not valid; the winner's outputs are clipped.
// One warp then takes both scans of a feature, so that the feature's best
// is known before it competes: with a penalty table (monotone_penalty by
// depth) a monotone feature's best gain relative to the shift is
// multiplied by the entry at the child's depth, JAX find_best_split's
// feature-level rule.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_BF 256                  // the register arm; wider: scan_best_wide
#define LANE_BINS 8                 // MAX_BF / 32
#define MAX_WARPS 8                 // warps a block
#define MAX_CLUSTER 8               // blocks a child (portable cluster)
#define K_EPS 1e-15f
#define BIG_KEY (1 << 30)
#define FULL 0xffffffffu

// fmeta / info columns (ops/split_pair.py FM_*, IN_*)
#define FM_NUM_BIN 0
#define FM_MISSING 1
#define FM_DEFAULT 2
#define FM_IS_CAT 3             // categorical: not scanned here
#define FM_MONO 4               // monotone direction: +1, -1 or 0
#define IN_SUM_G 0
#define IN_SUM_H 1
#define IN_NUM_DATA 2
#define IN_DEPTH 3
#define IN_MASK 4
#define IN_CMIN 5               // the child's output bounds (monotone)
#define IN_CMAX 6

struct Params {
  float l1, l2, max_delta_step, min_gain_to_split, min_data_in_leaf,
      min_sum_hessian;
  int max_depth;
};

__device__ __forceinline__ float thr_l1(float g, float l1) {
  float mag = fmaxf(0.0f, fabsf(g) - l1);
  return g < 0.0f ? -mag : mag;
}

__device__ __forceinline__ float leaf_out(float g, float h, const Params& p) {
  float ret = (-thr_l1(g, p.l1)) / (h + p.l2);
  if (p.max_delta_step > 0.0f)
    ret = fminf(fmaxf(ret, -p.max_delta_step), p.max_delta_step);
  return ret;
}

__device__ __forceinline__ float leaf_gain(float g, float h, const Params& p) {
  float s = thr_l1(g, p.l1);
  if (p.max_delta_step > 0.0f) {
    float out = leaf_out(g, h, p);
    return -((2.0f * s) * out + ((h + p.l2) * out) * out);
  }
  return (s * s) / (h + p.l2);
}

// The gain at a given output (GetLeafGainGivenOutput).
__device__ __forceinline__ float gain_given(float g, float h, float out,
                                           const Params& p) {
  const float s = thr_l1(g, p.l1);
  return -((2.0f * s) * out + ((h + p.l2) * out) * out);
}

__device__ __forceinline__ float clip_out(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The two children's gain of a candidate: the sum of their leaf gains, or
// (MONO) the gains at their outputs clipped to [cmin, cmax], -inf when
// the outputs go against the direction dir.
template <bool MONO>
__device__ __forceinline__ float pair_gain(float lg, float lh, float rg,
                                           float rh, const Params& p,
                                           float cmin, float cmax, int dir) {
  if (!MONO) return leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p);
  const float lo = clip_out(leaf_out(lg, lh, p), cmin, cmax);
  const float ro = clip_out(leaf_out(rg, rh, p), cmin, cmax);
  if ((dir > 0 && lo > ro) || (dir < 0 && lo < ro)) return -INFINITY;
  return gain_given(lg, lh, lo, p) + gain_given(rg, rh, ro, p);
}

// The leaf's own gain, the shift its candidates must beat: at its clipped
// output with MONO.
template <bool MONO>
__device__ __forceinline__ float shift_gain(float sg, float sh,
                                            const Params& p, float cmin,
                                            float cmax) {
  if (!MONO) return leaf_gain(sg, sh, p);
  return gain_given(sg, sh, clip_out(leaf_out(sg, sh, p), cmin, cmax), p);
}

// A candidate: its gain, preference key and left sums.  Candidates
// order by the larger gain, then the smaller key (keys are distinct).
struct Cand {
  float gain, lg, lh, lc;
  int key;
};

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.gain > b.gain || (a.gain == b.gain && a.key < b.key);
}

__device__ __forceinline__ Cand shfl_xor(const Cand& c, int m) {
  return {__shfl_xor_sync(FULL, c.gain, m), __shfl_xor_sync(FULL, c.lg, m),
          __shfl_xor_sync(FULL, c.lh, m), __shfl_xor_sync(FULL, c.lc, m),
          __shfl_xor_sync(FULL, c.key, m)};
}

// The best candidate of the warp, in every lane.
__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const Cand o = shfl_xor(c, m);
    if (better(o, c)) c = o;
  }
  return c;
}

// Inclusive prefix sums of one row's 256 bins, the lane's 8 in v:
// a local f64 scan, an exclusive shuffle scan of the lane totals, the
// lane's offset added per bin, rounded to f32 (ops/split.py prefix_sum).
// The local scan runs twice, for the lane total and then beside the
// offset, so that no array of doubles stays live across the shuffles.
__device__ __forceinline__ void row_scan(float (&v)[LANE_BINS], int lane) {
  double tot = (double)v[0];
#pragma unroll
  for (int j = 1; j < LANE_BINS; ++j) tot = tot + (double)v[j];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double u = __shfl_up_sync(FULL, tot, d);
    if (lane >= d) tot = tot + u;
  }
  double off = __shfl_up_sync(FULL, tot, 1);
  if (lane == 0) off = 0.0;
  double loc = (double)v[0];
  v[0] = (float)(off + loc);
#pragma unroll
  for (int j = 1; j < LANE_BINS; ++j) {
    loc = loc + (double)v[j];
    v[j] = (float)(off + loc);
  }
}

// The value at bin b of a scanned row, in every lane.
__device__ __forceinline__ float row_at(const float (&v)[LANE_BINS], int b) {
  float x = 0.0f;
#pragma unroll
  for (int j = 0; j < LANE_BINS; ++j)
    if (j == (b & (LANE_BINS - 1))) x = v[j];
  return __shfl_sync(FULL, x, b / LANE_BINS);
}

// The wide arm's pieces (scan_best_wide): one scan direction of one
// feature row, its metadata and thresholds.  They repeat scan_best's
// arithmetic operation for operation (the 8-bin arm keeps its own code,
// whose registers the struct would spill); both agree with
// split_pair_plain bit for bit.
struct ScanRow {
  int nb, dflt, bmax, key0, BF, dir;
  float sum_g, sum_h_tot, num_data, cnt_factor, mgs, mdl, cmin, cmax;
  bool zero_m, two_scan, fmask, depth_ok, reverse;
};

template <bool MONO>
__device__ __forceinline__ ScanRow scan_row(const int* __restrict__ fmeta,
                                            const float* __restrict__ info,
                                            int r, int f, bool reverse,
                                            int BF, const Params& p) {
  ScanRow m;
  m.nb = fmeta[r * 8 + FM_NUM_BIN];
  const int mtype = fmeta[r * 8 + FM_MISSING];
  m.dflt = fmeta[r * 8 + FM_DEFAULT];
  m.sum_g = info[r * 8 + IN_SUM_G];
  m.sum_h_tot = info[r * 8 + IN_SUM_H] + 2e-15f;
  m.num_data = info[r * 8 + IN_NUM_DATA];
  const float depth = info[r * 8 + IN_DEPTH];
  m.fmask = info[r * 8 + IN_MASK] > 0.0f && fmeta[r * 8 + FM_IS_CAT] == 0;
  m.cnt_factor = m.num_data / m.sum_h_tot;
  m.zero_m = mtype == 1;
  const bool nan_m = mtype == 2;
  m.two_scan = (m.nb > 2) && (mtype != 0);
  m.bmax = m.nb - 1 - ((nan_m && m.two_scan) ? 1 : 0);
  m.cmin = MONO ? info[r * 8 + IN_CMIN] : 0.0f;
  m.cmax = MONO ? info[r * 8 + IN_CMAX] : 0.0f;
  m.dir = MONO ? fmeta[r * 8 + FM_MONO] : 0;
  m.mgs = shift_gain<MONO>(m.sum_g, m.sum_h_tot, p, m.cmin, m.cmax) +
          p.min_gain_to_split;
  m.mdl = p.min_data_in_leaf;
  m.depth_ok = p.max_depth <= 0 || depth < (float)p.max_depth;
  m.key0 = f * (2 * BF);
  m.BF = BF;
  m.reverse = reverse;
  return m;
}

// Bin t's grad and hess (g, h) masked for the direction's scan, and its
// count n.
__device__ __forceinline__ void mask_bin(const ScanRow& m, int t, float& g,
                                         float& h, float& n) {
  const bool in_range = t < m.BF && t < m.nb;
  const bool at_dflt = t == m.dflt;
  const bool on = m.reverse ? in_range &&
                                  !(m.two_scan && m.zero_m && at_dflt) &&
                                  t <= m.bmax
                            : in_range && !(m.zero_m && at_dflt);
  n = on ? floorf(h * m.cnt_factor + 0.5f) : 0.0f;
  g = on ? g : 0.0f;
  h = on ? h : 0.0f;
}

// The candidate of threshold t < BF from the scanned sums at t (sg, sh,
// sn) and, for the reverse scan, the row's totals (tg, th, tn): the
// forward scan (missing values go right; left sums are the prefix sums;
// keys ascend with the threshold after the reverse scan's) or the
// reverse scan (missing values go left; right sums are the row's total
// minus the prefix sums; keys descend with the threshold).
template <bool MONO>
__device__ __forceinline__ Cand bin_cand(const ScanRow& m, const Params& p,
                                         int t, float sg, float sh, float sn,
                                         float tg, float th, float tn) {
  float lg, lh, lc, rg, rh, rc;
  bool allowed;
  int key;
  if (m.reverse) {
    rg = tg - sg;
    rh = (th - sh) + K_EPS;
    rc = tn - sn;
    lg = m.sum_g - rg;
    lh = m.sum_h_tot - rh;
    lc = m.num_data - rc;
    allowed = t < m.nb && t <= m.bmax - 1 &&
              !(m.two_scan && m.zero_m && t == m.dflt - 1);
    key = m.key0 + m.BF - 1 - t;
  } else {
    lg = sg;
    lh = sh + K_EPS;
    lc = sn;
    rg = m.sum_g - lg;
    rh = m.sum_h_tot - lh;
    rc = m.num_data - lc;
    allowed = m.two_scan && t < m.nb && t <= m.nb - 2 &&
              !(m.zero_m && t == m.dflt);
    key = m.key0 + m.BF + t;
  }
  const float gain = pair_gain<MONO>(lg, lh, rg, rh, p, m.cmin, m.cmax, m.dir);
  const bool ok = lc >= m.mdl && rc >= m.mdl && lh >= p.min_sum_hessian &&
                  rh >= p.min_sum_hessian;
  const bool valid = allowed && ok && gain > m.mgs && m.fmask && m.depth_ok;
  return Cand{valid ? gain : -INFINITY, lg, lh, lc, key};
}

// The best candidate of one scan direction of row r (child c, feature
// f), in every lane: the forward scan (missing values go right; left
// sums are the prefix sums; keys ascend with the threshold after the
// reverse scan's) or the reverse scan (missing values go left; right
// sums are the row's total minus the prefix sums; keys descend with the
// threshold).  The two need no data of each other, so two warps take
// them.
template <bool MONO>
__device__ __forceinline__ Cand scan_best(const float* __restrict__ hg,
                                          const float* __restrict__ hh,
                                          const int* __restrict__ fmeta,
                                          const float* __restrict__ info,
                                          int r, int f, bool reverse, int BF,
                                          const Params& p, int lane) {
  const int t0 = lane * LANE_BINS;
  // the lane's bins, read before the row's metadata arrives
  float sg[LANE_BINS], sh[LANE_BINS], sn[LANE_BINS];
#pragma unroll
  for (int j = 0; j < LANE_BINS; ++j) {
    const int t = t0 + j;
    sg[j] = t < BF ? hg[r * BF + t] : 0.0f;
    sh[j] = t < BF ? hh[r * BF + t] : 0.0f;
  }
  const int nb = fmeta[r * 8 + FM_NUM_BIN];
  const int mtype = fmeta[r * 8 + FM_MISSING];
  const int dflt = fmeta[r * 8 + FM_DEFAULT];
  const float sum_g = info[r * 8 + IN_SUM_G];
  const float sum_h_tot = info[r * 8 + IN_SUM_H] + 2e-15f;
  const float num_data = info[r * 8 + IN_NUM_DATA];
  const float depth = info[r * 8 + IN_DEPTH];
  const bool fmask =
      info[r * 8 + IN_MASK] > 0.0f && fmeta[r * 8 + FM_IS_CAT] == 0;
  const float cnt_factor = num_data / sum_h_tot;
  const bool zero_m = mtype == 1, nan_m = mtype == 2;
  const bool two_scan = (nb > 2) && (mtype != 0);
  const int bmax = nb - 1 - ((nan_m && two_scan) ? 1 : 0);
  const float cmin = MONO ? info[r * 8 + IN_CMIN] : 0.0f;
  const float cmax = MONO ? info[r * 8 + IN_CMAX] : 0.0f;
  const int dir = MONO ? fmeta[r * 8 + FM_MONO] : 0;
  const float mgs =
      shift_gain<MONO>(sum_g, sum_h_tot, p, cmin, cmax) + p.min_gain_to_split;
  const float mdl = p.min_data_in_leaf;
  const bool depth_ok = p.max_depth <= 0 || depth < (float)p.max_depth;
  const int key0 = f * (2 * BF);

  // masked grad, hess and count of the direction's scan
#pragma unroll
  for (int j = 0; j < LANE_BINS; ++j) {
    const int t = t0 + j;
    const bool in_range = t < BF && t < nb;
    const bool at_dflt = t == dflt;
    const bool on = reverse ? in_range && !(two_scan && zero_m && at_dflt) &&
                                  t <= bmax
                            : in_range && !(zero_m && at_dflt);
    sn[j] = on ? floorf(sh[j] * cnt_factor + 0.5f) : 0.0f;
    sg[j] = on ? sg[j] : 0.0f;
    sh[j] = on ? sh[j] : 0.0f;
  }
  row_scan(sg, lane);
  row_scan(sh, lane);
  row_scan(sn, lane);
  float tg = 0.0f, th = 0.0f, tn = 0.0f;
  if (reverse) {
    tg = row_at(sg, BF - 1);
    th = row_at(sh, BF - 1);
    tn = row_at(sn, BF - 1);
  }
  Cand best{-INFINITY, 0.0f, 0.0f, 0.0f, BIG_KEY};
#pragma unroll
  for (int j = 0; j < LANE_BINS; ++j) {
    const int t = t0 + j;
    if (t >= BF) continue;
    float lg, lh, lc, rg, rh, rc;
    bool allowed;
    int key;
    if (reverse) {
      rg = tg - sg[j];
      rh = (th - sh[j]) + K_EPS;
      rc = tn - sn[j];
      lg = sum_g - rg;
      lh = sum_h_tot - rh;
      lc = num_data - rc;
      allowed = t < nb && t <= bmax - 1 &&
                !(two_scan && zero_m && t == dflt - 1);
      key = key0 + BF - 1 - t;
    } else {
      lg = sg[j];
      lh = sh[j] + K_EPS;
      lc = sn[j];
      rg = sum_g - lg;
      rh = sum_h_tot - lh;
      rc = num_data - lc;
      allowed = two_scan && t < nb && t <= nb - 2 && !(zero_m && t == dflt);
      key = key0 + BF + t;
    }
    const float gain = pair_gain<MONO>(lg, lh, rg, rh, p, cmin, cmax, dir);
    const bool ok = lc >= mdl && rc >= mdl && lh >= p.min_sum_hessian &&
                    rh >= p.min_sum_hessian;
    const bool valid = allowed && ok && gain > mgs && fmask && depth_ok;
    const Cand c{valid ? gain : -INFINITY, lg, lh, lc, key};
    if (better(c, best)) best = c;
  }
  return warp_best(best);
}

// The exclusive f64 offsets of the 32 lanes' totals, in every lane
// (row_scan's shuffle scan).
__device__ __forceinline__ double lane_offset(double tot, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double u = __shfl_up_sync(FULL, tot, d);
    if (lane >= d) tot = tot + u;
  }
  double off = __shfl_up_sync(FULL, tot, 1);
  return lane == 0 ? 0.0 : off;
}

// scan_best at BF > 256 (the wide arm, uint16 data): a lane takes
// per = ceil(BF / 32) consecutive bins (ops/split.py prefix_sum's
// blocks, bins past BF zero) and walks them twice from the row in
// device memory: once for its f64 totals (and, in the lane holding bin
// BF - 1, the running sums there: the reverse scan's row totals), then,
// after the lane scan, for the running sums beside its offset and each
// bin's candidate.  Every sum is associated as in the 8-bin arm, so the
// two agree with prefix_sum bit for bit at their widths.
template <bool MONO>
__device__ __forceinline__ Cand scan_best_wide(
    const float* __restrict__ hg, const float* __restrict__ hh,
    const int* __restrict__ fmeta, const float* __restrict__ info, int r,
    int f, bool reverse, int BF, const Params& p, int lane) {
  const ScanRow m = scan_row<MONO>(fmeta, info, r, f, reverse, BF, p);
  const int per = (BF + 31) / 32;
  const int t0 = lane * per;
  const float* rg = hg + (long long)r * BF;
  const float* rh = hh + (long long)r * BF;
  double tg = 0.0, th = 0.0, tn = 0.0, eg = 0.0, eh = 0.0, en = 0.0;
  for (int j = 0; j < per; ++j) {
    const int t = t0 + j;
    float g = t < BF ? rg[t] : 0.0f, h = t < BF ? rh[t] : 0.0f, n;
    mask_bin(m, t, g, h, n);
    tg = j ? tg + (double)g : (double)g;
    th = j ? th + (double)h : (double)h;
    tn = j ? tn + (double)n : (double)n;
    if (t == BF - 1) {
      eg = tg;
      eh = th;
      en = tn;
    }
  }
  const double og = lane_offset(tg, lane), oh = lane_offset(th, lane),
               on = lane_offset(tn, lane);
  // the row's totals: the scanned sums at bin BF - 1
  const int last = (BF - 1) / per;
  float ag = 0.0f, ah = 0.0f, an = 0.0f;
  if (reverse) {
    ag = __shfl_sync(FULL, (float)(og + eg), last);
    ah = __shfl_sync(FULL, (float)(oh + eh), last);
    an = __shfl_sync(FULL, (float)(on + en), last);
  }
  Cand best{-INFINITY, 0.0f, 0.0f, 0.0f, BIG_KEY};
  double lg = 0.0, lh = 0.0, ln = 0.0;
  for (int j = 0; j < per; ++j) {
    const int t = t0 + j;
    float g = t < BF ? rg[t] : 0.0f, h = t < BF ? rh[t] : 0.0f, n;
    mask_bin(m, t, g, h, n);
    lg = j ? lg + (double)g : (double)g;
    lh = j ? lh + (double)h : (double)h;
    ln = j ? ln + (double)n : (double)n;
    if (t >= BF) continue;
    const Cand c = bin_cand<MONO>(m, p, t, (float)(og + lg), (float)(oh + lh),
                            (float)(on + ln), ag, ah, an);
    if (better(c, best)) best = c;
  }
  return warp_best(best);
}

// Write child c's 13 leafmat fields from its best candidate b (MONO: the
// shift at the clipped output, the outputs clipped).
template <bool MONO>
__device__ void write_best(const Cand& b, const int* __restrict__ fmeta,
                           const float* __restrict__ info, int c, int F,
                           int BF, const Params& p, float* __restrict__ o) {
  const int win = b.key;
  const bool has_win = win < BIG_KEY;
  const int wfeat = has_win ? win / (2 * BF) : 0;
  const int rr = win - wfeat * (2 * BF);
  const bool is_rev = rr < BF;
  const int thr = is_rev ? BF - 1 - rr : rr - BF;
  const int row = c * F + wfeat;
  const int nb = fmeta[row * 8 + FM_NUM_BIN];
  const int mtype = fmeta[row * 8 + FM_MISSING];
  const bool two_scan = (nb > 2) && (mtype != 0);
  const float snan = (!two_scan && mtype == 2) ? 1.0f : 0.0f;
  const float dl = (is_rev ? 1.0f : 0.0f) * (1.0f - snan);
  const float sg = info[(c * F) * 8 + IN_SUM_G];
  const float sh = info[(c * F) * 8 + IN_SUM_H] + 2e-15f;
  const float nd = info[(c * F) * 8 + IN_NUM_DATA];
  const float lg = b.lg, lh = b.lh, lc = b.lc;
  const float rg = sg - lg, rh = sh - lh, rc = nd - lc;
  const float cmin = MONO ? info[(c * F) * 8 + IN_CMIN] : 0.0f;
  const float cmax = MONO ? info[(c * F) * 8 + IN_CMAX] : 0.0f;
  const float shift =
      shift_gain<MONO>(sg, sh, p, cmin, cmax) + p.min_gain_to_split;
  float lout = leaf_out(lg, lh, p), rout = leaf_out(rg, rh, p);
  if (MONO) {
    lout = clip_out(lout, cmin, cmax);
    rout = clip_out(rout, cmin, cmax);
  }
  o[0] = has_win ? b.gain - shift : -INFINITY;
  o[1] = __int_as_float(wfeat);
  o[2] = __int_as_float(thr);
  o[3] = dl;
  o[4] = __int_as_float((int)lc);
  o[5] = __int_as_float((int)rc);
  o[6] = lg;
  o[7] = lh - K_EPS;
  o[8] = rg;
  o[9] = rh - K_EPS;
  o[10] = lout;
  o[11] = rout;
  o[12] = 0.0f;
}

// The monotone penalty of one feature's best gain (row r: its child's
// shift and depth, the feature's direction): relative to the shift,
// times the table's entry at the depth when the feature is monotone.
__device__ __forceinline__ float penalized(float gain,
                                           const int* __restrict__ fmeta,
                                           const float* __restrict__ info,
                                           int r, const Params& p,
                                           const float* __restrict__ pen,
                                           int pen_len) {
  if (!(gain > -INFINITY)) return -INFINITY;
  const float cmin = info[r * 8 + IN_CMIN], cmax = info[r * 8 + IN_CMAX];
  const float mgs =
      shift_gain<true>(info[r * 8 + IN_SUM_G], info[r * 8 + IN_SUM_H] + 2e-15f,
                       p, cmin, cmax) +
      p.min_gain_to_split;
  float rel = gain - mgs;
  if (fmeta[r * 8 + FM_MONO] != 0) {
    const int d = min(max((int)info[r * 8 + IN_DEPTH], 0), pen_len - 1);
    rel = rel * pen[d];
  }
  return mgs + rel;
}

template <bool WIDE, bool MONO>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    pair_search(const float* __restrict__ hg, const float* __restrict__ hh,
                const int* __restrict__ fmeta,
                const float* __restrict__ info, int F, int BF, Params p,
                const float* __restrict__ pen, int pen_len,
                float* __restrict__ out) {
  __shared__ Cand s_best[MAX_WARPS];
  __shared__ Cand s_block;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncl = (int)cluster.num_blocks();
  const int c = blockIdx.x / ncl;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const Cand none{-INFINITY, 0.0f, 0.0f, 0.0f, BIG_KEY};
  Cand best = none;
  // work items: (feature row, scan direction), 2F a child; MONO: a
  // feature row, both of its scans
  const int items = MONO ? F : 2 * F;
  for (int u = w * ncl + rank; u < items; u += nw * ncl) {
    const int f = MONO ? u : u >> 1;
    Cand rb;
    for (int k = 0; k < (MONO ? 2 : 1); ++k) {
      const bool rev = MONO ? k == 0 : (u & 1);
      const Cand sb =
          WIDE ? scan_best_wide<MONO>(hg, hh, fmeta, info, c * F + f, f, rev,
                                      BF, p, lane)
               : scan_best<MONO>(hg, hh, fmeta, info, c * F + f, f, rev, BF,
                                 p, lane);
      if (k == 0 || better(sb, rb)) rb = sb;
    }
    if (MONO && pen != nullptr)
      rb.gain = penalized(rb.gain, fmeta, info, c * F + f, p, pen, pen_len);
    if (better(rb, best)) best = rb;
  }
  if (lane == 0) s_best[w] = best;
  __syncthreads();
  if (w == 0) {
    const Cand b = warp_best(lane < nw ? s_best[lane] : none);
    if (lane == 0) s_block = b;
  }
  cluster.sync();
  if (rank == 0 && w == 0) {
    const Cand b = warp_best(
        lane < ncl ? *cluster.map_shared_rank(&s_block, lane) : none);
    if (lane == 0)
      write_best<MONO>(b, fmeta, info, c, F, BF, p, out + c * 13);
  }
  cluster.sync();   // the blocks' shared memory stays until it is read
}

// mono: the monotone arm (MONO); pen / pen_len: its penalty table by
// depth, or null.
extern "C" int split_pair_launch(const float* hg, const float* hh,
                                 const int* fmeta, const float* info,
                                 float* out, int F, int C, int BF, float l1,
                                 float l2, float max_delta_step,
                                 float min_gain_to_split,
                                 float min_data_in_leaf,
                                 float min_sum_hessian, int max_depth,
                                 int mono, const float* pen, int pen_len,
                                 void* stream) {
  if (BF < 1 || F < 1 || C < 1 || (pen != nullptr && (!mono || pen_len < 1)))
    return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, max_delta_step, min_gain_to_split, min_data_in_leaf,
                 min_sum_hessian, max_depth};
  const int items = mono ? F : 2 * F;
  const int ncl = items < MAX_CLUSTER ? items : MAX_CLUSTER;
  const int per = (items + ncl - 1) / ncl;
  const int nw = per < MAX_WARPS ? per : MAX_WARPS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ncl);
  cfg.blockDim = dim3(32 * nw);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ncl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const bool wide = BF > MAX_BF;
  if (mono)
    return (int)cudaLaunchKernelEx(
        &cfg, wide ? pair_search<true, true> : pair_search<false, true>, hg,
        hh, fmeta, info, F, BF, p, pen, pen_len, out);
  return (int)cudaLaunchKernelEx(
      &cfg, wide ? pair_search<true, false> : pair_search<false, false>, hg,
      hh, fmeta, info, F, BF, p, pen, pen_len, out);
}
