// Best numerical split for two sibling leaves, on Hopper.
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
//   one thread-block cluster per child, of up to 8 blocks on 8 SMs; one
//   warp per work item, a (feature row, scan direction) pair -- the
//   forward and the reverse scan share no data, so two warps take a row
//   and each runs half the chain -- the warps striding over items when
//   2F exceeds 64.  A lane holds 8 consecutive bins (BF <= 256, bins
//   past BF zero).  Each masked prefix sum (grad, hess and count of the
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_BF 256
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
#define IN_SUM_G 0
#define IN_SUM_H 1
#define IN_NUM_DATA 2
#define IN_DEPTH 3
#define IN_MASK 4

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

// The best candidate of one scan direction of row r (child c, feature
// f), in every lane: the forward scan (missing values go right; left
// sums are the prefix sums; keys ascend with the threshold after the
// reverse scan's) or the reverse scan (missing values go left; right
// sums are the row's total minus the prefix sums; keys descend with the
// threshold).  The two need no data of each other, so two warps take
// them.
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
  const bool fmask = info[r * 8 + IN_MASK] > 0.0f;
  const float cnt_factor = num_data / sum_h_tot;
  const bool zero_m = mtype == 1, nan_m = mtype == 2;
  const bool two_scan = (nb > 2) && (mtype != 0);
  const int bmax = nb - 1 - ((nan_m && two_scan) ? 1 : 0);
  const float mgs = leaf_gain(sum_g, sum_h_tot, p) + p.min_gain_to_split;
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
    const float gain = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p);
    const bool ok = lc >= mdl && rc >= mdl && lh >= p.min_sum_hessian &&
                    rh >= p.min_sum_hessian;
    const bool valid = allowed && ok && gain > mgs && fmask && depth_ok;
    const Cand c{valid ? gain : -INFINITY, lg, lh, lc, key};
    if (better(c, best)) best = c;
  }
  return warp_best(best);
}

// Write child c's 13 leafmat fields from its best candidate b.
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
  const float shift = leaf_gain(sg, sh, p) + p.min_gain_to_split;
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
  o[10] = leaf_out(lg, lh, p);
  o[11] = leaf_out(rg, rh, p);
  o[12] = 0.0f;
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
    pair_search(const float* __restrict__ hg, const float* __restrict__ hh,
                const int* __restrict__ fmeta,
                const float* __restrict__ info, int F, int BF, Params p,
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
  // work items: (feature row, scan direction), 2F a child
  for (int u = w * ncl + rank; u < 2 * F; u += nw * ncl) {
    const int f = u >> 1;
    const Cand rb = scan_best(hg, hh, fmeta, info, c * F + f, f, u & 1, BF,
                              p, lane);
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
    if (lane == 0) write_best(b, fmeta, info, c, F, BF, p, out + c * 13);
  }
  cluster.sync();   // the blocks' shared memory stays until it is read
}

extern "C" int split_pair_launch(const float* hg, const float* hh,
                                 const int* fmeta, const float* info,
                                 float* out, int F, int BF, float l1,
                                 float l2, float max_delta_step,
                                 float min_gain_to_split,
                                 float min_data_in_leaf,
                                 float min_sum_hessian, int max_depth,
                                 void* stream) {
  if (BF < 1 || BF > MAX_BF || F < 1) return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, max_delta_step, min_gain_to_split, min_data_in_leaf,
                 min_sum_hessian, max_depth};
  const int ncl = 2 * F < MAX_CLUSTER ? 2 * F : MAX_CLUSTER;
  const int per = (2 * F + ncl - 1) / ncl;
  const int nw = per < MAX_WARPS ? per : MAX_WARPS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * ncl);
  cfg.blockDim = dim3(32 * nw);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ncl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, pair_search, hg, hh, fmeta, info, F,
                                 BF, p, out);
}
