// Best numerical split for two sibling leaves, on Hopper.
//
// Replaces the TPU kernel best_split_pair_pallas
// (lightgbm_tpu/ops/split_pallas.py).  Its plain PyTorch version is
// split_pair_plain in lightgbm_tpu_torch/ops/split_pair.py; the two run
// the same f32 operations in the same order (this file is compiled with
// --fmad=false, and both prefix sums run an f64 sum over the bins from
// the left, rounded to f32 per bin), so they agree bit for bit with the
// plain version run on the CPU.
//
// What bounds it on this card: neither bytes nor operations.  The
// inputs are two (2F, BF) f32 histograms (57 KB at F=28, BF=256) and the
// work is a few thousand flops per row, so the kernel is launch- and
// latency-bound: two launches of a few microseconds each.  The design
// keeps it to two small launches and no host round-trip:
//   1. pair_rows: one block per (child, feature) row, one thread per
//      bin.  Six threads run the six sequential f64 prefix sums (masked
//      grad/hess/count for the forward and the reverse scan) out of
//      shared memory; every thread then scores its bin's forward and
//      reverse candidates and the block reduces to the row's maximum
//      gain and the minimum preference key among the candidates that
//      reach it.
//   2. pair_final: one thread per child walks the F rows in order
//      and takes the minimum key among the rows that reach the child's
//      maximum gain -- the reference's scan-order tie-break -- then
//      writes the 13 leafmat fields (int fields bitcast into f32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_BF 256
#define K_EPS 1e-15f
#define BIG_KEY (1 << 30)

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

// per-row winner: gain, key, left sums of the winning candidate
struct RowBest {
  float gain, lg, lh, lc;
  int key, is_rev;
};

__global__ void pair_rows(const float* __restrict__ hg,
                          const float* __restrict__ hh,
                          const int* __restrict__ fmeta,
                          const float* __restrict__ info, int F, int BF,
                          Params p, RowBest* __restrict__ rows) {
  __shared__ float vals[6][MAX_BF];
  __shared__ float red_g[MAX_BF];
  __shared__ int red_k[MAX_BF];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
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

  if (t < BF) {
    const bool in_range = t < nb;
    const float g = hg[r * BF + t];
    const float h = hh[r * BF + t];
    const float cnt = in_range ? floorf(h * cnt_factor + 0.5f) : 0.0f;
    const bool at_dflt = t == dflt;
    const bool mf = in_range && !(zero_m && at_dflt);
    const bool mr = in_range && !(two_scan && zero_m && at_dflt) && t <= bmax;
    vals[0][t] = mf ? g : 0.0f;
    vals[1][t] = mf ? h : 0.0f;
    vals[2][t] = mf ? cnt : 0.0f;
    vals[3][t] = mr ? g : 0.0f;
    vals[4][t] = mr ? h : 0.0f;
    vals[5][t] = mr ? cnt : 0.0f;
  }
  __syncthreads();
  if (t < 6) {  // inclusive prefix sum: f64 running sum, f32 per bin
    double acc = 0.0;
    for (int b = 0; b < BF; ++b) {
      acc = acc + (double)vals[t][b];
      vals[t][b] = (float)acc;
    }
  }
  __syncthreads();

  float gf = -INFINITY, gr = -INFINITY;
  float lg_f = 0.f, lh_f = 0.f, lc_f = 0.f, lg_r = 0.f, lh_r = 0.f,
        lc_r = 0.f;
  if (t < BF) {
    const bool in_range = t < nb;
    lg_f = vals[0][t];
    lh_f = vals[1][t] + K_EPS;
    lc_f = vals[2][t];
    const float rg_f = sum_g - lg_f;
    const float rh_f = sum_h_tot - lh_f;
    const float rc_f = num_data - lc_f;
    const float rg_r = vals[3][BF - 1] - vals[3][t];
    const float rh_r = (vals[4][BF - 1] - vals[4][t]) + K_EPS;
    const float rc_r = vals[5][BF - 1] - vals[5][t];
    lg_r = sum_g - rg_r;
    lh_r = sum_h_tot - rh_r;
    lc_r = num_data - rc_r;
    const float gain_f = leaf_gain(lg_f, lh_f, p) + leaf_gain(rg_f, rh_f, p);
    const float gain_r = leaf_gain(lg_r, lh_r, p) + leaf_gain(rg_r, rh_r, p);
    const float mgs = leaf_gain(sum_g, sum_h_tot, p) + p.min_gain_to_split;
    const float mdl = p.min_data_in_leaf;
    const bool depth_ok = p.max_depth <= 0 || depth < (float)p.max_depth;
    const bool ok_f = lc_f >= mdl && rc_f >= mdl &&
                      lh_f >= p.min_sum_hessian && rh_f >= p.min_sum_hessian;
    const bool ok_r = lc_r >= mdl && rc_r >= mdl &&
                      lh_r >= p.min_sum_hessian && rh_r >= p.min_sum_hessian;
    const bool valid_f = two_scan && in_range && t <= nb - 2 &&
                         !(zero_m && t == dflt) && ok_f && gain_f > mgs &&
                         fmask && depth_ok;
    const bool valid_r = in_range && t <= bmax - 1 &&
                         !(two_scan && zero_m && t == dflt - 1) && ok_r &&
                         gain_r > mgs && fmask && depth_ok;
    gf = valid_f ? gain_f : -INFINITY;
    gr = valid_r ? gain_r : -INFINITY;
  }
  // row maximum (exact in any order)
  red_g[t] = fmaxf(gf, gr);
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) red_g[t] = fmaxf(red_g[t], red_g[t + s]);
    __syncthreads();
  }
  const float rmax = red_g[0];
  // preference keys (feature-major; reverse thresholds descending, then
  // forward ascending): minimum among the candidates reaching rmax
  const int feat = r % F;
  int kr = BIG_KEY, kf = BIG_KEY;
  if (t < BF) {
    if (gr >= rmax) kr = feat * (2 * BF) + (BF - 1 - t);
    if (gf >= rmax) kf = feat * (2 * BF) + BF + t;
  }
  __syncthreads();
  red_k[t] = min(kr, kf);
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) red_k[t] = min(red_k[t], red_k[t + s]);
    __syncthreads();
  }
  const int win = red_k[0];
  if (t < BF && (kr == win || kf == win)) {
    RowBest b;
    b.gain = rmax;
    b.key = win;
    b.is_rev = kr == win;
    b.lg = b.is_rev ? lg_r : lg_f;
    b.lh = b.is_rev ? lh_r : lh_f;
    b.lc = b.is_rev ? lc_r : lc_f;
    rows[r] = b;
  }
}

__global__ void pair_final(const RowBest* __restrict__ rows,
                           const int* __restrict__ fmeta,
                           const float* __restrict__ info, int F, int BF,
                           Params p, float* __restrict__ out) {
  const int c = threadIdx.x;
  if (c >= 2) return;
  const RowBest* rb = rows + c * F;
  float gmax = -INFINITY;
  for (int f = 0; f < F; ++f) gmax = fmaxf(gmax, rb[f].gain);
  int win = BIG_KEY, wr = 0;
  for (int f = 0; f < F; ++f)
    if (rb[f].gain >= gmax && rb[f].key < win) {
      win = rb[f].key;
      wr = f;
    }
  const RowBest b = rb[wr];
  const int wfeat = win / (2 * BF);
  const int rr = win - wfeat * (2 * BF);
  const bool is_rev = rr < BF;
  const int thr = is_rev ? BF - 1 - rr : rr - BF;
  const int row = c * F + wr;
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
  const bool has_win = win < BIG_KEY;
  float* o = out + c * 13;
  o[0] = has_win ? gmax - shift : -INFINITY;
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

extern "C" int split_pair_launch(const float* hg, const float* hh,
                                 const int* fmeta, const float* info,
                                 void* rows_scratch, float* out, int F,
                                 int BF, float l1, float l2,
                                 float max_delta_step,
                                 float min_gain_to_split,
                                 float min_data_in_leaf,
                                 float min_sum_hessian, int max_depth,
                                 void* stream) {
  if (BF < 1 || BF > MAX_BF || F < 1) return (int)cudaErrorInvalidValue;
  Params p{l1, l2, max_delta_step, min_gain_to_split, min_data_in_leaf,
           min_sum_hessian, max_depth};
  cudaStream_t s = (cudaStream_t)stream;
  RowBest* rows = (RowBest*)rows_scratch;
  pair_rows<<<2 * F, MAX_BF, 0, s>>>(hg, hh, fmeta, info, F, BF, p, rows);
  pair_final<<<1, 32, 0, s>>>(rows, fmeta, info, F, BF, p, out);
  return (int)cudaGetLastError();
}

extern "C" int split_pair_row_bytes() { return (int)sizeof(RowBest); }
