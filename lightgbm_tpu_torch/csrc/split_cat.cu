// The categorical split search of the children of a split on Hopper,
// merged into the numerical pair search's rows.
//
// No TPU kernel corresponds to it: the JAX package computes
// find_best_split_categorical (lightgbm_tpu/ops/split.py) in XLA inside
// its general search.  Its plain PyTorch version is split_cat_plain in
// lightgbm_tpu_torch/ops/split_cat.py; the two run the same f32
// operations in the same order (this file is compiled with --fmad=false)
// and the same blocked f64 prefix sums (ops/split.py prefix_sum), so they
// agree bit for bit, on the CPU and on the card.
//
// What bounds it on this card: latency.  The inputs are a few KB (a
// child's categorical rows of 256 bins) and the work a few thousand
// flops a bin; the longest chain is the exact rank count (256 shared
// reads a thread) and the sequential min_data_per_group gate.  The
// design, one launch a split:
//   one block of 256 threads per (categorical feature, child), a thread
//   per bin.  A thread scores its bin's one-vs-rest candidate and forms
//   its sort key G / (H + cat_smooth) (+inf for a bin below cat_smooth
//   or a NaN key); its rank is the number of bins of a smaller key, or
//   of an equal key and a smaller index -- exact, stable and free of
//   any order of work.  The sorted grad, hess and count rows are scanned
//   by three warps at once (a lane holds 8 positions: a local f64 scan,
//   a shuffle scan of the lane totals, rounded to f32 per position).
//   Every thread then scores both ends' candidates at its position;
//   one thread per direction runs the gate and break conditions over at
//   most max_cat_threshold positions.  The set is a ballot a warp.  Each
//   block writes a record to the scratch `work` and takes a ticket; the
//   last block merges, per child, the categorical features' best
//   (largest gain, smaller feature on ties) into the pair search's row
//   when it wins by the JAX argmax rule, writes the set, and resets the
//   ticket for the next launch (and the next replay of a graph).
// Wider rows (BF > 256, uint16 data: a categorical of more than 256
// bins) take cat_search_wide: the same steps with each thread striding
// over the bins and the per-bin rows in device scratch (`work`, after
// the records) instead of shared memory, so any width fits; the warp
// scans take ceil(BF / 32) positions a lane, the prefix_sum blocks of
// that width.  A set is W = max(8, ceil(BF / 32)) words.
//
// The monotone arm (the template's MONO, a launch argument): the
// children's outputs are clipped to the child's bounds (info columns
// IN_CMIN, IN_CMAX), every gain -- the leaf's shift, one-vs-rest, both
// ends' -- is taken at the clipped outputs (JAX
// find_best_split_categorical with cmin / cmax), and the merged winner's
// outputs are clipped.  Without it the arm is not in the launched kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_BF 256        // the shared-memory arm; wider: cat_search_wide
#define NT 256
#define LANE_BINS 8
#define CAT_WORDS 8       // a set's words at BF <= 256
#define REC 16            // a record at BF <= 256: 8 fields, the set
#define REC_FIELDS 8      // a record's words before its set
#define WIDE_ROWS 11      // the wide arm's per-bin scratch rows
#define OUT_FIELDS 13
#define K_EPS 1e-15f
#define FULL 0xffffffffu

// fmeta / info columns (ops/split_pair.py FM_*, IN_*)
#define FM_NUM_BIN 0
#define IN_SUM_G 0
#define IN_SUM_H 1
#define IN_NUM_DATA 2
#define IN_DEPTH 3
#define IN_MASK 4
#define IN_CMIN 5         // the child's output bounds (monotone)
#define IN_CMAX 6

struct Params {
  float l1, l2, max_delta_step, min_gain_to_split, min_data_in_leaf,
      min_sum_hessian;
  int max_depth;
};

struct CatParams {
  int max_cat_threshold;
  float l2c, cat_smooth;
  int max_cat_to_onehot;
  float min_data_per_group;
};

__device__ __forceinline__ float thr_l1(float g, float l1) {
  float mag = fmaxf(0.0f, fabsf(g) - l1);
  return g < 0.0f ? -mag : mag;
}

__device__ __forceinline__ float leaf_out(float g, float h, float l1,
                                          float l2, float mds) {
  float ret = (-thr_l1(g, l1)) / (h + l2);
  if (mds > 0.0f) ret = fminf(fmaxf(ret, -mds), mds);
  return ret;
}

__device__ __forceinline__ float leaf_gain(float g, float h, float l1,
                                           float l2, float mds) {
  float s = thr_l1(g, l1);
  if (mds > 0.0f) {
    float out = leaf_out(g, h, l1, l2, mds);
    return -((2.0f * s) * out + ((h + l2) * out) * out);
  }
  return (s * s) / (h + l2);
}

__device__ __forceinline__ float clip_out(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The gain at a given output (GetLeafGainGivenOutput).
__device__ __forceinline__ float gain_given(float g, float h, float l1,
                                           float l2, float out) {
  const float s = thr_l1(g, l1);
  return -((2.0f * s) * out + ((h + l2) * out) * out);
}

// The two children's gain at l2: the sum of their leaf gains, or (MONO)
// the gains at their outputs clipped to [cmin, cmax].
template <bool MONO>
__device__ __forceinline__ float pair_gain(float lg, float lh, float rg,
                                           float rh, float l1, float l2,
                                           float mds, float cmin,
                                           float cmax) {
  if (!MONO) return leaf_gain(lg, lh, l1, l2, mds) + leaf_gain(rg, rh, l1, l2, mds);
  const float lo = clip_out(leaf_out(lg, lh, l1, l2, mds), cmin, cmax);
  const float ro = clip_out(leaf_out(rg, rh, l1, l2, mds), cmin, cmax);
  return gain_given(lg, lh, l1, l2, lo) + gain_given(rg, rh, l1, l2, ro);
}

// The leaf's own gain, the shift its candidates must beat (MONO: at its
// clipped output).
template <bool MONO>
__device__ __forceinline__ float shift_gain(float sg, float sh, float l1,
                                            float l2, float mds, float cmin,
                                            float cmax) {
  if (!MONO) return leaf_gain(sg, sh, l1, l2, mds);
  return gain_given(sg, sh, l1, l2,
                    clip_out(leaf_out(sg, sh, l1, l2, mds), cmin, cmax));
}

// Inclusive prefix sums of 256 positions of a shared row, by one warp,
// into dst (ops/split.py prefix_sum: a local f64 scan of the lane's 8
// positions, a shuffle scan of the lane totals, the lane's exclusive
// offset added per position, rounded to f32).
__device__ __forceinline__ void warp_scan(const float* src, float* dst,
                                          int lane) {
  const int t0 = lane * LANE_BINS;
  double tot = (double)src[t0];
#pragma unroll
  for (int j = 1; j < LANE_BINS; ++j) tot = tot + (double)src[t0 + j];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double u = __shfl_up_sync(FULL, tot, d);
    if (lane >= d) tot = tot + u;
  }
  double off = __shfl_up_sync(FULL, tot, 1);
  if (lane == 0) off = 0.0;
  double loc = (double)src[t0];
  dst[t0] = (float)(off + loc);
#pragma unroll
  for (int j = 1; j < LANE_BINS; ++j) {
    loc = loc + (double)src[t0 + j];
    dst[t0 + j] = (float)(off + loc);
  }
}

// a before b: the larger value, the smaller index on a tie
__device__ __forceinline__ bool first_max(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// The last block: per child, the categorical features' best record
// (largest gain, smaller feature on ties) merged into the pair search's
// row when it wins by the JAX argmax rule, and its W-word set written
// (zeros where the numerical split stays).  Records are rec words apart.
// MONO: the outputs clipped to the child's bounds.
template <bool MONO>
__device__ __forceinline__ void merge_best(
    float* __restrict__ pair, int* __restrict__ cat_out, const int* work,
    const float* __restrict__ info, const int* __restrict__ cat_feats, int F,
    int C, int NC, int rec, int W, float l1, float mds) {
  for (int cc = threadIdx.x; cc < C; cc += NT) {
    const volatile int* rv = work + cc * NC * rec;
    int kb = 0;
    float g = __int_as_float(rv[0]);
    for (int j = 1; j < NC; ++j) {
      const float gj = __int_as_float(rv[j * rec]);
      if (gj > g) {
        g = gj;
        kb = j;
      }
    }
    const volatile int* rb = rv + kb * rec;
    const float rel = g > -INFINITY ? g - __int_as_float(rb[5]) : -INFINITY;
    float* o = pair + cc * OUT_FIELDS;
    const float num_rel = o[0];
    const int num_feat = __float_as_int(o[1]);
    const int feat = cat_feats[kb];
    const bool wins = rel > num_rel || (rel == num_rel && rel > -INFINITY &&
                                        feat < num_feat);
    int* co = cat_out + cc * W;
    if (wins) {
      const float sg = info[(cc * F) * 8 + IN_SUM_G];
      const float sh = info[(cc * F) * 8 + IN_SUM_H] + 2e-15f;
      const float nd = info[(cc * F) * 8 + IN_NUM_DATA];
      const float lg = __int_as_float(rb[1]), lh = __int_as_float(rb[2]);
      const float lc = __int_as_float(rb[3]), l2e = __int_as_float(rb[4]);
      const float rg = sg - lg, rh = sh - lh, rc = nd - lc;
      float lout = leaf_out(lg, lh, l1, l2e, mds);
      float rout = leaf_out(rg, rh, l1, l2e, mds);
      if (MONO) {
        const float cmin = info[(cc * F) * 8 + IN_CMIN];
        const float cmax = info[(cc * F) * 8 + IN_CMAX];
        lout = clip_out(lout, cmin, cmax);
        rout = clip_out(rout, cmin, cmax);
      }
      o[0] = rel;
      o[1] = __int_as_float(feat);
      o[2] = __int_as_float(0);
      o[3] = 0.0f;
      o[4] = __int_as_float((int)lc);
      o[5] = __int_as_float((int)rc);
      o[6] = lg;
      o[7] = lh - K_EPS;
      o[8] = rg;
      o[9] = rh - K_EPS;
      o[10] = lout;
      o[11] = rout;
      o[12] = 1.0f;
      for (int j = 0; j < W; ++j) co[j] = rb[REC_FIELDS + j];
    } else {
      for (int j = 0; j < W; ++j) co[j] = 0;
    }
  }
}

template <bool MONO>
__global__ void __launch_bounds__(NT)
    cat_search(const float* __restrict__ hg, const float* __restrict__ hh,
               const int* __restrict__ fmeta, const float* __restrict__ info,
               const int* __restrict__ cat_feats, float* __restrict__ pair,
               int* __restrict__ cat_out, int* work, int F, int C, int BF,
               int NC, Params p, CatParams q) {
  __shared__ float s_key[MAX_BF];
  __shared__ float s_sg[MAX_BF], s_sh[MAX_BF], s_sc[MAX_BF];
  __shared__ float s_pg[MAX_BF], s_ph[MAX_BF], s_pc[MAX_BF];
  __shared__ float s_gf[MAX_BF], s_gr[MAX_BF];
  __shared__ unsigned char s_okf[MAX_BF], s_okr[MAX_BF];
  __shared__ unsigned char s_brf[MAX_BF], s_brr[MAX_BF];
  __shared__ float s_rv[NT / 32];
  __shared__ int s_ri[NT / 32];
  __shared__ float s_bg[2];
  __shared__ int s_bi[2];
  __shared__ int s_oh, s_last;
  __shared__ unsigned s_words[CAT_WORDS];

  const int k = blockIdx.x, c = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int f = cat_feats[k];
  const int r = c * F + f;
  const float G = t < BF ? hg[r * BF + t] : 0.0f;
  const float H = t < BF ? hh[r * BF + t] : 0.0f;
  const int nb = fmeta[r * 8 + FM_NUM_BIN];
  const float sum_g = info[r * 8 + IN_SUM_G];
  const float sum_h_tot = info[r * 8 + IN_SUM_H] + 2e-15f;
  const float num_data = info[r * 8 + IN_NUM_DATA];
  const float depth = info[r * 8 + IN_DEPTH];
  const bool fmask = info[r * 8 + IN_MASK] > 0.0f;
  const float cnt_factor = num_data / sum_h_tot;
  const float l1 = p.l1, mds = p.max_delta_step;
  const float cmin = MONO ? info[r * 8 + IN_CMIN] : 0.0f;
  const float cmax = MONO ? info[r * 8 + IN_CMAX] : 0.0f;
  const float mgs =
      shift_gain<MONO>(sum_g, sum_h_tot, l1, p.l2, mds, cmin, cmax) +
      p.min_gain_to_split;
  const float mdl = p.min_data_in_leaf, msh = p.min_sum_hessian;
  const float mdpg = q.min_data_per_group;

  const bool in_range = t >= 1 && t < nb && t < BF;
  const float cnt = in_range ? floorf(H * cnt_factor + 0.5f) : 0.0f;

  // ---- one-vs-rest: the first bin of the largest valid gain --------
  {
    const float hess_t = H + K_EPS;
    const float other_g = sum_g - G;
    const float other_h = (sum_h_tot - H) - K_EPS;
    const float other_cnt = num_data - cnt;
    const float gain = pair_gain<MONO>(G, hess_t, other_g, other_h, l1, p.l2,
                                       mds, cmin, cmax);
    const bool valid = in_range && cnt >= mdl && H >= msh &&
                       other_cnt >= mdl && other_h >= msh && gain > mgs;
    float v = valid ? gain : -INFINITY;
    int i = t;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, m);
      const int oi = __shfl_xor_sync(FULL, i, m);
      if (first_max(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      s_rv[w] = v;
      s_ri[w] = i;
    }
  }

  // ---- the sort: keys and exact ranks ------------------------------
  const bool valid_s = in_range && cnt >= q.cat_smooth;
  float key = valid_s ? G / (H + q.cat_smooth) : INFINITY;
  if (isnan(key)) key = INFINITY;
  if (t < BF) s_key[t] = key;
  s_sg[t] = 0.0f;
  s_sh[t] = 0.0f;
  s_sc[t] = 0.0f;
  const int used = __syncthreads_count(valid_s);
  if (t == 0) {
    float v = s_rv[0];
    int i = s_ri[0];
    for (int j = 1; j < NT / 32; ++j)
      if (first_max(s_rv[j], s_ri[j], v, i)) {
        v = s_rv[j];
        i = s_ri[j];
      }
    s_oh = i;
    s_bg[0] = v;      // the one-vs-rest gain, read below
  }
  int rank = 0;
  if (t < BF) {
    for (int j = 0; j < BF; ++j) {
      const float kj = s_key[j];
      rank += (kj < key) || (kj == key && j < t);
    }
    s_sg[rank] = valid_s ? G : 0.0f;
    s_sh[rank] = valid_s ? H : 0.0f;
    s_sc[rank] = valid_s ? cnt : 0.0f;
  }
  __syncthreads();
  const float oh_gain = s_bg[0];
  const int oh_bin = s_oh;
  if (w == 0) warp_scan(s_sg, s_pg, lane);
  if (w == 1) warp_scan(s_sh, s_ph, lane);
  if (w == 2) warp_scan(s_sc, s_pc, lane);
  __syncthreads();

  // ---- both ends' candidates at position t -------------------------
  const int max_num_cat = min(q.max_cat_threshold, (used + 1) / 2);
  const int lim = min(used, max_num_cat);
  const float tvg = s_pg[BF - 1], tvh = s_ph[BF - 1], tvc = s_pc[BF - 1];
  if (t < BF) {
    const bool in_loop = t < used && t < max_num_cat;
    for (int dir = 0; dir < 2; ++dir) {
      float lg, lh, lc;
      if (dir == 0) {
        lg = s_pg[t];
        lh = s_ph[t] + K_EPS;
        lc = s_pc[t];
      } else {
        const int idx = used - 2 - t;
        lg = tvg - (idx >= 0 ? s_pg[idx] : 0.0f);
        lh = (tvh - (idx >= 0 ? s_ph[idx] : 0.0f)) + K_EPS;
        lc = tvc - (idx >= 0 ? s_pc[idx] : 0.0f);
      }
      const float rg = sum_g - lg, rh = sum_h_tot - lh, rc = num_data - lc;
      const bool left_ok = lc >= mdl && lh >= msh;
      const bool broken = rc < mdl || rc < mdpg || rh < msh;
      const float gain =
          pair_gain<MONO>(lg, lh, rg, rh, l1, q.l2c, mds, cmin, cmax);
      (dir ? s_gr : s_gf)[t] = gain;
      (dir ? s_okr : s_okf)[t] = left_ok && in_loop;
      (dir ? s_brr : s_brf)[t] = broken;
    }
  }
  __syncthreads();

  // ---- the gate, one thread a direction ----------------------------
  if (lane == 0 && w < 2) {
    const bool rev = w == 1;
    const float* gn = rev ? s_gr : s_gf;
    const unsigned char* ok = rev ? s_okr : s_okf;
    const unsigned char* br = rev ? s_brr : s_brf;
    float acc = 0.0f, best = -INFINITY;
    int bi = 0;
    for (int i = 0; i < lim; ++i) {
      if (br[i]) break;
      acc = acc + (rev ? s_sc[used - 1 - i] : s_sc[i]);
      if (ok[i] && acc >= mdpg) {
        acc = 0.0f;
        if (gn[i] > mgs && gn[i] > best) {
          best = gn[i];
          bi = i;
        }
      }
    }
    s_bg[w] = best;
    s_bi[w] = bi;
  }
  __syncthreads();

  const bool use_rev = s_bg[1] > s_bg[0];
  const int bi = use_rev ? s_bi[1] : s_bi[0];
  const int kk = bi + 1;
  const bool onehot = nb <= q.max_cat_to_onehot;
  const bool member =
      t < BF && (onehot ? t == oh_bin
                        : ((use_rev ? (rank >= used - kk && rank < used)
                                    : rank < kk) &&
                           valid_s));
  const unsigned bal = __ballot_sync(FULL, member);
  if (lane == 0) s_words[w] = bal;
  __syncthreads();

  int* rec = work + (c * NC + k) * REC;
  if (t == 0) {
    float gain = onehot ? oh_gain : (use_rev ? s_bg[1] : s_bg[0]);
    if (!fmask) gain = -INFINITY;
    if (p.max_depth > 0 && !(depth < (float)p.max_depth)) gain = -INFINITY;
    float lg, lh, lc;
    if (onehot) {
      lg = hg[r * BF + oh_bin];
      lh = hh[r * BF + oh_bin] + K_EPS;
      lc = 0.0f;
      if (oh_bin >= 1 && oh_bin < nb)
        lc = floorf(hh[r * BF + oh_bin] * cnt_factor + 0.5f);
    } else if (use_rev) {
      const int idx = used - 2 - bi;
      lg = tvg - (idx >= 0 ? s_pg[idx] : 0.0f);
      lh = (tvh - (idx >= 0 ? s_ph[idx] : 0.0f)) + K_EPS;
      lc = tvc - (idx >= 0 ? s_pc[idx] : 0.0f);
    } else {
      lg = s_pg[bi];
      lh = s_ph[bi] + K_EPS;
      lc = s_pc[bi];
    }
    rec[0] = __float_as_int(gain);
    rec[1] = __float_as_int(lg);
    rec[2] = __float_as_int(lh);
    rec[3] = __float_as_int(lc);
    rec[4] = __float_as_int(onehot ? p.l2 : q.l2c);
    rec[5] = __float_as_int(mgs);
    for (int j = 0; j < CAT_WORDS; ++j) rec[8 + j] = (int)s_words[j];
    __threadfence();
    s_last = atomicAdd(work + C * NC * REC, 1) == C * NC - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // ---- the last block: merge each child's best into its row --------
  merge_best<MONO>(pair, cat_out, work, info, cat_feats, F, C, NC, REC,
                   CAT_WORDS, l1, mds);
  if (t == 0) work[C * NC * REC] = 0;
}

// warp_scan over n > 256 positions of a row in device scratch: a lane
// takes per = ceil(n / 32) consecutive positions (prefix_sum's blocks;
// positions past n read as 0 and are not written).
__device__ __forceinline__ void warp_scan_wide(const float* src, float* dst,
                                               int n, int lane) {
  const int per = (n + 31) / 32;
  const int t0 = lane * per;
  double tot = 0.0;
  for (int j = 0; j < per; ++j) {
    const double v = t0 + j < n ? (double)src[t0 + j] : 0.0;
    tot = j ? tot + v : v;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double u = __shfl_up_sync(FULL, tot, d);
    if (lane >= d) tot = tot + u;
  }
  double off = __shfl_up_sync(FULL, tot, 1);
  if (lane == 0) off = 0.0;
  double loc = 0.0;
  for (int j = 0; j < per && t0 + j < n; ++j) {
    loc = j ? loc + (double)src[t0 + j] : (double)src[t0 + j];
    dst[t0 + j] = (float)(off + loc);
  }
}

// The search of one (categorical feature, child) at BF > 256: a thread
// takes the bins t, t + NT, ...; the per-bin rows live in this block's
// WIDE_ROWS x BF words of device scratch `rows` (key, the sorted grad,
// hess and count, their prefix sums, the two ends' gains, the rank, the
// flags), which the block's barriers make visible to all its threads.
// Every value is the 256-bin kernel's arithmetic on the same operands,
// so the two agree with split_cat_plain at their widths.
template <bool MONO>
__global__ void __launch_bounds__(NT)
    cat_search_wide(const float* __restrict__ hg,
                    const float* __restrict__ hh,
                    const int* __restrict__ fmeta,
                    const float* __restrict__ info,
                    const int* __restrict__ cat_feats,
                    float* __restrict__ pair, int* __restrict__ cat_out,
                    int* work, int F, int C, int BF, int NC, int W, Params p,
                    CatParams q) {
  __shared__ float s_rv[NT / 32];
  __shared__ int s_ri[NT / 32];
  __shared__ float s_bg[2];
  __shared__ int s_bi[2];
  __shared__ int s_oh, s_last, s_used;

  const int k = blockIdx.x, c = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int rec_words = REC_FIELDS + W;
  float* rows = (float*)(work + C * NC * rec_words + 1) +
                (long long)(c * NC + k) * WIDE_ROWS * BF;
  float* x_key = rows;
  float* x_sg = rows + BF;
  float* x_sh = rows + 2 * BF;
  float* x_sc = rows + 3 * BF;
  float* x_pg = rows + 4 * BF;
  float* x_ph = rows + 5 * BF;
  float* x_pc = rows + 6 * BF;
  float* x_gf = rows + 7 * BF;
  float* x_gr = rows + 8 * BF;
  int* x_rank = (int*)(rows + 9 * BF);
  int* x_flag = (int*)(rows + 10 * BF);   // okf 1, okr 2, brf 4, brr 8

  const int f = cat_feats[k];
  const int r = c * F + f;
  const float* hgr = hg + (long long)r * BF;
  const float* hhr = hh + (long long)r * BF;
  const int nb = fmeta[r * 8 + FM_NUM_BIN];
  const float sum_g = info[r * 8 + IN_SUM_G];
  const float sum_h_tot = info[r * 8 + IN_SUM_H] + 2e-15f;
  const float num_data = info[r * 8 + IN_NUM_DATA];
  const float depth = info[r * 8 + IN_DEPTH];
  const bool fmask = info[r * 8 + IN_MASK] > 0.0f;
  const float cnt_factor = num_data / sum_h_tot;
  const float l1 = p.l1, mds = p.max_delta_step;
  const float cmin = MONO ? info[r * 8 + IN_CMIN] : 0.0f;
  const float cmax = MONO ? info[r * 8 + IN_CMAX] : 0.0f;
  const float mgs =
      shift_gain<MONO>(sum_g, sum_h_tot, l1, p.l2, mds, cmin, cmax) +
      p.min_gain_to_split;
  const float mdl = p.min_data_in_leaf, msh = p.min_sum_hessian;
  const float mdpg = q.min_data_per_group;
  if (t == 0) s_used = 0;
  __syncthreads();

  // ---- one-vs-rest and the sort keys, a thread's bins in turn -------
  float v = -INFINITY;
  int vi = t;
  int nvalid = 0;
  for (int b = t; b < BF; b += NT) {
    const float G = hgr[b], H = hhr[b];
    const bool in_range = b >= 1 && b < nb;
    const float cnt = in_range ? floorf(H * cnt_factor + 0.5f) : 0.0f;
    const float hess_t = H + K_EPS;
    const float other_g = sum_g - G;
    const float other_h = (sum_h_tot - H) - K_EPS;
    const float other_cnt = num_data - cnt;
    const float gain = pair_gain<MONO>(G, hess_t, other_g, other_h, l1, p.l2,
                                       mds, cmin, cmax);
    const bool valid = in_range && cnt >= mdl && H >= msh &&
                       other_cnt >= mdl && other_h >= msh && gain > mgs;
    const float gv = valid ? gain : -INFINITY;
    if (first_max(gv, b, v, vi)) {
      v = gv;
      vi = b;
    }
    const bool valid_s = in_range && cnt >= q.cat_smooth;
    float key = valid_s ? G / (H + q.cat_smooth) : INFINITY;
    if (isnan(key)) key = INFINITY;
    x_key[b] = key;
    nvalid += valid_s;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, m);
    const int oi = __shfl_xor_sync(FULL, vi, m);
    if (first_max(ov, oi, v, vi)) {
      v = ov;
      vi = oi;
    }
  }
  if (lane == 0) {
    s_rv[w] = v;
    s_ri[w] = vi;
  }
  if (nvalid) atomicAdd(&s_used, nvalid);
  __syncthreads();
  const int used = s_used;
  if (t == 0) {
    float bv = s_rv[0];
    int bi = s_ri[0];
    for (int j = 1; j < NT / 32; ++j)
      if (first_max(s_rv[j], s_ri[j], bv, bi)) {
        bv = s_rv[j];
        bi = s_ri[j];
      }
    s_oh = bi;
    s_bg[0] = bv;
  }

  // ---- exact ranks; the sorted rows --------------------------------
  for (int b = t; b < BF; b += NT) {
    const float key = x_key[b];
    int rank = 0;
    for (int j = 0; j < BF; ++j) {
      const float kj = x_key[j];
      rank += (kj < key) || (kj == key && j < b);
    }
    const float G = hgr[b], H = hhr[b];
    const bool in_range = b >= 1 && b < nb;
    const float cnt = in_range ? floorf(H * cnt_factor + 0.5f) : 0.0f;
    const bool valid_s = in_range && cnt >= q.cat_smooth;
    x_rank[b] = rank;
    x_sg[rank] = valid_s ? G : 0.0f;
    x_sh[rank] = valid_s ? H : 0.0f;
    x_sc[rank] = valid_s ? cnt : 0.0f;
  }
  __syncthreads();
  const float oh_gain = s_bg[0];
  const int oh_bin = s_oh;
  if (w == 0) warp_scan_wide(x_sg, x_pg, BF, lane);
  if (w == 1) warp_scan_wide(x_sh, x_ph, BF, lane);
  if (w == 2) warp_scan_wide(x_sc, x_pc, BF, lane);
  __syncthreads();

  // ---- both ends' candidates at each position ----------------------
  const int max_num_cat = min(q.max_cat_threshold, (used + 1) / 2);
  const int lim = min(used, max_num_cat);
  const float tvg = x_pg[BF - 1], tvh = x_ph[BF - 1], tvc = x_pc[BF - 1];
  for (int b = t; b < BF; b += NT) {
    const bool in_loop = b < used && b < max_num_cat;
    int flag = 0;
    for (int dir = 0; dir < 2; ++dir) {
      float lg, lh, lc;
      if (dir == 0) {
        lg = x_pg[b];
        lh = x_ph[b] + K_EPS;
        lc = x_pc[b];
      } else {
        const int idx = used - 2 - b;
        lg = tvg - (idx >= 0 ? x_pg[idx] : 0.0f);
        lh = (tvh - (idx >= 0 ? x_ph[idx] : 0.0f)) + K_EPS;
        lc = tvc - (idx >= 0 ? x_pc[idx] : 0.0f);
      }
      const float rg = sum_g - lg, rh = sum_h_tot - lh, rc = num_data - lc;
      const bool left_ok = lc >= mdl && lh >= msh;
      const bool broken = rc < mdl || rc < mdpg || rh < msh;
      const float gain =
          pair_gain<MONO>(lg, lh, rg, rh, l1, q.l2c, mds, cmin, cmax);
      (dir ? x_gr : x_gf)[b] = gain;
      flag |= ((left_ok && in_loop) ? 1 : 0) << dir;
      flag |= (broken ? 4 : 0) << dir;
    }
    x_flag[b] = flag;
  }
  __syncthreads();

  // ---- the gate, one thread a direction ----------------------------
  if (lane == 0 && w < 2) {
    const bool rev = w == 1;
    const float* gn = rev ? x_gr : x_gf;
    float acc = 0.0f, best = -INFINITY;
    int bi = 0;
    for (int i = 0; i < lim; ++i) {
      const int fl = x_flag[i] >> (rev ? 1 : 0);
      if (fl & 4) break;
      acc = acc + (rev ? x_sc[used - 1 - i] : x_sc[i]);
      if ((fl & 1) && acc >= mdpg) {
        acc = 0.0f;
        if (gn[i] > mgs && gn[i] > best) {
          best = gn[i];
          bi = i;
        }
      }
    }
    s_bg[w] = best;
    s_bi[w] = bi;
  }
  __syncthreads();

  const bool use_rev = s_bg[1] > s_bg[0];
  const int bi = use_rev ? s_bi[1] : s_bi[0];
  const int kk = bi + 1;
  const bool onehot = nb <= q.max_cat_to_onehot;
  int* rec = work + (c * NC + k) * rec_words;
  // the set: 32 consecutive bins a warp's ballot, one word
  for (int b0 = 0; b0 < BF; b0 += NT) {
    const int b = b0 + t;
    bool member = false;
    if (b < BF) {
      const bool in_range = b >= 1 && b < nb;
      const float cnt =
          in_range ? floorf(hhr[b] * cnt_factor + 0.5f) : 0.0f;
      const bool valid_s = in_range && cnt >= q.cat_smooth;
      const int rank = x_rank[b];
      member = onehot ? b == oh_bin
                      : ((use_rev ? (rank >= used - kk && rank < used)
                                  : rank < kk) &&
                         valid_s);
    }
    const unsigned bal = __ballot_sync(FULL, member);
    const int word = (b0 >> 5) + w;
    if (lane == 0 && word < W) rec[REC_FIELDS + word] = (int)bal;
  }
  // every thread that wrote set words orders them before thread 0's
  // ticket
  __threadfence();
  __syncthreads();

  if (t == 0) {
    float gain = onehot ? oh_gain : (use_rev ? s_bg[1] : s_bg[0]);
    if (!fmask) gain = -INFINITY;
    if (p.max_depth > 0 && !(depth < (float)p.max_depth)) gain = -INFINITY;
    float lg, lh, lc;
    if (onehot) {
      lg = hgr[oh_bin];
      lh = hhr[oh_bin] + K_EPS;
      lc = 0.0f;
      if (oh_bin >= 1 && oh_bin < nb)
        lc = floorf(hhr[oh_bin] * cnt_factor + 0.5f);
    } else if (use_rev) {
      const int idx = used - 2 - bi;
      lg = tvg - (idx >= 0 ? x_pg[idx] : 0.0f);
      lh = (tvh - (idx >= 0 ? x_ph[idx] : 0.0f)) + K_EPS;
      lc = tvc - (idx >= 0 ? x_pc[idx] : 0.0f);
    } else {
      lg = x_pg[bi];
      lh = x_ph[bi] + K_EPS;
      lc = x_pc[bi];
    }
    rec[0] = __float_as_int(gain);
    rec[1] = __float_as_int(lg);
    rec[2] = __float_as_int(lh);
    rec[3] = __float_as_int(lc);
    rec[4] = __float_as_int(onehot ? p.l2 : q.l2c);
    rec[5] = __float_as_int(mgs);
    __threadfence();
    s_last = atomicAdd(work + C * NC * rec_words, 1) == C * NC - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  merge_best<MONO>(pair, cat_out, work, info, cat_feats, F, C, NC, rec_words,
                   W, l1, mds);
  if (t == 0) work[C * NC * rec_words] = 0;
}

// BF <= 256: cat_search, W = 8 and the records 16 words; wider:
// cat_search_wide, W = ceil(BF / 32) and its scratch rows after the
// records and the ticket (ops/split_cat.py new_work).  mono: the
// monotone arm.
template <bool MONO>
static void launch(bool wide, cudaStream_t st, const float* hg,
                   const float* hh, const int* fmeta, const float* info,
                   const int* cat_feats, float* pair, int* cat_out, int* work,
                   int F, int C, int BF, int NC, int W, const Params& p,
                   const CatParams& q) {
  if (wide)
    cat_search_wide<MONO><<<dim3(NC, C), NT, 0, st>>>(
        hg, hh, fmeta, info, cat_feats, pair, cat_out, work, F, C, BF, NC, W,
        p, q);
  else
    cat_search<MONO><<<dim3(NC, C), NT, 0, st>>>(
        hg, hh, fmeta, info, cat_feats, pair, cat_out, work, F, C, BF, NC,
        p, q);
}

extern "C" int split_cat_launch(const float* hg, const float* hh,
                                const int* fmeta, const float* info,
                                const int* cat_feats, float* pair,
                                int* cat_out, int* work, int F, int C, int BF,
                                int NC, int W, float l1, float l2,
                                float max_delta_step, float min_gain_to_split,
                                float min_data_in_leaf, float min_sum_hessian,
                                int max_depth, int max_cat_threshold,
                                float l2c, float cat_smooth,
                                int max_cat_to_onehot,
                                float min_data_per_group, int mono,
                                void* stream) {
  const bool wide = BF > MAX_BF;
  if (BF < 1 || F < 1 || C < 1 || C > 65535 || NC < 1 || NC > F ||
      W != (wide ? (BF + 31) / 32 : CAT_WORDS))
    return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, max_delta_step, min_gain_to_split, min_data_in_leaf,
                 min_sum_hessian, max_depth};
  const CatParams q{max_cat_threshold, l2c, cat_smooth, max_cat_to_onehot,
                    min_data_per_group};
  const cudaStream_t st = (cudaStream_t)stream;
  if (mono)
    launch<true>(wide, st, hg, hh, fmeta, info, cat_feats, pair, cat_out,
                 work, F, C, BF, NC, W, p, q);
  else
    launch<false>(wide, st, hg, hh, fmeta, info, cat_feats, pair, cat_out,
                  work, F, C, BF, NC, W, p, q);
  return (int)cudaGetLastError();
}
