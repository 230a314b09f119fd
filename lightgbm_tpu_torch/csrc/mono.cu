// Intermediate monotone constraints on Hopper: after each split, every
// leaf's output bounds from the leaves it is comparable with, the search
// planes of the leaves whose bounds changed, and the overlay of their
// re-searched best splits.  The tree's captured CUDA graph runs them
// between a split's commit and the next election (csrc/tree_step.cu),
// around one pair search over all L leaves (csrc/split_pair.cu's
// monotone arm, and csrc/split_cat.cu's with categorical features).
//
// It has no TPU kernel to replace: the JAX package's _mc_refresh
// (lightgbm_tpu/models/learner.py; the reference's
// IntermediateLeafConstraints, monotone_constraints.hpp) is XLA inside
// its while-loop body.  Plain PyTorch versions: mono_refresh_plain,
// mono_planes_fixed_plain and mono_overlay_plain in
// lightgbm_tpu_torch/ops/mono.py, bit for bit: integer comparisons,
// maxima and minima of f32 values, the int64 -> f32 conversion of the
// histogram state's children, copies.
//
// mono_refresh, one block a leaf Y (the grid covers the leaf pairs):
// its threads take the other live leaves X (the step block's SB_S + 1;
// nothing when SB_DONE says the tree stopped).  Y and X are comparable
// along monotone feature m when their bin boxes ((2, L + 1, F) int32, lo
// then hi, written by tree_step) overlap in every feature but m and are
// disjoint along m; then X's output bounds Y from below when m's
// direction puts X below Y, from above when it puts X above.  The block
// reduces the largest lower and the smallest upper bound (-inf / +inf
// when none), writes them into leafmat's LM_CMIN / LM_CMAX, the changed
// flag, and Y's F info rows of the re-search (sums, bag-aware count,
// depth, feature mask, bounds: ops/split_pair.py IN_*).
//
// mono_planes, one block a (changed leaf, search row): the leaf's
// histogram-state slot ((slots, 2, G, Bp) int64, csrc/leaf_hist.cu) as
// the search's (2, L, F, Bp) f32 planes, (int64 -> double) * 2^-k -> f32
// and times the quantized scale when there is one, as the state kernel
// converts the children it hands the search; with EFB bundles (meta:
// the (4, F) feature view) the per-feature view of csrc/feat_view.cu,
// a bundled default bin fixed in exact int64.
//
// mono_overlay: each changed leaf's re-searched 13 fields into leafmat's
// LM_BGAIN .. LM_BISCAT and, with categorical features, its set into
// leafcat.
//
// What bounds them on this card: latency, and for mono_planes the bytes
// of the changed leaves' state slots.  The refresh does L x live x F
// integer comparisons (255 x 255 x 28 at HIGGS' 255 leaves).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hist_fixed.cuh"
#include "step.cuh"
#include "tree_cols.cuh"

#define MONO_THREADS 256
#define MONO_ROW 7          // fmeta's monotone direction row
#define INFO_COLS 8
#define IN_CMIN 5
#define IN_CMAX 6

__global__ void __launch_bounds__(MONO_THREADS)
    mono_refresh(float* lm, const int* __restrict__ boxes,
                 const int* __restrict__ fmeta, const int* step,
                 const float* __restrict__ fmask, int* changed,
                 float* __restrict__ info, int L, int F) {
  __shared__ float s_mn[MONO_THREADS / 32], s_mx[MONO_THREADS / 32];
  const int y = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int L1 = L + 1;
  if (step[SB_DONE]) {
    if (tid == 0) changed[y] = 0;
    return;
  }
  const int live = step[SB_S] + 1;
  const int* lo = boxes;
  const int* hi = boxes + (long long)L1 * F;
  float cmin = lm[LM_CMIN * L1 + y], cmax = lm[LM_CMAX * L1 + y];
  if (y < live) {
    float mn = -INFINITY, mx = INFINITY;
    for (int x = tid; x < live; x += MONO_THREADS) {
      int miss = 0, m = 0;
      for (int f = 0; f < F && miss < 2; ++f) {
        if (!(lo[y * F + f] <= hi[x * F + f] &&
              lo[x * F + f] <= hi[y * F + f])) {
          ++miss;
          m = f;
        }
      }
      if (miss != 1) continue;
      const int dir = fmeta[MONO_ROW * F + m];
      if (dir == 0) continue;
      const bool below = hi[x * F + m] < lo[y * F + m];   // X below Y
      const bool above = lo[x * F + m] > hi[y * F + m];
      const float v = lm[LM_VALUE * L1 + x];
      if (dir > 0 ? below : above) mn = fmaxf(mn, v);
      if (dir > 0 ? above : below) mx = fminf(mx, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = fmaxf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fminf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
      s_mn[w] = mn;
      s_mx[w] = mx;
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 1; j < MONO_THREADS / 32; ++j) {
        mn = fmaxf(mn, s_mn[j]);
        mx = fminf(mx, s_mx[j]);
      }
      changed[y] = mn != cmin || mx != cmax;
      lm[LM_CMIN * L1 + y] = mn;
      lm[LM_CMAX * L1 + y] = mx;
      s_mn[0] = mn;
      s_mx[0] = mx;
    }
    __syncthreads();
    cmin = s_mn[0];
    cmax = s_mx[0];
  } else if (tid == 0) {
    changed[y] = 0;
  }
  const float sg = lm[LM_SUM_G * L1 + y], sh = lm[LM_SUM_H * L1 + y];
  const float cnt = (float)__float_as_int(lm[LM_CNT_G * L1 + y]);
  const float depth = (float)__float_as_int(lm[LM_DEPTH * L1 + y]);
  float* rows = info + (long long)y * F * INFO_COLS;
  for (int i = tid; i < F * INFO_COLS; i += MONO_THREADS) {
    const int k = i & (INFO_COLS - 1);
    float v = 0.0f;
    if (k == 0) v = sg;
    if (k == 1) v = sh;
    if (k == 2) v = cnt;
    if (k == 3) v = depth;
    if (k == 4) v = fmask[i / INFO_COLS];
    if (k == IN_CMIN) v = cmin;
    if (k == IN_CMAX) v = cmax;
    rows[i] = v;
  }
}

__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  const int tid = threadIdx.x;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  long long s = 0;
  if (tid == 0)
    for (int w = 0; w < MONO_THREADS / 32; ++w) s += red[w];
  __syncthreads();
  if (tid == 0) red[0] = s;
  __syncthreads();
  s = red[0];
  __syncthreads();
  return s;
}

// grid (L, F): blockIdx.x the leaf, blockIdx.y the search row.
__global__ void __launch_bounds__(MONO_THREADS)
    mono_planes(const long long* __restrict__ state,
                const int* __restrict__ changed, const float* absmax,
                const int* __restrict__ meta, int G, int F, int Bp, int L,
                int kcnt, const float* scale, float* __restrict__ out) {
  __shared__ long long red[MONO_THREADS / 32];
  const int l = blockIdx.x, f = blockIdx.y, tid = threadIdx.x;
  if (!changed[l]) return;
  int g = f, bs = 0, isb = 0, nb = Bp;
  if (meta) {
    g = meta[f];
    bs = meta[F + f];
    isb = meta[2 * F + f];
    nb = meta[3 * F + f];
  }
  for (int p = 0; p < 2; ++p) {
    const long long* row = state + (((long long)l * 2 + p) * G + g) * Bp;
    long long fix = 0;
    if (isb) {
      long long tot = 0, own = 0;
      for (int b = tid; b < Bp; b += MONO_THREADS) {
        tot += row[b];
        if (b < nb && b >= 1) own += row[bs + b];
      }
      tot = block_sum(tot, red);
      own = block_sum(own, red);
      fix = tot - own;
    }
    const double inv = ldexp(1.0, -fixed_exponent(absmax[p], kcnt));
    float* o = out + (((long long)p * L + l) * F + f) * Bp;
    for (int b = tid; b < Bp; b += MONO_THREADS) {
      long long v = 0;
      if (b < nb && (!isb || b >= 1)) v = row[isb ? bs + b : b];
      if (isb && b == 0) v = fix;
      const float x = (float)((double)v * inv);
      o[b] = scale ? __fmul_rn(x, scale[p]) : x;
    }
  }
}

__global__ void __launch_bounds__(MONO_THREADS)
    mono_overlay(float* lm, int* leafcat, const int* __restrict__ changed,
                 const float* __restrict__ rows, const int* __restrict__ cats,
                 int L, int W) {
  const int per = SEG + (cats ? W : 0);
  const long long i = (long long)blockIdx.x * MONO_THREADS + threadIdx.x;
  if (i >= (long long)L * per) return;
  const int l = (int)(i / per), j = (int)(i % per);
  if (!changed[l]) return;
  if (j < SEG)
    lm[(LM_BGAIN + j) * (L + 1) + l] = rows[l * SEG + j];
  else
    leafcat[l * W + j - SEG] = cats[l * W + j - SEG];
}

extern "C" int mono_refresh_launch(float* lm, const int* boxes,
                                   const int* fmeta, const int* step,
                                   const float* fmask, int* changed,
                                   float* info, int L, int F, void* stream) {
  if (L < 1 || F < 1 || lm == nullptr || boxes == nullptr ||
      fmeta == nullptr || step == nullptr || changed == nullptr ||
      info == nullptr)
    return (int)cudaErrorInvalidValue;
  mono_refresh<<<L, MONO_THREADS, 0, (cudaStream_t)stream>>>(
      lm, boxes, fmeta, step, fmask, changed, info, L, F);
  return (int)cudaGetLastError();
}

extern "C" int mono_planes_launch(const long long* state, const int* changed,
                                  const float* absmax, const int* meta, int G,
                                  int F, int Bp, int L, int kcnt,
                                  const float* scale, float* out,
                                  void* stream) {
  if (L < 1 || F < 1 || F > 65535 || G < 1 || Bp < 1 || kcnt < 1 ||
      state == nullptr || out == nullptr || (meta == nullptr && F != G))
    return (int)cudaErrorInvalidValue;
  mono_planes<<<dim3(L, F), MONO_THREADS, 0, (cudaStream_t)stream>>>(
      state, changed, absmax, meta, G, F, Bp, L, kcnt, scale, out);
  return (int)cudaGetLastError();
}

extern "C" int mono_overlay_launch(float* lm, int* leafcat, const int* changed,
                                   const float* rows, const int* cats, int L,
                                   int W, void* stream) {
  if (L < 1 || W < 1 || lm == nullptr || changed == nullptr ||
      rows == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)L * (SEG + (cats ? W : 0));
  mono_overlay<<<(unsigned)((n + MONO_THREADS - 1) / MONO_THREADS),
                 MONO_THREADS, 0, (cudaStream_t)stream>>>(
      lm, leafcat, changed, rows, cats, L, W);
  return (int)cudaGetLastError();
}
