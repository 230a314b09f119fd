// The per-feature histogram view of EFB-bundled data on Hopper
// (FixHistogram), between the histogram state's update and the pair
// search of the histogram-subtraction split path.
//
// It has no TPU kernel to replace: the JAX package gathers in XLA
// (_feat_view, lightgbm_tpu/models/learner.py).  Plain PyTorch
// versions: feat_view_plain (the f32 arithmetic the CPU runs) and
// feat_view_fixed_plain (this kernel's, bit for bit) in
// lightgbm_tpu_torch/ops/feat_view.py.
//
// In: the (slots, 2, G, Bp) int64 histogram state (csrc/leaf_hist.cu's
// exact fixed-point sums), the step block (csrc/step.cuh: the children's
// slots SB_WA and SB_WB; for the root both are slot 0), the tree's (2,)
// |grad| / |hess| bound and the count kcnt that set the scale 2^k, and
// the (4, F) feature rows group, bin_start, is_bundled, num_bin.  Out:
// (2, 2, F, Bp) f32 = (plane, child, feature, bin), the pair search's
// grad and hess inputs.  Feature f of group g reads, for bin b < num_bin,
// column b of g's row (alone) or column bin_start + b (bundled, b >= 1);
// a bundled feature's bin 0 is the group's total minus its bins 1 ..
// num_bin - 1, exact in int64; bins past num_bin are 0.  Every value is
// then (int64 -> double) * 2^-k -> f32, as the state's f32 children are,
// and in quantized training (scale != null: the (2,) device word of
// csrc/quantize.cu) times the plane's scale, one f32 product (the scale
// arm, as csrc/leaf_hist.cu's children).
// A step of no rows (cnt == 0) gives zeros.
//
// What bounds it on this card: latency.  Per split it reads two slots'
// group rows (2 x 2 x G x Bp x 8 bytes, ~0.5 MB at G = 36, Bp = 48) and
// writes 2 x 2 x F x Bp x 4 bytes; one block a (child, feature), one
// thread a bin, the two sums a block reduction in int64 (exact in any
// order).  One launch a split inside the tree's graph, in place of the
// gather and fix as plain PyTorch operations (about five launches).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hist_fixed.cuh"
#include "step.cuh"

#define FV_THREADS 256

__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  const int tid = threadIdx.x;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  long long s = 0;
  if (tid == 0)
    for (int w = 0; w < FV_THREADS / 32; ++w) s += red[w];
  __syncthreads();
  if (tid == 0) red[0] = s;
  __syncthreads();
  s = red[0];
  __syncthreads();
  return s;
}

// The scale arm: the f32 value times the plane's quantization scale.
__device__ __forceinline__ float scaled(float v, const float* scale, int p) {
  return scale ? __fmul_rn(v, scale[p]) : v;
}

// grid (F, 2): blockIdx.x the feature, blockIdx.y the child.
__global__ void __launch_bounds__(FV_THREADS)
feat_view(const long long* __restrict__ state, const int* step,
          const float* absmax, const int* __restrict__ meta, int slots,
          int G, int F, int Bp, int kcnt, const float* scale,
          float* __restrict__ out) {
  __shared__ long long red[FV_THREADS / 32];
  const int f = blockIdx.x, c = blockIdx.y, b = threadIdx.x;
  const int cnt = step[SB_CNT];
  const int slot = step[c ? SB_WB : SB_WA];
  const int g = meta[f], bs = meta[F + f], isb = meta[2 * F + f];
  const int nb = meta[3 * F + f];
  const bool live = cnt != 0 && slot >= 0 && slot < slots;
  for (int p = 0; p < 2; ++p) {
    const long long* row =
        state + (((long long)(live ? slot : 0) * 2 + p) * G + g) * Bp;
    long long v = 0;
    if (live && b < Bp && b < nb && (!isb || b >= 1))
      v = row[isb ? bs + b : b];
    if (isb) {
      // the group's total and the feature's own bins, both exact
      const long long tot = block_sum(live && b < Bp ? row[b] : 0ll, red);
      const long long own = block_sum(v, red);
      if (b == 0) v = live ? tot - own : 0ll;
    }
    if (b < Bp) {
      const double inv = ldexp(1.0, -fixed_exponent(absmax[p], kcnt));
      out[(((long long)p * 2 + c) * F + f) * Bp + b] =
          scaled((float)((double)v * inv), scale, p);
    }
  }
}

// Bp > FV_THREADS (uint16 data, whose groups are as wide as the widest
// feature): the same view, each thread striding over the bins; the
// group's total and the feature's own bins are exact int64 sums in any
// order, so the result is the one-bin-a-thread kernel's.  At Bp <=
// FV_THREADS it is slower (it reads a bundled bin twice, around the
// block sums): 4.9-5.0 us a launch against 3.9 on an H100 on EFB data
// at Bp = 48 (chip_smoke.py --efb), so the narrow kernel stays.
__global__ void __launch_bounds__(FV_THREADS)
feat_view_wide(const long long* __restrict__ state, const int* step,
               const float* absmax, const int* __restrict__ meta, int slots,
               int G, int F, int Bp, int kcnt, const float* scale,
               float* __restrict__ out) {
  __shared__ long long red[FV_THREADS / 32];
  const int f = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int cnt = step[SB_CNT];
  const int slot = step[c ? SB_WB : SB_WA];
  const int g = meta[f], bs = meta[F + f], isb = meta[2 * F + f];
  const int nb = meta[3 * F + f];
  const bool live = cnt != 0 && slot >= 0 && slot < slots;
  for (int p = 0; p < 2; ++p) {
    const long long* row =
        state + (((long long)(live ? slot : 0) * 2 + p) * G + g) * Bp;
    long long fix = 0;
    if (isb) {
      long long tot = 0, own = 0;
      for (int b = tid; b < Bp; b += FV_THREADS) {
        if (live) tot += row[b];
        if (live && b < nb && b >= 1) own += row[bs + b];
      }
      tot = block_sum(tot, red);
      own = block_sum(own, red);
      fix = live ? tot - own : 0ll;
    }
    const double inv = ldexp(1.0, -fixed_exponent(absmax[p], kcnt));
    for (int b = tid; b < Bp; b += FV_THREADS) {
      long long v = 0;
      if (live && b < nb && (!isb || b >= 1)) v = row[isb ? bs + b : b];
      if (isb && b == 0) v = fix;
      out[(((long long)p * 2 + c) * F + f) * Bp + b] =
          scaled((float)((double)v * inv), scale, p);
    }
  }
}

extern "C" int feat_view_launch(const long long* state, const int* step,
                                const float* absmax, const int* meta,
                                int slots, int G, int F, int Bp, int kcnt,
                                const float* scale, float* out,
                                void* stream) {
  if (F < 1 || G < 1 || Bp < 1 || kcnt < 1 || state == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (Bp > FV_THREADS)
    feat_view_wide<<<dim3(F, 2), FV_THREADS, 0, (cudaStream_t)stream>>>(
        state, step, absmax, meta, slots, G, F, Bp, kcnt, scale, out);
  else
    feat_view<<<dim3(F, 2), FV_THREADS, 0, (cudaStream_t)stream>>>(
        state, step, absmax, meta, slots, G, F, Bp, kcnt, scale, out);
  return (int)cudaGetLastError();
}
