// Quantized-gradient training on Hopper: the discretizer as one pass over
// the payload.
//
// It has no TPU kernel to replace: the JAX package discretizes in XLA,
// inside its fused iteration (_setup_fused_phys) or in its eager one
// (_discretize_gradients, lightgbm_tpu/models/boosting.py; reference:
// GradientDiscretizer::DiscretizeGradients).  Plain PyTorch version:
// quantize_plain in lightgbm_tpu_torch/ops/quantize.py; the two agree
// bit for bit (every f32 operation below is one IEEE operation, and the
// kernels build with --fmad=false).
//
// In: payload rows 0 and 1 (this iteration's grad and hess after
// sampling, zero on pad rows), row 2 (the rows' original ids as int32
// bits; pad rows hold N), and absmax (2,) f32 = max|grad|, max|hess| over
// the payload, from a device reduction.  Then
//   gs = max(max|g| / (bins / 2), 1e-30),
//   hs = max(const_h ? max|h| : max|h| / bins, 1e-30),
//   g <- trunc(g / gs + (g >= 0 ? u_g : -u_g)) * vf,
//   h <- (const_h ? 1 : trunc(h / hs + u_h)) * vf,
// vf = 0 on pad rows and 1 elsewhere, u the uniform draws of the keys
// (kg0, kg1) and (kh0, kh1) at the row's physical position (the fused
// iteration: JAX's uniform over the padded width) or at its original id
// (by_rowid: the eager iteration's draw over the N rows), or 0.5 without
// stochastic rounding.  (gs, hs) go to the (2,) f32 device word scale,
// which the histogram kernels' scale arms read.  With tg_row >= 0 the
// grad and hess as they came in (the true ones) are copied first into
// payload rows tg_row and th_row, which ride the tree's partition to the
// quantized leaf renewal (quant_train_renew_leaf).
//
// What bounds it on this card: bytes -- it reads payload rows 0-2 and
// writes rows 0 and 1 (and the two true rows), 20 (28) bytes a row; the
// two draws are about two hundred 32-bit integer operations a row.
// Grid-stride blocks of 256 threads, one row a thread a round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

#define QUANT_THREADS 256

// jnp.maximum(x, lo): NaN propagates
__device__ __forceinline__ float max_nan(float x, float lo) {
  return (x != x || x > lo) ? x : lo;
}

__global__ void __launch_bounds__(QUANT_THREADS)
quantize(float* __restrict__ ghi, const float* __restrict__ absmax,
         float* __restrict__ scale, long long Np, int N, float half_bins,
         float bins, int const_h, int stochastic, int by_rowid, uint32_t kg0,
         uint32_t kg1, uint32_t kh0, uint32_t kh1, int tg_row, int th_row) {
  const float gs = max_nan(__fdiv_rn(absmax[0], half_bins), 1e-30f);
  const float hs =
      max_nan(const_h ? absmax[1] : __fdiv_rn(absmax[1], bins), 1e-30f);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scale[0] = gs;
    scale[1] = hs;
  }
  float* g = ghi;
  float* h = ghi + Np;
  const int* rowid = (const int*)(ghi + 2 * Np);
  for (long long p = (long long)blockIdx.x * QUANT_THREADS + threadIdx.x;
       p < Np; p += (long long)gridDim.x * QUANT_THREADS) {
    const int id = rowid[p];
    const float vf = id != N ? 1.0f : 0.0f;
    const float gv = g[p], hv = h[p];
    if (tg_row >= 0) {
      ghi[tg_row * Np + p] = gv;
      ghi[th_row * Np + p] = hv;
    }
    const uint32_t i = by_rowid ? (uint32_t)id : (uint32_t)p;
    float rg = 0.5f, rh = 0.5f;
    if (stochastic) {
      rg = bits_uniform(threefry_bits(kg0, kg1, i));
      if (!const_h) rh = bits_uniform(threefry_bits(kh0, kh1, i));
    }
    const float ig =
        truncf(__fadd_rn(__fdiv_rn(gv, gs), gv >= 0.0f ? rg : -rg));
    const float ih =
        const_h ? 1.0f : truncf(__fadd_rn(__fdiv_rn(hv, hs), rh));
    g[p] = __fmul_rn(ig, vf);
    h[p] = __fmul_rn(ih, vf);
  }
}

extern "C" int quantize_launch(float* ghi, int R, long long Np, int N,
                               const float* absmax, float* scale, int bins,
                               int const_h, int stochastic, int by_rowid,
                               unsigned kg0, unsigned kg1, unsigned kh0,
                               unsigned kh1, int tg_row, int th_row,
                               void* stream) {
  if (ghi == nullptr || absmax == nullptr || scale == nullptr || Np < 1 ||
      N < 0 || N >= Np || R < 3 || bins < 1 ||
      (tg_row >= 0 &&
       (tg_row < 3 || th_row < 3 || tg_row >= R || th_row >= R ||
        tg_row == th_row)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (Np + QUANT_THREADS - 1) / QUANT_THREADS;
  const int blocks = (int)(need < 8LL * sms ? need : 8LL * sms);
  quantize<<<blocks, QUANT_THREADS, 0, (cudaStream_t)stream>>>(
      ghi, absmax, scale, Np, N, (float)(bins / 2.0), (float)bins, const_h,
      stochastic, by_rowid, kg0, kg1, kh0, kh1, tg_row, th_row);
  return (int)cudaGetLastError();
}
