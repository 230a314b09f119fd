// Row sampling of the fused iteration on Hopper: bagging, balanced
// bagging and GOSS as one pass over the payload.
//
// It has no TPU kernel to replace: the JAX package draws and masks in XLA
// inside its fused iteration (_setup_fused_phys,
// lightgbm_tpu/models/boosting.py).  Plain PyTorch version: sample_plain
// in lightgbm_tpu_torch/ops/sample.py; the two agree bit for bit.
//
// The draw is JAX's: Threefry-2x32 (20 rounds) of the host key over the
// counter (0, i), the two words xor-ed, then (bits >> 9 | 0x3F800000) as
// an f32 minus 1 (lightgbm_tpu_torch/utils/random.py).  i is the row's
// original id from payload row 2 (bagging: JAX's uniform over N + 1 draws
// taken at the row id; pad rows, whose id is N, are never sampled), or
// its physical position (GOSS: JAX's uniform over the padded rows).
//   mode 0 (bagging): in the bag when u < frac;
//   mode 1 (balanced): u < pos_frac where row sign_row is > 0, else
//     u < neg_frac;
//   mode 2 (GOSS): a top row when |g h| >= *thr; another real row is kept
//     when u < other_k / max(N - *n_top, 1) in f32, and scaled by mult.
// Rows 0 and 1 (grad, hess) keep their value in the bag and become +0 out
// of it (the JAX package's g * mask is a select in XLA), or are multiplied
// in place by the GOSS scale 1, mult or 0; the count of sampled rows is
// added to *bag (zeroed by the wrapper): one block-wide reduction and one
// integer atomic a block, exact in any order.
//
// What bounds it on this card: bytes -- it reads payload rows 0-2 (and the
// sign row) and writes rows 0 and 1, 20-24 bytes a row; the draw is about
// a hundred 32-bit integer operations a row.  Grid-stride blocks of 256
// threads, one row a thread a round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

#define SAMPLE_THREADS 256
#define MODE_BAG 0
#define MODE_BALANCED 1
#define MODE_GOSS 2

__global__ void __launch_bounds__(SAMPLE_THREADS)
sample(float* __restrict__ ghi, int* bag, const float* thr, const int* n_top,
       int Np, int N, int mode, int sign_row, uint32_t k0, uint32_t k1,
       float frac, float pos_frac, float neg_frac, float mult, int other_k) {
  __shared__ int red[SAMPLE_THREADS / 32];
  float* g = ghi;
  float* h = ghi + Np;
  const int* rowid = (const int*)(ghi + 2 * (long long)Np);
  const float* sgn = ghi + (long long)sign_row * Np;
  float t = 0.0f, prob = 0.0f;
  if (mode == MODE_GOSS) {
    t = *thr;
    prob = (float)other_k / (float)max(N - *n_top, 1);
  }
  int cnt = 0;
  for (int p = blockIdx.x * SAMPLE_THREADS + threadIdx.x; p < Np;
       p += gridDim.x * SAMPLE_THREADS) {
    const int id = rowid[p];
    const bool real = id != N;
    const float gv = g[p], hv = h[p];
    bool sel;
    if (mode == MODE_GOSS) {
      const float u = bits_uniform(threefry_bits(k0, k1, (uint32_t)p));
      const bool top = real && fabsf(gv * hv) >= t;
      const bool keep = !top && real && u < prob;
      const float scale = top ? 1.0f : (keep ? mult : 0.0f);
      g[p] = gv * scale;
      h[p] = hv * scale;
      sel = top || keep;
    } else {
      const float u =
          bits_uniform(threefry_bits(k0, k1, (uint32_t)(real ? id : N)));
      const float fr =
          mode == MODE_BAG ? frac : (sgn[p] > 0.0f ? pos_frac : neg_frac);
      sel = real && u < fr;
      g[p] = sel ? gv : 0.0f;
      h[p] = sel ? hv : 0.0f;
    }
    cnt += sel;
  }
  for (int o = 16; o > 0; o >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < SAMPLE_THREADS / 32; ++w) s += red[w];
    if (s) atomicAdd(bag, s);
  }
}

extern "C" int sample_launch(float* ghi, int* bag, const float* thr,
                             const int* n_top, int Np, int N, int mode,
                             int sign_row, unsigned k0, unsigned k1,
                             float frac, float pos_frac, float neg_frac,
                             float mult, int other_k, void* stream) {
  if (ghi == nullptr || bag == nullptr || Np < 1 || N < 0 || N >= Np ||
      mode < MODE_BAG || mode > MODE_GOSS ||
      (mode == MODE_GOSS && (thr == nullptr || n_top == nullptr)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (Np + SAMPLE_THREADS - 1) / SAMPLE_THREADS;
  const int blocks = (int)(need < 8LL * sms ? need : 8LL * sms);
  sample<<<blocks, SAMPLE_THREADS, 0, (cudaStream_t)stream>>>(
      ghi, bag, thr, n_top, Np, N, mode, sign_row, k0, k1, frac, pos_frac,
      neg_frac, mult, other_k);
  return (int)cudaGetLastError();
}
