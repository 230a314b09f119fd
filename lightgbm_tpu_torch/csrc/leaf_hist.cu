// Leaf histogram on Hopper: per (group, bin) sums of grad and hess over
// one leaf's contiguous rows.
//
// Replaces the TPU kernel leaf_hist_pallas
// (lightgbm_tpu/ops/histogram.py); its plain PyTorch versions are
// leaf_hist_plain (the f32 contract the CPU runs) and
// leaf_hist_fixed_plain (this kernel's arithmetic, bit for bit) in
// lightgbm_tpu_torch/ops/histogram.py.  Output: the (2, G, Bp) f32
// planes (grad plane, hess plane; bin b at column b) of the rows
// [s, s + c) of the (R, Np) uint8 bin rows, grad and hess read from
// payload rows 0 and 1.  The range comes from the host, or -- for a child
// of the split just made, whose size is known only on the device -- from
// the partition's left count nl: side 1 is the left child
// [start, start + nl), side 2 the right child [start + nl, start + cnt).
// The grid is sized for the parent's cnt rows; the child's range, its
// 16-row alignment and its fixed-point scale (from the child's own row
// count) are worked out on the device.  A child of no rows gives zeros.
//
// What bounds it on this card: bytes by the roofline -- each row's G bin
// bytes and its grad and hess words are read once -- and in practice the
// shared-memory adds, two 64-bit adds per (row, group).  The design is
// the fixed-point histogram of csrc/hist_fixed.cuh, shared with the
// split mega-kernel's histogram: exact integer sums by shared-memory
// atomics, in any order, so no lane matching, no per-warp copies and no
// ordered reduction; two planes a group (4 KB at Bp = 256: all 28 HIGGS
// groups in one block); each lane reads its 16 rows' grad and hess once
// for all the block's groups; the group sets combine by 64-bit global
// atomics and the last block converts.  One launch per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"

struct LeafArgs {
  const uint8_t* bins;          // (R, Np)
  long long Np;
  const float* ghi;             // rows 0, 1: grad, hess
  long long start;
  int cnt;                      // > 0: the parent's rows
  const int* nl;                // the partition's left count (side != 0)
  int side;                     // 0 whole range, 1 left child, 2 right
  int G, GB, Bp;                // groups, groups per block, padded bins
  const float* absmax;          // (2,): bounds of |grad|, |hess|
  unsigned long long* acc;      // (G, 2, Bp), zero before and after
  unsigned* done;               // one per group set, zero before and after
  float* hist;                  // (2, G, Bp)
};

__global__ void __launch_bounds__(HIST_THREADS, 1)
    leaf_hist_fixed(LeafArgs a) {
  extern __shared__ __align__(16) unsigned shist[];
  const int tid = threadIdx.x;
  const int Bp = a.Bp;
  const int g_lo = blockIdx.y * a.GB;
  const int gn = min(a.GB, a.G - g_lo);
  unsigned* slo = shist;                  // low words, (gn, 2, Bp)
  unsigned* shi = shist + a.GB * 2 * Bp;  // high words
  for (int i = tid; i < 2 * a.GB * 2 * Bp; i += HIST_THREADS) shist[i] = 0u;
  long long s0 = a.start;
  int c = a.cnt;
  if (a.side == 1) {
    c = *a.nl;
  } else if (a.side == 2) {
    s0 += *a.nl;
    c = a.cnt - *a.nl;
  }
  const int kg = fixed_exponent(a.absmax[0], c);
  const int kh = fixed_exponent(a.absmax[1], c);
  __syncthreads();

  hist_fixed_rows<2>(a.bins, a.Np, a.ghi, s0, c, g_lo, gn, Bp,
                     ldexp(1.0, kg), ldexp(1.0, kh), slo, shi,
                     [](long long) { return 0u; });
  __syncthreads();

  // block entry i = (gl, plane, bin) -> output (plane, g_lo + gl, bin)
  float* hist = a.hist;
  const long long plane = (long long)a.G * Bp;
  hist_fixed_finish(slo, shi, gn * 2 * Bp, Bp,
                    a.acc + (long long)g_lo * 2 * Bp, a.done + blockIdx.y,
                    ldexp(1.0, -kg), ldexp(1.0, -kh), [&](int i, float v) {
                      const int gl = i / (2 * Bp);
                      const int p = (i / Bp) & 1;
                      hist[p * plane + (long long)(g_lo + gl) * Bp +
                           i % Bp] = v;
                    });
}

extern "C" int leaf_hist_launch(const uint8_t* bins, int R, long long Np,
                                const float* ghi, long long start, int cnt,
                                const int* nl, int side, const float* absmax,
                                unsigned long long* acc, unsigned* done,
                                int G, int Bp, float* hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Bp < 16 || Bp > MAX_BP || Bp % 16 || G < 1 || G > R || cnt < 0 ||
      start < 0 || start + cnt > Np || Np % 16 || side < 0 || side > 2 ||
      (side != 0 && nl == nullptr) ||
      ((uintptr_t)bins | (uintptr_t)ghi) % 16)
    return (int)cudaErrorInvalidValue;
  if (cnt == 0) {
    cudaMemsetAsync(hist, 0, sizeof(float) * 2 * (size_t)G * Bp, s);
    return (int)cudaGetLastError();
  }
  HistGrid g;
  const long long nu = (start + cnt - (start & ~15LL) + 15) >> 4;
  cudaError_t e = hist_grid(G, 2, Bp, nu, &g);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(leaf_hist_fixed,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           g.smem);
  if (e != cudaSuccess) return (int)e;
  const LeafArgs a{bins, Np, ghi, start, cnt, nl, side, G, g.GB, Bp,
                   absmax, acc, done, hist};
  leaf_hist_fixed<<<dim3(g.nrb, g.ngb), HIST_THREADS, g.smem, s>>>(a);
  return (int)cudaGetLastError();
}
