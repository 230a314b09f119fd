// Split mega-kernel on Hopper: partition one leaf's rows and build both
// children's histograms from the same split decision.
//
// Replaces the TPU kernel split_megakernel_pallas
// (lightgbm_tpu/ops/split_megakernel_pallas.py); its plain PyTorch
// versions are split_mega_plain (the f32 contract the CPU runs) and
// hist_fixed_plain (this kernel's histogram arithmetic, bit for bit) in
// lightgbm_tpu_torch/ops/split_mega.py.  The contract (ops/partition.py):
// a stable two-way partition of the leaf range [start, start + cnt) of
// the (R, Np) uint8 bin rows and the eight (8, Np) 32-bit payload rows
// (moved as raw words: row 2 holds row ids), the left count, and the
// (G, 4, Bp) histogram -- left-grad, left-hess, right-grad, right-hess
// over bin = hi * 16 + lo -- of the rows as they were before the
// partition.  cnt == 0 moves nothing and returns zeros; move == 0 builds
// the histogram only and reports cnt as the left count.  The TPU
// kernel's packed payload and roll-network compaction are its own
// mechanism and are not carried over.
//
// What bounds it on this card: bytes by the roofline, (R + 32) per row
// moved by the partition and G + 9 read by the histogram; in practice
// the histogram's shared-memory adds, two 64-bit adds per (row, group).
// The design:
//   mega_hist  the order-independent fixed-point histogram of
//              csrc/hist_fixed.cuh (shared with csrc/leaf_hist.cu), with
//              four planes a group -- left grad, left hess, right grad,
//              right hess -- and each row's side from the decision
//              column, read once a 16-row unit with the rows' grad and
//              hess.  8 KB a group at Bp = 256: all 28 of HIGGS in one
//              block.
//   then the two partition launches of csrc/partition.cuh, shared with
//   csrc/partition.cu.  Three launches per split (one for move == 0).
// The histogram is not fused into the partition's tile pass: the staged
// tile and 8 KB per group do not fit one SM's shared memory together.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"
#include "partition.cuh"

struct HistArgs {
  const uint8_t* bins;          // (R, Np)
  long long Np;
  const float* ghi;             // rows 0, 1: grad, hess
  long long start;
  int cnt;                      // > 0
  SplitDecision d;
  int G, GB, Bp;                // groups, groups per block, padded bins
  const float* absmax;          // (2,): bounds of |grad|, |hess|
  unsigned long long* acc;      // (G, 4, Bp), zero before and after
  unsigned* done;               // one per group set, zero before and after
  float* hist;                  // (G, 4, Bp)
  int* nl_out;
  int set_nl;                   // >= 0: written to nl_out
};

__global__ void __launch_bounds__(HIST_THREADS, 1) mega_hist(HistArgs a) {
  extern __shared__ __align__(16) unsigned shist[];
  const int tid = threadIdx.x;
  const int Bp = a.Bp;
  const int g_lo = blockIdx.y * a.GB;
  const int gn = min(a.GB, a.G - g_lo);
  unsigned* slo = shist;                  // low words, (gn, 4, Bp)
  unsigned* shi = shist + a.GB * 4 * Bp;  // high words
  for (int i = tid; i < 2 * a.GB * 4 * Bp; i += HIST_THREADS) shist[i] = 0u;
  if (a.set_nl >= 0 && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    a.nl_out[0] = a.set_nl;
  const int kg = fixed_exponent(a.absmax[0], a.cnt);
  const int kh = fixed_exponent(a.absmax[1], a.cnt);
  __syncthreads();

  const uint8_t* crow = a.bins + (long long)a.d.col * a.Np;
  const SplitDecision d = a.d;
  hist_fixed_rows<4>(a.bins, a.Np, a.ghi, a.start, a.cnt, g_lo, gn, Bp,
                     ldexp(1.0, kg), ldexp(1.0, kh), slo, shi,
                     [&](long long r0) {
                       const uint4 cv = *(const uint4*)(crow + r0);
                       const unsigned cw[4] = {cv.x, cv.y, cv.z, cv.w};
                       unsigned right = 0u;
#pragma unroll
                       for (int t = 0; t < 16; ++t)
                         right |= (unsigned)!decide_left(
                                      (cw[t >> 2] >> (8 * (t & 3))) & 0xff,
                                      d)
                                  << t;
                       return right;
                     });
  __syncthreads();

  const long long base = (long long)g_lo * 4 * Bp;
  float* out = a.hist + base;
  hist_fixed_finish(slo, shi, gn * 4 * Bp, Bp, a.acc + base,
                    a.done + blockIdx.y, ldexp(1.0, -kg), ldexp(1.0, -kh),
                    NoPre(),
                    [&](int i, long long, long long, float v) { out[i] = v; });
}

// Enqueue mega_hist (cnt > 0) on its grid (hist_grid).
static cudaError_t launch_hist(HistArgs a, cudaStream_t s) {
  HistGrid g;
  const long long nu = (a.start + a.cnt - (a.start & ~15LL) + 15) >> 4;
  cudaError_t e = hist_grid(a.G, 4, a.Bp, nu, &g);
  if (e != cudaSuccess) return e;
  a.GB = g.GB;
  e = cudaFuncSetAttribute(mega_hist,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           g.smem);
  if (e != cudaSuccess) return e;
  mega_hist<<<dim3(g.nrb, g.ngb), HIST_THREADS, g.smem, s>>>(a);
  return cudaGetLastError();
}

extern "C" int split_mega_launch(
    uint8_t* bins, int R, long long Np, uint32_t* ghi, int* nl_out,
    unsigned long long* status, unsigned* ticket, unsigned epoch, int T,
    int ntiles, uint8_t* sbins, uint32_t* sghi, long long scap,
    long long start, int cnt, int col, int bstart, int isb, int nb, int dbin,
    int mtype, int thr, int dl, const float* absmax,
    unsigned long long* acc, unsigned* done, float* hist, int G, int Bp,
    int move, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Bp < 16 || Bp > MAX_BP || Bp % 16 || G < 1 || G > R || col < 0 ||
      col >= R || cnt < 0 || start < 0 || start + cnt > Np || Np % 16 ||
      ((uintptr_t)bins | (uintptr_t)ghi) % 16)
    return (int)cudaErrorInvalidValue;
  if (cnt == 0) {
    cudaMemsetAsync(hist, 0, sizeof(float) * 4 * (size_t)G * Bp, s);
    part_set_count<<<1, 1, 0, s>>>(nl_out, 0);
    return (int)cudaGetLastError();
  }
  const SplitDecision d{col, bstart, isb, nb, dbin, mtype, thr, dl};
  const PartArgs p{bins, ghi, Np, R, start, cnt, d, T, ntiles, status,
                   ticket, epoch, nl_out, sbins, sghi, scap};
  if (move && !part_args_ok(p)) return (int)cudaErrorInvalidValue;
  const HistArgs h{bins, Np, (const float*)ghi, start, cnt, d, G, 0, Bp,
                   absmax, acc, done, hist, nl_out, move ? -1 : cnt};
  cudaError_t e = launch_hist(h, s);
  if (e != cudaSuccess || !move) return (int)e;
  return (int)partition_phases(p, s);
}
