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
// mechanism and are not carried over.  Quantized training (scale != null,
// the (2,) device word of csrc/quantize.cu): the grad and hess are
// integer carriers, and each entry is the f32 value of its exact sum
// times the plane's scale, one f32 product (the scale arm; JAX
// learner.py _split_leaf_mega's scaled planes).
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
// The leaf and the decision come from the step block on the device
// (csrc/step.cuh), the grids from a bound on a step's rows; the
// histogram cuts its blocks into group sets and row blocks on the device
// from the step's own count (hist_split).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"
#include "partition.cuh"

// uint8 bins only, as the JAX package's mega kernel (B <= 256): wider
// data takes the histogram-subtraction body
#define MEGA_MAX_BP 256

struct HistArgs {
  const uint8_t* bins;          // (R, Np)
  long long Np;
  int R;
  const float* ghi;             // rows 0, 1: grad, hess
  int* step;                    // the step block: range and decision
  int bound;                    // rows a step may hold
  int G, GBL, Bp, nsm;          // groups, launch's groups a block, bins, SMs
  const float* absmax;          // (2,): bounds of |grad|, |hess|
  unsigned long long* acc;      // (G, 4, Bp), zero before and after
  unsigned* done;               // one per group set, zero before and after
  float* hist;                  // (G, 4, Bp)
  const float* scale;           // (2,) quantized training: (gs, hs), or null
  int* nl_out;
  int move;                     // 0: write cnt to nl_out
};

__global__ void __launch_bounds__(HIST_THREADS, 1) mega_hist(HistArgs a) {
  extern __shared__ __align__(16) unsigned shist[];
  __shared__ Leaf s_leaf;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_leaf = read_leaf(a.step, a.R, a.Np, a.bound);
    if (s_leaf.bad && blockIdx.x == 0) step_error(a.step, ERR_RANGE);
    // categorical data takes the subtraction body (models/learner.py)
    if (s_leaf.d.iscat && blockIdx.x == 0) step_error(a.step, ERR_STEP);
  }
  __syncthreads();
  const Leaf lf = s_leaf;
  const long long nu =
      lf.cnt ? (lf.start + lf.cnt - (lf.start & ~15LL) + 15) >> 4 : 0;
  const HistSplit sp = hist_split(a.G, a.GBL, nu, gridDim.x, a.nsm);
  if ((int)blockIdx.x >= sp.ngb * sp.nrb) return;
  const int set = blockIdx.x / sp.nrb, rb = blockIdx.x % sp.nrb;
  const int Bp = a.Bp;
  const int g_lo = set * sp.GB;
  const int gn = min(sp.GB, a.G - g_lo);
  unsigned* slo = shist;                   // low words, (gn, 4, Bp)
  unsigned* shi = shist + sp.GB * 4 * Bp;  // high words
  for (int i = tid; i < 2 * sp.GB * 4 * Bp; i += HIST_THREADS) shist[i] = 0u;
  if (!a.move && blockIdx.x == 0 && tid == 0) a.nl_out[0] = lf.cnt;
  const int kg = fixed_exponent(a.absmax[0], lf.cnt);
  const int kh = fixed_exponent(a.absmax[1], lf.cnt);
  __syncthreads();

  const uint8_t* crow = a.bins + (long long)lf.d.col * a.Np;
  const SplitDecision d = lf.d;
  hist_fixed_rows<4>(a.bins, a.Np, a.ghi, lf.start, lf.cnt, g_lo, gn, Bp,
                     ldexp(1.0, kg), ldexp(1.0, kh), slo, shi, rb, sp.nrb,
                     [&](long long r0) {
                       const uint4 cv = *(const uint4*)(crow + r0);
                       const unsigned cw[4] = {cv.x, cv.y, cv.z, cv.w};
                       unsigned right = 0u;
#pragma unroll
                       for (int t = 0; t < 16; ++t)
                         right |= (unsigned)!decide_left_num(
                                      (cw[t >> 2] >> (8 * (t & 3))) & 0xff,
                                      d)
                                  << t;
                       return right;
                     });
  __syncthreads();

  const long long base = (long long)g_lo * 4 * Bp;
  float* out = a.hist + base;
  hist_fixed_finish(slo, shi, gn * 4 * Bp, Bp, sp.nrb, a.acc + base,
                    a.done + set, ldexp(1.0, -kg), ldexp(1.0, -kh), NoPre(),
                    [&](int i, long long, long long, float v) {
                      out[i] = a.scale ? __fmul_rn(v, a.scale[(i / Bp) & 1])
                                       : v;
                    });
}

// The step's histogram, then (move) its partition.  Every grid comes
// from `bound`, the most rows a step may hold; the step block names the
// leaf.  A step of no rows writes a zero histogram and a left count of 0.
extern "C" int split_mega_launch(
    uint8_t* bins, int R, long long Np, uint32_t* ghi, int* step, int bound,
    int* nl_out, unsigned long long* status, unsigned* ticket,
    unsigned* epoch, int T, uint8_t* sbins, uint32_t* sghi, long long scap,
    const float* absmax, unsigned long long* acc, unsigned* done,
    float* hist, const float* scale, int G, int Bp, int move,
    void* stream) {
  static int smem_set = 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (Bp < 16 || Bp > MEGA_MAX_BP || Bp % 16 || G < 1 || G > R ||
      bound < 0 || bound >= (1 << 24) || Np % 16 || step == nullptr ||
      ((uintptr_t)bins | (uintptr_t)ghi) % 16)
    return (int)cudaErrorInvalidValue;
  const PartArgs<uint8_t> p{bins,   ghi,    Np,     R,      step,
                            bound,  T,      status, ticket, epoch,
                            nl_out, sbins,  sghi,   scap,   CAT_WORDS};
  if (move && !part_args_ok(p)) return (int)cudaErrorInvalidValue;
  HistGrid g;
  cudaError_t e = hist_grid(G, 4, Bp, ((long long)bound + 30) >> 4, &g);
  if (e != cudaSuccess) return (int)e;
  e = smem_limit((const void*)mega_hist, &smem_set, g.smem);
  if (e != cudaSuccess) return (int)e;
  const HistArgs h{bins, Np,    R,      (const float*)ghi, step, bound, G,
                   g.GB, Bp,    g.nsm,  absmax, acc,  done,  hist,
                   scale, nl_out, move};
  mega_hist<<<g.nblocks, HIST_THREADS, g.smem, s>>>(h);
  e = cudaGetLastError();
  if (e != cudaSuccess || !move) return (int)e;
  return (int)partition_phases(p, s);
}
