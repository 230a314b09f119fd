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
// the histogram's shared-memory adds, two per (row, group).  The design:
//   mega_hist  order-independent integer histograms.  Each grad and hess
//              becomes a 64-bit fixed-point integer, round(v * 2^k) with
//              one k per plane, the largest with cnt * max|v| * 2^k <
//              2^62 (max|v| from a (2,) device tensor; no host sync), so
//              no sum can overflow.  Integer addition is associative: the
//              sums are the same whatever the order of lanes and blocks,
//              so the adds are shared-memory atomics (each 64-bit add as
//              two native 32-bit adds with a carry) -- no lane matching,
//              no per-warp copies, no ordered reduction -- and the
//              result is bit-identical run to run and to
//              hist_fixed_plain.  A block holds the histograms of as
//              many groups as its shared memory takes (8 KB a group at
//              Bp = 256: all 28 of HIGGS in one block); each lane takes
//              16 consecutive rows, reads their grad, hess and decision
//              byte once for all the block's groups, and each group's
//              bins as one 16-byte load.  Small leaves spread over more
//              blocks with fewer groups each.  Blocks of one group set
//              combine with 64-bit global atomics; the last block of the
//              set (a done counter) converts once, (int64 -> double) *
//              2^-k -> f32, and leaves the accumulator and counter at
//              zero for the next launch.  A block alone in its set
//              converts straight from shared memory.
//   then the two partition launches of csrc/partition.cuh, shared with
//   csrc/partition.cu.  Three launches per split (one for move == 0).
// The histogram is not fused into the partition's tile pass: the staged
// tile and 8 KB per group do not fit one SM's shared memory together.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "partition.cuh"

#define HIST_THREADS 512
#define MAX_BP 256
#define FIXED_BITS 62

// Add a 64-bit integer to a shared-memory accumulator held as a low and
// a high 32-bit word, in two arrays so that consecutive bins sit in
// consecutive banks.  A 64-bit shared atomic add compiles to a
// compare-and-swap loop on this card; two native 32-bit adds do not: the
// low add returns the old low word, and its carry joins the high part.
// Every add that wraps the low word carries exactly once, so the pair
// ends holding the sum modulo 2^64 whatever the order of the adds.
__device__ __forceinline__ void shared_add_i64(unsigned* lo_word,
                                               unsigned* hi_word,
                                               long long v) {
  const unsigned lo = (unsigned)v;
  const unsigned hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(lo_word, lo);
  const unsigned c = old + lo < old ? 1u : 0u;
  if (hi + c) atomicAdd(hi_word, hi + c);
}

// The exponent k of a plane's fixed-point scale 2^k: the largest with
// cnt * amax * 2^k < 2^62 (the product is exact in double), clamped to
// the range a finite f32 needs.  ops/split_mega.py fixed_exponent is the
// same function.
__device__ __forceinline__ int fixed_exponent(float amax, int cnt) {
  int e;
  frexp((double)amax * (double)cnt, &e);
  return min(max(FIXED_BITS - e, -100), 220);
}

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
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int Bp = a.Bp;
  const int g_lo = blockIdx.y * a.GB;
  const int gn = min(a.GB, a.G - g_lo);
  const int nent = gn * 4 * Bp;
  unsigned* slo = shist;                  // low words, (gn, 4, Bp)
  unsigned* shi = shist + a.GB * 4 * Bp;  // high words
  for (int i = tid; i < 2 * a.GB * 4 * Bp; i += HIST_THREADS) shist[i] = 0u;
  if (a.set_nl >= 0 && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    a.nl_out[0] = a.set_nl;
  const int kg = fixed_exponent(a.absmax[0], a.cnt);
  const int kh = fixed_exponent(a.absmax[1], a.cnt);
  const double sg = ldexp(1.0, kg), sh = ldexp(1.0, kh);
  __syncthreads();

  const long long end = a.start + a.cnt;
  const long long a0 = a.start & ~15LL;
  const long long nu = (end - a0 + 15) >> 4;
  const uint8_t* crow = a.bins + (long long)a.d.col * a.Np;
  const float* grow = a.ghi;
  const float* hrow = a.ghi + a.Np;
  for (long long u = (long long)blockIdx.x * HIST_THREADS + tid; u < nu;
       u += (long long)gridDim.x * HIST_THREADS) {
    const long long r0 = a0 + (u << 4);
    const uint4 cv = *(const uint4*)(crow + r0);
    const unsigned cw[4] = {cv.x, cv.y, cv.z, cv.w};
    long long gi[16], hi[16];
    unsigned live = 0u, right = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 g4 = *(const float4*)(grow + r0 + 4 * k);
      const float4 h4 = *(const float4*)(hrow + r0 + 4 * k);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int t = 4 * k + b;
        const bool v = r0 + t >= a.start && r0 + t < end;
        live |= (unsigned)v << t;
        right |= (unsigned)!decide_left((cw[k] >> (8 * b)) & 0xff, a.d) << t;
        gi[t] = v ? __double2ll_rn((double)gv[b] * sg) : 0ll;
        hi[t] = v ? __double2ll_rn((double)hv[b] * sh) : 0ll;
      }
    }
    for (int gl = 0; gl < gn; ++gl) {
      const uint4 bv =
          *(const uint4*)(a.bins + (long long)(g_lo + gl) * a.Np + r0);
      const unsigned bw[4] = {bv.x, bv.y, bv.z, bv.w};
      const int hb = gl * 4 * Bp;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int bin = (bw[t >> 2] >> ((t & 3) * 8)) & 0xff;
        if (((live >> t) & 1u) && bin < Bp) {
          const int e = hb + ((right >> t) & 1u) * 2 * Bp + bin;
          shared_add_i64(slo + e, shi + e, gi[t]);
          shared_add_i64(slo + e + Bp, shi + e + Bp, hi[t]);
        }
      }
    }
  }
  __syncthreads();

  const long long base = (long long)g_lo * 4 * Bp;
  const double ig = ldexp(1.0, -kg), ih = ldexp(1.0, -kh);
  if (gridDim.x == 1) {
    for (int i = tid; i < nent; i += HIST_THREADS) {
      const long long v = (long long)(((unsigned long long)shi[i] << 32) |
                                      slo[i]);
      a.hist[base + i] = (float)((double)v * (((i / Bp) & 1) ? ih : ig));
    }
    return;
  }
  for (int i = tid; i < nent; i += HIST_THREADS) {
    const unsigned long long v = ((unsigned long long)shi[i] << 32) | slo[i];
    if (v) atomicAdd(a.acc + base + i, v);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(a.done + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < nent; i += HIST_THREADS) {
    const long long v = (long long)__ldcg(a.acc + base + i);
    a.acc[base + i] = 0ull;
    a.hist[base + i] = (float)((double)v * (((i / Bp) & 1) ? ih : ig));
  }
  if (tid == 0) a.done[blockIdx.y] = 0u;
}

static int g_nsm = 0, g_smem_block = 0, g_smem_sm = 0;

// Enqueue mega_hist (cnt > 0) with its grid: enough group sets to fill
// the SMs when the leaf is small, as few as shared memory allows when it
// is large.
static cudaError_t launch_hist(HistArgs a, cudaStream_t s) {
  if (!g_nsm) {
    int dev;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_nsm, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&g_smem_block,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&g_smem_sm,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  const int per_group = 4 * a.Bp * 8;
  const int gbmax = std::min(a.G, (g_smem_block - 1024) / per_group);
  if (gbmax < 1) return cudaErrorInvalidValue;
  const long long nu = (a.start + a.cnt - (a.start & ~15LL) + 15) >> 4;
  const int need = (int)((nu + HIST_THREADS - 1) / HIST_THREADS);
  int ngb = std::max((a.G + gbmax - 1) / gbmax,
                     std::min(a.G, (g_nsm + need - 1) / need));
  a.GB = (a.G + ngb - 1) / ngb;
  ngb = (a.G + a.GB - 1) / a.GB;
  const int smem = a.GB * per_group;
  const int per_sm =
      std::max(1, std::min(2048 / HIST_THREADS, g_smem_sm / (smem + 1024)));
  const int nrb = std::max(1, std::min(need, g_nsm * per_sm / ngb));
  cudaError_t e = cudaFuncSetAttribute(
      mega_hist, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  mega_hist<<<dim3(nrb, ngb), HIST_THREADS, smem, s>>>(a);
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
