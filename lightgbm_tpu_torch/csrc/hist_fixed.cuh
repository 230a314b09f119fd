// Order-independent 64-bit fixed-point histograms on Hopper: the core
// shared by the split mega-kernel's histogram (csrc/split_mega.cu) and
// the leaf histogram (csrc/leaf_hist.cu).
//
// Each grad and hess becomes a 64-bit integer, round(v * 2^k) with one k
// per plane, the largest with rows * max|v| * 2^k < 2^62 (max|v| from a
// (2,) device tensor; no host sync), so no sum can overflow.  Integer
// addition is associative: the sums are the same whatever the order of
// lanes and blocks, so the adds are shared-memory atomics (each 64-bit
// add as two native 32-bit adds with a carry) -- no lane matching, no
// per-warp copies, no ordered reduction -- and the result is
// bit-identical run to run and to the plain emulations
// (ops/split_mega.py hist_fixed_plain, ops/histogram.py
// leaf_hist_fixed_plain).
//
// Layout: a block holds the histograms of as many groups as its shared
// memory takes, NP planes of Bp bins a group (even planes grad, odd
// planes hess), low and high words in two arrays so that consecutive
// bins sit in consecutive banks.  Each lane takes 16 consecutive rows,
// reads their grad and hess once for all the block's groups, and each
// group's bins as one 16-byte load.  Small leaves spread over more blocks
// with fewer groups each (hist_grid).  Blocks of one group set combine
// with 64-bit global atomics; the last block of the set (a done counter)
// converts once, (int64 -> double) * 2^-k -> f32, and leaves the
// accumulator and counter at zero for the next launch.  A block alone in
// its set converts straight from shared memory.
//
// The callers need Np a multiple of 16 and 16-byte aligned bins and
// payload (rows are read as aligned 16-row units).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define HIST_THREADS 512
#define MAX_BP 256
#define FIXED_BITS 62

// Add a 64-bit integer to a shared-memory accumulator held as a low and
// a high 32-bit word.  A 64-bit shared atomic add compiles to a
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

// Add the rows [s0, s0 + c) of the groups [g_lo, g_lo + gn) into the
// block's (gn, NP, Bp) words; sg, sh are 2^k of the two planes.
// side(r0) gives the 16-bit mask of the rows r0 .. r0 + 15 that go to
// planes 2 and 3 (NP == 4: the right child); it is called once a unit.
template <int NP, class Side>
__device__ __forceinline__ void hist_fixed_rows(
    const uint8_t* __restrict__ bins, long long Np,
    const float* __restrict__ ghi, long long s0, int c, int g_lo, int gn,
    int Bp, double sg, double sh, unsigned* slo, unsigned* shi, Side side) {
  const long long end = s0 + c;
  const long long a0 = s0 & ~15LL;
  const long long nu = (end - a0 + 15) >> 4;
  const float* grow = ghi;
  const float* hrow = ghi + Np;
  for (long long u = (long long)blockIdx.x * HIST_THREADS + threadIdx.x;
       u < nu; u += (long long)gridDim.x * HIST_THREADS) {
    const long long r0 = a0 + (u << 4);
    const unsigned right = side(r0);
    long long gi[16], hi[16];
    unsigned live = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 g4 = *(const float4*)(grow + r0 + 4 * k);
      const float4 h4 = *(const float4*)(hrow + r0 + 4 * k);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int t = 4 * k + b;
        const bool v = r0 + t >= s0 && r0 + t < end;
        live |= (unsigned)v << t;
        gi[t] = v ? __double2ll_rn((double)gv[b] * sg) : 0ll;
        hi[t] = v ? __double2ll_rn((double)hv[b] * sh) : 0ll;
      }
    }
    for (int gl = 0; gl < gn; ++gl) {
      const uint4 bv =
          *(const uint4*)(bins + (long long)(g_lo + gl) * Np + r0);
      const unsigned bw[4] = {bv.x, bv.y, bv.z, bv.w};
      const int hb = gl * NP * Bp;
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
}

// After the block's adds (and a __syncthreads): combine the block's nent
// words with the other blocks of its group set and convert once.  acc is
// the set's int64 accumulator and done its counter, both zero before and
// left zero after; ig, ih are 2^-k of the two planes; store(i, v) writes
// the f32 value of the block's entry i.
template <class Store>
__device__ __forceinline__ void hist_fixed_finish(
    const unsigned* slo, const unsigned* shi, int nent, int Bp,
    unsigned long long* acc, unsigned* done, double ig, double ih,
    Store store) {
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  if (gridDim.x == 1) {
    for (int i = tid; i < nent; i += HIST_THREADS) {
      const long long v = (long long)(((unsigned long long)shi[i] << 32) |
                                      slo[i]);
      store(i, (float)((double)v * (((i / Bp) & 1) ? ih : ig)));
    }
    return;
  }
  for (int i = tid; i < nent; i += HIST_THREADS) {
    const unsigned long long v = ((unsigned long long)shi[i] << 32) | slo[i];
    if (v) atomicAdd(acc + i, v);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < nent; i += HIST_THREADS) {
    const long long v = (long long)__ldcg(acc + i);
    acc[i] = 0ull;
    store(i, (float)((double)v * (((i / Bp) & 1) ? ih : ig)));
  }
  if (tid == 0) *done = 0u;
}

// Grid of a fixed-point histogram launch over nu 16-row units of G
// groups with NP planes of Bp bins: enough group sets to fill the SMs
// when the leaf is small, as few as shared memory allows when it is
// large.  gridDim.y runs over the ngb group sets of GB groups each.
struct HistGrid {
  int GB, ngb, nrb, smem;
};

static cudaError_t hist_grid(int G, int NP, int Bp, long long nu,
                             HistGrid* out) {
  static int nsm = 0, smem_block = 0, smem_sm = 0;
  if (!nsm) {
    int dev;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_block,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&smem_sm,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  const int per_group = NP * Bp * 8;
  const int gbmax = std::min(G, (smem_block - 1024) / per_group);
  if (gbmax < 1) return cudaErrorInvalidValue;
  const int need = (int)((nu + HIST_THREADS - 1) / HIST_THREADS);
  int ngb = std::max((G + gbmax - 1) / gbmax,
                     std::min(G, (nsm + need - 1) / need));
  const int GB = (G + ngb - 1) / ngb;
  ngb = (G + GB - 1) / GB;
  const int smem = GB * per_group;
  const int per_sm =
      std::max(1, std::min(2048 / HIST_THREADS, smem_sm / (smem + 1024)));
  out->GB = GB;
  out->ngb = ngb;
  out->nrb = std::max(1, std::min(need, nsm * per_sm / ngb));
  out->smem = smem;
  return cudaSuccess;
}
