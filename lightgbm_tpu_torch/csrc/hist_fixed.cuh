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
// memory takes, NP planes of Bp bins a group (even planes grad, odd planes
// hess), low and high words in two arrays so that consecutive bins sit in
// consecutive banks.  Each lane takes 16 consecutive rows, reads their grad
// and hess once for all the block's groups, and each group's bins as one
// 16-byte load (uint8 bins) or two (uint16: the bin type is a template
// parameter).  The wide arm (GLOBAL): when one group's planes do not fit a
// block's shared memory (past ~14,500 bins at NP = 2), the adds go straight
// to the group set's int64 accumulator in device memory by 64-bit global
// atomics, exact in any order as well, and the last block converts from
// there.  Small leaves spread over more blocks with fewer groups each
// (hist_grid).  Blocks of one group set combine with 64-bit global atomics;
// the last block of the set (a done counter) converts once, (int64 ->
// double) * 2^-k -> f32, and leaves the accumulator and counter at zero for
// the next launch.  A block alone in its set converts straight from shared
// memory.  The conversion hands the caller each exact int64 sum beside its
// f32 value (leaf_hist's state epilogue keeps the integers), loads for
// several entries in flight at once.
//
// The callers need Np a multiple of 16 and 16-byte aligned bins and
// payload (rows are read as aligned 16-row units).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define HIST_THREADS 512
#define MAX_BP 65536    // uint16 bins
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
// block's (gn, NP, Bp) words; sg, sh are 2^k of the two planes; the
// block is row block rb of the nrb of its group set.
// side(r0) gives the 16-bit mask of the rows r0 .. r0 + 15 that go to
// planes 2 and 3 (NP == 4: the right child); it is called once a unit.
// GLOBAL (the wide arm): the adds go to the group set's (gn, NP, Bp)
// int64 accumulator gacc in device memory instead (slo, shi unused).
template <int NP, bool GLOBAL = false, class BinT, class Side>
__device__ __forceinline__ void hist_fixed_rows(
    const BinT* __restrict__ bins, long long Np,
    const float* __restrict__ ghi, long long s0, int c, int g_lo, int gn,
    int Bp, double sg, double sh, unsigned* slo, unsigned* shi, int rb,
    int nrb, Side side, unsigned long long* gacc = nullptr) {
  constexpr int NV = (int)sizeof(BinT);   // 16-byte loads a unit
  constexpr int BITS = 8 * NV;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  const long long end = s0 + c;
  const long long a0 = s0 & ~15LL;
  const long long nu = (end - a0 + 15) >> 4;
  const float* grow = ghi;
  const float* hrow = ghi + Np;
  for (long long u = (long long)rb * HIST_THREADS + threadIdx.x; u < nu;
       u += (long long)nrb * HIST_THREADS) {
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
      const uint4* bp =
          (const uint4*)(bins + (long long)(g_lo + gl) * Np + r0);
      unsigned bw[4 * NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const uint4 bv = bp[k];
        bw[4 * k] = bv.x;
        bw[4 * k + 1] = bv.y;
        bw[4 * k + 2] = bv.z;
        bw[4 * k + 3] = bv.w;
      }
      const int hb = gl * NP * Bp;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int bin =
            (int)((bw[t / (4 / NV)] >> ((t % (4 / NV)) * BITS)) & MASK);
        if (((live >> t) & 1u) && bin < Bp) {
          const int e = hb + ((right >> t) & 1u) * 2 * Bp + bin;
          if (GLOBAL) {
            atomicAdd(gacc + e, (unsigned long long)gi[t]);
            atomicAdd(gacc + e + Bp, (unsigned long long)hi[t]);
          } else {
            shared_add_i64(slo + e, shi + e, gi[t]);
            shared_add_i64(slo + e + Bp, shi + e + Bp, hi[t]);
          }
        }
      }
    }
  }
}

// Entries a thread converts per round in hist_fixed_finish: their loads
// are all issued before any of their stores, so the round costs one
// memory latency instead of one per entry (the stores may alias the
// loads' buffers as far as the compiler knows, so it cannot reorder them
// itself).
#define FINISH_UNROLL 8

// No load beside each entry (hist_fixed_finish's pre).
struct NoPre {
  __device__ long long operator()(int) const { return 0ll; }
};

// After the block's adds (and a __syncthreads): combine the block's nent
// words with the other nrb - 1 blocks of its group set and convert once.  acc is
// the set's int64 accumulator and done its counter, both zero before and
// left zero after; ig, ih are 2^-k of the two planes.  GLOBAL (the wide
// arm): the adds are in acc already, and the last block converts from
// there even when it is alone.  Per entry i of the
// block, pre(i) loads what the store needs beside the sum (leaf_hist's
// state epilogue: the parent slot's entry), before any store of its
// round; store(i, v, q, f) takes the entry's exact int64 sum v, pre's
// value q and the f32 value f.
template <bool GLOBAL = false, class Pre, class Store>
__device__ __forceinline__ void hist_fixed_finish(
    const unsigned* slo, const unsigned* shi, int nent, int Bp, int nrb,
    unsigned long long* acc, unsigned* done, double ig, double ih, Pre pre,
    Store store) {
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const bool alone = !GLOBAL && nrb == 1;
  if (!alone) {
    if (!GLOBAL) {
      for (int i = tid; i < nent; i += HIST_THREADS) {
        const unsigned long long v =
            ((unsigned long long)shi[i] << 32) | slo[i];
        if (v) atomicAdd(acc + i, v);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(done, 1u) == (unsigned)nrb - 1u;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }
  constexpr int U = FINISH_UNROLL;
  for (int i0 = tid; i0 < nent; i0 += U * HIST_THREADS) {
    long long v[U], q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * HIST_THREADS;
      if (i < nent) {
        v[u] = alone ? (long long)(((unsigned long long)shi[i] << 32) |
                                   slo[i])
                     : (long long)__ldcg(acc + i);
        q[u] = pre(i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * HIST_THREADS;
      if (i < nent) {
        if (!alone) acc[i] = 0ull;
        store(i, v[u], q[u],
              (float)((double)v[u] * (((i / Bp) & 1) ? ih : ig)));
      }
    }
  }
  if (!alone && tid == 0) *done = 0u;
}

// How a fixed-point histogram over nu 16-row units of G groups is cut
// into blocks: enough group sets to fill the SMs when the leaf is small,
// as few as shared memory allows when it is large.  ngb group sets of GB
// groups each, nrb row blocks a set.  The launch's grid and shared memory
// are fixed by a bound on the rows (hist_grid on the host); each launch
// cuts its own rows on the device (hist_split) within that grid, so a
// captured launch serves a leaf of any size up to the bound.
struct HistSplit {
  int GB, ngb, nrb;
};

__host__ __device__ inline long long hf_max(long long a, long long b) {
  return a > b ? a : b;
}
__host__ __device__ inline long long hf_min(long long a, long long b) {
  return a < b ? a : b;
}

__host__ __device__ inline HistSplit hist_split(int G, int gbmax,
                                                long long nu, int nblocks,
                                                int nsm) {
  const long long need = hf_max(1, (nu + HIST_THREADS - 1) / HIST_THREADS);
  int ngb = (int)hf_max((G + gbmax - 1) / gbmax,
                        hf_min(G, (nsm + need - 1) / need));
  const int GB = (G + ngb - 1) / ngb;
  ngb = (G + GB - 1) / GB;
  const int nrb = (int)hf_max(1, hf_min(need, nblocks / ngb));
  return HistSplit{GB, ngb, nrb};
}

// A launch's grid for at most nu_bound units: its blocks (the cut of the
// bound, as many as the SMs hold at its shared memory), the shared memory
// of a block (GB groups of NP planes of Bp bins, as the cut of the bound
// needs) and the SM count the device cut uses.
struct HistGrid {
  int GB, nblocks, smem, nsm;
};

// The card's SM count and shared memory a block (opt-in) and an SM.
static void hist_attrs(int* nsm_out, int* smem_block_out, int* smem_sm_out) {
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
  *nsm_out = nsm;
  *smem_block_out = smem_block;
  *smem_sm_out = smem_sm;
}

// Whether one group's NP planes of Bp bins are past a block's shared
// memory: the histogram then takes the wide arm (GLOBAL).
static inline bool hist_wide(int NP, int Bp) {
  int nsm, smem_block, smem_sm;
  hist_attrs(&nsm, &smem_block, &smem_sm);
  return (long long)NP * Bp * 8 > smem_block - 1024;
}

// wide: the wide arm's grid, no shared histogram and every group in one
// set when the leaf is large (a group set then shares its rows' grad and
// hess loads).
static cudaError_t hist_grid(int G, int NP, int Bp, long long nu_bound,
                             HistGrid* out, bool wide = false) {
  int nsm, smem_block, smem_sm;
  hist_attrs(&nsm, &smem_block, &smem_sm);
  const int per_group = wide ? 0 : NP * Bp * 8;
  const int gbmax =
      wide ? G : std::min(G, (smem_block - 1024) / per_group);
  if (gbmax < 1) return cudaErrorInvalidValue;
  // the cut of the bound with every SM's worth of blocks
  const HistSplit b = hist_split(G, gbmax, nu_bound, 1 << 30, nsm);
  const int smem = b.GB * per_group;
  const int per_sm =
      std::max(1, std::min(2048 / HIST_THREADS, smem_sm / (smem + 1024)));
  out->GB = b.GB;
  out->nblocks = std::max(1, std::min(b.ngb * b.nrb, nsm * per_sm));
  out->smem = smem;
  out->nsm = nsm;
  return cudaSuccess;
}
