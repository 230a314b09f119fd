// The stable leaf partition on the device, shared by csrc/partition.cu
// and csrc/split_mega.cu.
//
// decide_left has the same arithmetic as decide_left in
// lightgbm_tpu_torch/ops/partition.py and _decide_left in
// lightgbm_tpu/ops/partition_pallas.py: bundled bin offset, missing
// none/zero/NaN, default bin, threshold, default_left.
//
// partition_phases enqueues the stable two-way partition of the leaf
// range [start, start + cnt) of the (R, Np) uint8 bin rows and the eight
// (8, Np) 32-bit payload rows (moved as raw words), lefts first, each
// side in its original order, and writes the left count to nl_out on the
// device.  It replaces the partition of the TPU kernels
// partition_leaf_pallas (lightgbm_tpu/ops/partition_pallas.py) and
// split_megakernel_pallas, which carried a write frontier across a grid
// that ran in order.
//
// What bounds it on this card: bytes.  The contract moves each row of
// the leaf once, (R + 32) bytes read and written.  Two launches:
//   part_tiles     one pass over tiles of T rows (T a multiple of 32,
//                  chosen by the wrapper so that three tiles fit an SM).
//                  The tile grid is aligned to absolute rows at a
//                  multiple of 16, rows outside the range are masked, so
//                  every row of a tile is staged in shared memory with
//                  16-byte cp.async copies whatever `start` is.  Tiles
//                  take tickets from an atomic counter, so they are
//                  handled in ticket order and no block waits on a tile
//                  that has not been scheduled.  A ballot scan orders the
//                  staged rows stably, lefts first; the tile's left count
//                  is published (release) as soon as its rows are on
//                  chip, and its exclusive prefix comes from a decoupled
//                  look-back over the earlier tiles' words (acquire).
//                  The lefts are then written IN PLACE: a left row's
//                  destination never passes its source, and every earlier
//                  tile has its rows on chip before it publishes.  The
//                  rights go to a scratch run.  Both sides leave the
//                  block as contiguous runs, coalesced: a warp stores 32
//                  consecutive payload words or 128 consecutive bin bytes
//                  at a time, each thread looking its source rows up
//                  once for all R + 8 rows.  The last ticket writes the
//                  left count and resets the ticket counter.
//   part_copyback  copies the rights from scratch to [start + nl,
//                  start + cnt), 16 rows at a time (stream order keeps it
//                  after part_tiles).
// Bytes moved per row: (2 + 2 r / cnt) (R + 32) for r rights, against
// the contract's 2 (R + 32).  The tile status words carry a launch epoch,
// so they need no reset between launches; with the self-resetting ticket
// a partition is two launches.  A tile's block stages, orders and writes
// one tile and exits: persistent double-buffered blocks (staging the
// next tile while writing this one) were tried and were slower.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GHI_ROWS 8
#define PART_THREADS 256
#define COPY_THREADS 256
#define MAX_TILE 1024

struct SplitDecision {
  int col, bstart, isb, nb, dbin, mtype, thr, dl;
};

__device__ __forceinline__ int decide_left(int colv, const SplitDecision& d) {
  const int fb_raw = colv - d.bstart;
  const bool in_rb = fb_raw >= 1 && fb_raw <= d.nb - 1;
  const int fb = d.isb == 1 ? (in_rb ? fb_raw : d.dbin) : colv;
  const bool miss = d.mtype == 1 ? fb == d.dbin
                                 : (d.mtype == 2 ? fb == d.nb - 1 : false);
  return miss ? (d.dl != 0) : (fb <= d.thr);
}

// A tile's status word: [epoch:32][state:2][left count:30].  A word of
// another epoch reads as "not yet published".
#define TILE_AGG 1u   // the tile's own left count
#define TILE_INC 2u   // the left count of this tile and all before it

__device__ __forceinline__ unsigned long long tile_word(unsigned epoch,
                                                        unsigned state,
                                                        unsigned v) {
  return ((unsigned long long)epoch << 32) |
         ((unsigned long long)state << 30) | v;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

struct PartArgs {
  uint8_t* bins;       // (R, Np), Np a multiple of 16
  uint32_t* ghi;       // (8, Np) payload words
  long long Np;
  int R;
  long long start;
  int cnt;             // > 0
  SplitDecision d;
  int T;               // rows per tile
  int ntiles;          // tiles covering [start & ~15, start + cnt)
  unsigned long long* status;   // >= ntiles words
  unsigned* ticket;    // 0 before the launch; 0 again after it
  unsigned epoch;      // != 0, differs from the previous launch's
  int* nl_out;
  uint8_t* sbins;      // (R, scap) scratch of the rights
  uint32_t* sghi;      // (8, scap)
  long long scap;      // >= cnt + 16, a multiple of 16
};

// Dynamic shared memory of part_tiles: the staged payload and bin rows,
// then the two index runs (lefts, rights) of T u16 each.
__host__ __device__ inline int part_smem_bytes(int R, int T) {
  return 32 * T + ((R * T + 15) & ~15) + 4 * T;
}

// Write the tile's nl staged lefts, in the order ordl[0 .. nl), to the
// positions [gl, gl + nl) of the bin rows bins + r * Np and payload rows
// ghi + q * Np, and its nr rights, in the order ordr[0 .. nr), to
// [gr, gr + nr) of the scratch rows (stride scap).  A thread takes one
// position (payload) or one aligned 4-byte word of positions (bins),
// looks up its source rows once and moves them for every row, so
// consecutive threads gather from different banks and every warp store
// is one contiguous run: 32 payload words or 128 bin bytes.  A run's
// partial end words are stored as bytes: their other bytes belong to a
// neighbouring tile's run.
__device__ void write_runs(const PartArgs& a, const uint8_t* sb,
                           const uint32_t* sg, const uint16_t* ordl,
                           const uint16_t* ordr, int nl, int nr,
                           long long gl, long long gr) {
  const int T = a.T;
  for (int j = threadIdx.x; j < nl + nr; j += blockDim.x) {
    const bool left = j < nl;
    const int src = left ? ordl[j] : ordr[j - nl];
    uint32_t* dst = left ? a.ghi + gl + j : a.sghi + gr + (j - nl);
    const long long stride = left ? a.Np : a.scap;
#pragma unroll
    for (int q = 0; q < GHI_ROWS; ++q) dst[q * stride] = sg[q * T + src];
  }
  const int phl = (int)(gl & 3), phr = (int)(gr & 3);
  const int nwl = nl ? (phl + nl + 3) >> 2 : 0;
  const int nwr = nr ? (phr + nr + 3) >> 2 : 0;
  for (int w = threadIdx.x; w < nwl + nwr; w += blockDim.x) {
    const bool left = w < nwl;
    const int n = left ? nl : nr;
    const int j0 = 4 * (left ? w : w - nwl) - (left ? phl : phr);
    const uint16_t* ord = left ? ordl : ordr;
    uint8_t* dst = left ? a.bins + (gl - phl) + 4 * w
                        : a.sbins + (gr - phr) + 4 * (w - nwl);
    const long long stride = left ? a.Np : a.scap;
    int src[4];
    unsigned live = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool in = j0 + b >= 0 && j0 + b < n;
      src[b] = in ? ord[j0 + b] : 0;
      live |= (unsigned)in << b;
    }
    if (live == 15u) {
      for (int r = 0; r < a.R; ++r) {
        const uint8_t* s = sb + r * T;
        *(uint32_t*)(dst + r * stride) =
            (uint32_t)s[src[0]] | ((uint32_t)s[src[1]] << 8) |
            ((uint32_t)s[src[2]] << 16) | ((uint32_t)s[src[3]] << 24);
      }
    } else {
      for (int r = 0; r < a.R; ++r)
        for (int b = 0; b < 4; ++b)
          if ((live >> b) & 1u) dst[r * stride + b] = sb[r * T + src[b]];
    }
  }
}

__global__ void __launch_bounds__(PART_THREADS) part_tiles(PartArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned lmask[MAX_TILE / 32], vmask[MAX_TILE / 32];
  __shared__ int loff[MAX_TILE / 32], roff[MAX_TILE / 32];
  __shared__ int s_tile, s_nl, s_nr;
  __shared__ long long s_excl;
  const int T = a.T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* sg = (uint32_t*)smem;
  uint8_t* sb = smem + 32 * T;
  uint16_t* ordl = (uint16_t*)(sb + ((a.R * T + 15) & ~15));
  uint16_t* ordr = ordl + T;

  if (tid == 0) s_tile = (int)atomicAdd(a.ticket, 1u);
  __syncthreads();
  const int k = s_tile;
  const long long end = a.start + a.cnt;
  const long long t0 = (a.start & ~15LL) + (long long)k * T;
  // staged rows [t0, t0 + n16); the leaf's rows are [v0, v1) of the tile
  const int n16 = (int)min((long long)T, ((end + 15) & ~15LL) - t0);
  const int v0 = (int)max(0LL, a.start - t0);
  const int v1 = (int)min((long long)T, end - t0);

  const int cb = n16 >> 4, cg = n16 >> 2;
  for (int c = tid; c < a.R * cb; c += blockDim.x) {
    const int r = c / cb, o = (c - r * cb) << 4;
    cp_async16(sb + r * T + o, a.bins + r * a.Np + t0 + o);
  }
  for (int c = tid; c < GHI_ROWS * cg; c += blockDim.x) {
    const int q = c / cg, o = (c - q * cg) << 2;
    cp_async16(sg + q * T + o, a.ghi + q * a.Np + t0 + o);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
  __syncthreads();

  for (int i0 = 0; i0 < T; i0 += blockDim.x) {
    const int i = i0 + tid;
    const bool v = i >= v0 && i < v1;
    const bool l = v && decide_left(sb[a.d.col * T + i], a.d);
    const unsigned bl = __ballot_sync(0xffffffffu, l);
    const unsigned bv = __ballot_sync(0xffffffffu, v);
    if (lane == 0 && i < T) {
      lmask[i >> 5] = bl;
      vmask[i >> 5] = bv;
    }
  }
  __syncthreads();

  if (warp == 0) {
    const int nw = T >> 5;
    const unsigned lm = lane < nw ? lmask[lane] : 0u;
    const unsigned vm = lane < nw ? vmask[lane] : 0u;
    const int cl = __popc(lm), cr = __popc(vm & ~lm);
    int il = cl, ir = cr;
    for (int o = 1; o < 32; o <<= 1) {
      const int tl = __shfl_up_sync(0xffffffffu, il, o);
      const int tr = __shfl_up_sync(0xffffffffu, ir, o);
      if (lane >= o) {
        il += tl;
        ir += tr;
      }
    }
    if (lane < nw) {
      loff[lane] = il - cl;
      roff[lane] = ir - cr;
    }
    const int nl = __shfl_sync(0xffffffffu, il, 31);
    // the rows are on chip: publish this tile's own count
    if (lane == 0)
      st_release(a.status + k, tile_word(a.epoch, k == 0 ? TILE_INC : TILE_AGG,
                                         (unsigned)nl));
    long long excl = 0;
    if (k > 0) {
      // decoupled look-back, 32 earlier tiles per round: sum down to the
      // nearest inclusive word, waiting while any word on the way is of
      // another epoch
      int top = k - 1;
      unsigned spins = 0;
      while (true) {
        const int j = top - lane;
        const unsigned long long f =
            j >= 0 ? ld_acquire(a.status + j)
                   : tile_word(a.epoch, TILE_INC, 0);
        const unsigned st =
            (unsigned)(f >> 32) == a.epoch ? (unsigned)(f >> 30) & 3u : 0u;
        const unsigned pm = __ballot_sync(0xffffffffu, st == TILE_INC);
        const unsigned xm = __ballot_sync(0xffffffffu, st == 0u);
        const int fp = pm ? __ffs(pm) - 1 : 31;
        const unsigned need = fp == 31 ? 0xffffffffu : ((2u << fp) - 1u);
        if (xm & need) {
          // an earlier tile holds a ticket, so it runs and publishes; a
          // wait of seconds means a broken launch: fail, do not hang
          if (++spins > (1u << 26)) __trap();
          __nanosleep(32);
          continue;
        }
        const unsigned add = lane <= fp ? (unsigned)(f & 0x3fffffffu) : 0u;
        excl += __reduce_add_sync(0xffffffffu, add);
        if (pm) break;
        top -= 32;
      }
      __syncwarp();
      if (lane == 0)
        st_release(a.status + k,
                   tile_word(a.epoch, TILE_INC, (unsigned)(excl + nl)));
    }
    const int nr = __shfl_sync(0xffffffffu, ir, 31);
    if (lane == 0) {
      s_excl = excl;
      s_nl = nl;
      s_nr = nr;
      if (k == a.ntiles - 1) {
        a.nl_out[0] = (int)(excl + nl);
        *a.ticket = 0u;
      }
    }
  }
  __syncthreads();

  const long long excl = s_excl;
  const long long gl = a.start + excl;                    // first left
  const long long gr = max(0LL, t0 - a.start) - excl;     // first right
  for (int i = tid; i < T; i += blockDim.x) {
    const int w = i >> 5;
    const unsigned bit = 1u << (i & 31), lt = bit - 1u;
    const unsigned lm = lmask[w], vm = vmask[w];
    if (vm & bit) {
      if (lm & bit)
        ordl[loff[w] + __popc(lm & lt)] = (uint16_t)i;
      else
        ordr[roff[w] + __popc(vm & ~lm & lt)] = (uint16_t)i;
    }
  }
  __syncthreads();
  write_runs(a, sb, sg, ordl, ordr, s_nl, s_nr, gl, gr);
}

// Copy the r = cnt - nl rights from scratch to [start + nl, start + cnt):
// one thread per (row, aligned 16-row chunk of the destination).  A
// whole chunk of a bin row is five aligned 4-byte loads funnel-shifted
// into one 16-byte store; of a payload row, four 16-byte stores.
__global__ void __launch_bounds__(COPY_THREADS) part_copyback(
    uint8_t* __restrict__ bins, uint32_t* __restrict__ ghi, long long Np,
    int R, long long start, int cnt, const int* __restrict__ nl_ptr,
    const uint8_t* __restrict__ sbins, const uint32_t* __restrict__ sghi,
    long long scap) {
  const int nl = *nl_ptr;
  const int n = cnt - nl;
  if (n <= 0) return;
  const long long g0 = start + nl;
  const long long c0 = g0 >> 4;
  const long long nch = ((g0 + n - 1) >> 4) - c0 + 1;
  const int row = blockIdx.y;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < nch; c += (long long)gridDim.x * blockDim.x) {
    const long long p0 = (c0 + c) << 4;
    const long long j0 = p0 - g0;
    const bool full = j0 >= 0 && j0 + 16 <= n;
    if (row < R) {
      const uint8_t* s = sbins + row * scap;
      uint8_t* dst = bins + row * Np + p0;
      if (full) {
        const uint32_t* sw = (const uint32_t*)s + (j0 >> 2);
        const int sh = (int)(j0 & 3) * 8;
        const uint32_t w0 = sw[0], w1 = sw[1], w2 = sw[2], w3 = sw[3];
        const uint32_t w4 = sh ? sw[4] : 0u;
        *(uint4*)dst = make_uint4(
            __funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
            __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
      } else {
        for (int b = 0; b < 16; ++b)
          if (j0 + b >= 0 && j0 + b < n) dst[b] = s[j0 + b];
      }
    } else {
      const uint32_t* s = sghi + (row - R) * scap;
      uint32_t* dst = ghi + (row - R) * Np + p0;
      if (full) {
        const uint32_t* sw = s + j0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          *(uint4*)(dst + 4 * k) = make_uint4(sw[4 * k], sw[4 * k + 1],
                                              sw[4 * k + 2], sw[4 * k + 3]);
      } else {
        for (int b = 0; b < 16; ++b)
          if (j0 + b >= 0 && j0 + b < n) dst[b] = s[j0 + b];
      }
    }
  }
}

__global__ void part_set_count(int* nl_out, int v) { nl_out[0] = v; }

// Check the arguments of a partition launch (cnt > 0).
static inline bool part_args_ok(const PartArgs& a) {
  const long long a0 = a.start & ~15LL;
  return a.R >= 1 && a.d.col >= 0 && a.d.col < a.R && a.cnt > 0 &&
         a.start >= 0 && a.start + a.cnt <= a.Np && a.Np % 16 == 0 &&
         a.T >= 32 && a.T <= MAX_TILE && a.T % 32 == 0 && a.epoch != 0 &&
         (long long)a.ntiles * a.T >= a.start + a.cnt - a0 &&
         (long long)(a.ntiles - 1) * a.T < a.start + a.cnt - a0 &&
         a.scap >= (long long)a.cnt + 16 && a.scap % 16 == 0 &&
         ((uintptr_t)a.bins | (uintptr_t)a.ghi | (uintptr_t)a.sbins |
          (uintptr_t)a.sghi) % 16 == 0;
}

// Enqueue the partition of a (cnt > 0) on stream s: part_tiles, then
// part_copyback.
static inline cudaError_t partition_phases(const PartArgs& a,
                                           cudaStream_t s) {
  const int smem = part_smem_bytes(a.R, a.T);
  cudaError_t e = cudaFuncSetAttribute(
      part_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  part_tiles<<<a.ntiles, PART_THREADS, smem, s>>>(a);
  const long long nch = a.cnt / 16 + 2;
  const long long need = (nch + COPY_THREADS - 1) / COPY_THREADS;
  const int bx = (int)(need < 1024 ? need : 1024);
  part_copyback<<<dim3(bx, a.R + GHI_ROWS), COPY_THREADS, 0, s>>>(
      a.bins, a.ghi, a.Np, a.R, a.start, a.cnt, a.nl_out, a.sbins, a.sghi,
      a.scap);
  return cudaGetLastError();
}
