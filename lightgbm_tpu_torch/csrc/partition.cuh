// The stable leaf partition on the device, shared by csrc/partition.cu
// and csrc/split_mega.cu.
//
// decide_left has the same arithmetic as decide_left in
// lightgbm_tpu_torch/ops/partition.py and _decide_left in
// lightgbm_tpu/ops/partition_pallas.py: bundled bin offset, missing
// none/zero/NaN, default bin, threshold, default_left; a categorical
// split (iscat) sends a row left when its decoded bin is in the set, as
// _goes_left in lightgbm_tpu/models/learner.py does.  The split
// mega-kernel never gets a categorical step (the learner takes the
// histogram-subtraction body on categorical data): its histogram decides
// by decide_left_num and flags a categorical step as an error.
//
// partition_phases enqueues the stable two-way partition of the leaf
// range [start, start + cnt) of the (R, Np) bin rows -- uint8, or uint16
// once a group has more than 256 bins (BinT: every phase below is a
// template on the bin type; a bin row of a tile is T * sizeof(BinT)
// bytes, staged and written as whole 16-byte copies and 4-byte words
// either way) -- and the eight
// (8, Np) 32-bit payload rows (moved as raw words), lefts first, each
// side in its original order, and writes the left count to nl_out on the
// device.  It replaces the partition of the TPU kernels
// partition_leaf_pallas (lightgbm_tpu/ops/partition_pallas.py) and
// split_megakernel_pallas, which carried a write frontier across a grid
// that ran in order.
//
// What bounds it on this card: bytes.  The contract moves each row of the
// leaf once, (R * sizeof(BinT) + 32) bytes read and written.  Two launches:
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
//                  once for all R + 8 rows.  The last tile writes the
//                  left count.
//   part_copyback  copies the rights from scratch to [start + nl,
//                  start + cnt), 16 rows at a time (stream order keeps it
//                  after part_tiles), and moves the epoch on.
// Bytes moved per row: (2 + 2 r / cnt) (R + 32) for r rights, against
// the contract's 2 (R + 32).  The tile status words carry a launch epoch,
// a device word that each copy-back moves on, so they need no reset
// between launches and a captured CUDA graph replays correctly; with the
// self-resetting ticket a partition is two launches.
//
// The leaf and the decision come from a step block on the device
// (csrc/step.cuh), and both grids from `bound`, the most rows a step may
// hold: the tile pass launches at most the blocks the card holds at once
// and each block draws tile tickets until the leaf's tiles run out (a
// block stages, orders and writes one tile at a time: persistent
// double-buffered blocks, staging the next tile while writing this one,
// were tried and were slower); the copy-back's threads stride over the
// rights.  A step of no rows costs a ticket a block and moves nothing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "step.cuh"

#define GHI_ROWS 8
#define PART_THREADS 256
#define COPY_THREADS 256
#define MAX_TILE 1024

// cat points at the step block's set words in device memory, read only
// on a categorical step: an array here would be indexed at run time and
// put the whole decision in local memory on every path.
struct SplitDecision {
  int col, bstart, isb, nb, dbin, mtype, thr, dl, iscat;
  const int* cat;
};

// The numerical decision alone (the split mega-kernel's histogram: it
// never gets a categorical step, and flags one as an error).
__device__ __forceinline__ int decide_left_num(int colv,
                                               const SplitDecision& d) {
  const int fb_raw = colv - d.bstart;
  const bool in_rb = fb_raw >= 1 && fb_raw <= d.nb - 1;
  const int fb = d.isb == 1 ? (in_rb ? fb_raw : d.dbin) : colv;
  const bool miss = d.mtype == 1 ? fb == d.dbin
                                 : (d.mtype == 2 ? fb == d.nb - 1 : false);
  return miss ? (d.dl != 0) : (fb <= d.thr);
}

// ncat: the set's word count (the step block's length less SB_CAT), a
// launch argument, so the decision keeps no register for it.
__device__ __forceinline__ int decide_left(int colv, const SplitDecision& d,
                                           int ncat) {
  if (d.iscat) {
    const int fb_raw = colv - d.bstart;
    const bool in_rb = fb_raw >= 1 && fb_raw <= d.nb - 1;
    const int fb = d.isb == 1 ? (in_rb ? fb_raw : d.dbin) : colv;
    return fb >= 0 && fb < 32 * ncat &&
           (((unsigned)__ldg(d.cat + (fb >> 5)) >> (fb & 31)) & 1u);
  }
  return decide_left_num(colv, d);
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

// A leaf as the device reads it from a step block: the range and the
// decision, cnt == 0 when the block says write nothing or lies outside
// the bounds the launch was sized for (bad != 0).
struct Leaf {
  long long start;
  int cnt;
  SplitDecision d;
  int bad;
};

// Read a step block's leaf and check it against the row buffers (R rows
// of Np) and the launch's bound on the rows of a step.
__device__ __forceinline__ Leaf read_leaf(const int* step, int R,
                                          long long Np, int bound) {
  Leaf l;
  l.start = step[SB_START];
  l.cnt = step[SB_CNT];
  l.d.col = step[SB_COL];
  l.d.bstart = step[SB_BSTART];
  l.d.isb = step[SB_ISB];
  l.d.nb = step[SB_NB];
  l.d.dbin = step[SB_DBIN];
  l.d.mtype = step[SB_MTYPE];
  l.d.thr = step[SB_THR];
  l.d.dl = step[SB_DL];
  l.d.iscat = step[SB_ISCAT];
  l.d.cat = step + SB_CAT;
  l.bad = !(l.cnt >= 0 && l.cnt <= bound && l.start >= 0 &&
            l.start + l.cnt <= Np &&
            (l.cnt == 0 || (l.d.col >= 0 && l.d.col < R)));
  if (l.bad) l.cnt = 0;
  return l;
}

template <class BinT>
struct PartArgs {
  BinT* bins;          // (R, Np), Np a multiple of 16
  uint32_t* ghi;       // (8, Np) payload words
  long long Np;
  int R;
  int* step;           // the step block (range, decision, error word)
  int bound;           // rows a step may hold
  int T;               // rows per tile
  unsigned long long* status;   // >= tiles of `bound` rows words
  unsigned* ticket;    // 0 before the launch; 0 again after it
  unsigned* epoch;     // != 0; part_copyback moves it on
  int* nl_out;
  BinT* sbins;         // (R, scap) scratch of the rights
  uint32_t* sghi;      // (8, scap)
  long long scap;      // >= bound + 16, a multiple of 16
  int ncat;            // words of the step block's set
};

// Dynamic shared memory of part_tiles: the staged payload and bin rows
// (bsize bytes a bin), then the two index runs (lefts, rights) of T u16
// each.
__host__ __device__ inline int part_smem_bytes(int R, int T, int bsize = 1) {
  return 32 * T + ((R * T * bsize + 15) & ~15) + 4 * T;
}

// Write the tile's nl staged lefts, in the order ordl[0 .. nl), to the
// positions [gl, gl + nl) of the bin rows bins + r * Np and payload rows
// ghi + q * Np, and its nr rights, in the order ordr[0 .. nr), to
// [gr, gr + nr) of the scratch rows (stride scap).  A thread takes one
// position (payload) or one aligned 4-byte word of positions (bins),
// looks up its source rows once and moves them for every row, so
// consecutive threads gather from different banks and every warp store
// is one contiguous run: 32 payload words or 128 bin bytes.  A run's
// partial end words are stored bin by bin: their other bins belong to a
// neighbouring tile's run.  A word holds PER = 4 / sizeof(BinT) bins.
template <class BinT>
__device__ void write_runs(const PartArgs<BinT>& a, const BinT* sb,
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
  constexpr int PER = 4 / (int)sizeof(BinT);
  constexpr int LOG_PER = sizeof(BinT) == 1 ? 2 : 1;
  constexpr int BITS = 8 * (int)sizeof(BinT);
  const int phl = (int)(gl & (PER - 1)), phr = (int)(gr & (PER - 1));
  const int nwl = nl ? (phl + nl + PER - 1) >> LOG_PER : 0;
  const int nwr = nr ? (phr + nr + PER - 1) >> LOG_PER : 0;
  for (int w = threadIdx.x; w < nwl + nwr; w += blockDim.x) {
    const bool left = w < nwl;
    const int n = left ? nl : nr;
    const int j0 = PER * (left ? w : w - nwl) - (left ? phl : phr);
    const uint16_t* ord = left ? ordl : ordr;
    BinT* dst = left ? a.bins + (gl - phl) + PER * w
                     : a.sbins + (gr - phr) + PER * (w - nwl);
    const long long stride = left ? a.Np : a.scap;
    int src[PER];
    unsigned live = 0u;
#pragma unroll
    for (int b = 0; b < PER; ++b) {
      const bool in = j0 + b >= 0 && j0 + b < n;
      src[b] = in ? ord[j0 + b] : 0;
      live |= (unsigned)in << b;
    }
    if (live == (1u << PER) - 1u) {
      for (int r = 0; r < a.R; ++r) {
        const BinT* s = sb + r * T;
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < PER; ++b)
          word |= (uint32_t)s[src[b]] << (BITS * b);
        *(uint32_t*)(dst + r * stride) = word;
      }
    } else {
      for (int r = 0; r < a.R; ++r)
        for (int b = 0; b < PER; ++b)
          if ((live >> b) & 1u) dst[r * stride + b] = sb[r * T + src[b]];
    }
  }
}

// One tile of the leaf: stage, order, publish, look back, write.  k is
// the tile's ticket, ntiles the leaf's tile count.
template <class BinT>
__device__ __forceinline__ void part_tile(const PartArgs<BinT>& a,
                                          const Leaf& lf,
                                          unsigned epoch, int k, int ntiles,
                                          unsigned char* smem) {
  __shared__ unsigned lmask[MAX_TILE / 32], vmask[MAX_TILE / 32];
  __shared__ int loff[MAX_TILE / 32], roff[MAX_TILE / 32];
  __shared__ int s_nl, s_nr;
  __shared__ long long s_excl;
  const int T = a.T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* sg = (uint32_t*)smem;
  BinT* sb = (BinT*)(smem + 32 * T);
  uint16_t* ordl =
      (uint16_t*)((unsigned char*)sb +
                  ((a.R * T * (int)sizeof(BinT) + 15) & ~15));
  uint16_t* ordr = ordl + T;

  const long long end = lf.start + lf.cnt;
  const long long t0 = (lf.start & ~15LL) + (long long)k * T;
  // staged rows [t0, t0 + n16); the leaf's rows are [v0, v1) of the tile
  const int n16 = (int)min((long long)T, ((end + 15) & ~15LL) - t0);
  const int v0 = (int)max(0LL, lf.start - t0);
  const int v1 = (int)min((long long)T, end - t0);

  // 16-byte copies: 16 / sizeof(BinT) bins each
  constexpr int LOG_BPC = sizeof(BinT) == 1 ? 4 : 3;
  const int cb = n16 >> LOG_BPC, cg = n16 >> 2;
  for (int c = tid; c < a.R * cb; c += blockDim.x) {
    const int r = c / cb, o = (c - r * cb) << LOG_BPC;
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
    const bool l = v && decide_left(sb[lf.d.col * T + i], lf.d, a.ncat);
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
      st_release(a.status + k, tile_word(epoch, k == 0 ? TILE_INC : TILE_AGG,
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
            j >= 0 ? ld_acquire(a.status + j) : tile_word(epoch, TILE_INC, 0);
        const unsigned st =
            (unsigned)(f >> 32) == epoch ? (unsigned)(f >> 30) & 3u : 0u;
        const unsigned pm = __ballot_sync(0xffffffffu, st == TILE_INC);
        const unsigned xm = __ballot_sync(0xffffffffu, st == 0u);
        const int fp = pm ? __ffs(pm) - 1 : 31;
        const unsigned need = fp == 31 ? 0xffffffffu : ((2u << fp) - 1u);
        if (xm & need) {
          // an earlier tile's ticket is held by a running block, which
          // publishes it; a wait of seconds means a broken launch: fail,
          // do not hang
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
                   tile_word(epoch, TILE_INC, (unsigned)(excl + nl)));
    }
    const int nr = __shfl_sync(0xffffffffu, ir, 31);
    if (lane == 0) {
      s_excl = excl;
      s_nl = nl;
      s_nr = nr;
      if (k == ntiles - 1) a.nl_out[0] = (int)(excl + nl);
    }
  }
  __syncthreads();

  const long long excl = s_excl;
  const long long gl = lf.start + excl;                   // first left
  const long long gr = max(0LL, t0 - lf.start) - excl;    // first right
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

// The tile pass.  The grid is fixed by the launch's bound (at most the
// blocks the card holds at once); the first min(gridDim.x, ntiles)
// blocks take tile tickets from the counter until each draws one past
// the leaf's last tile, so a leaf of any size up to the bound is covered,
// and the other blocks exit at once (a step of no rows touches no
// ticket).  Every taking block draws exactly one ticket past the last
// tile, so the block that draws the very last ticket (ntiles + takers -
// 1) resets the counter for the next launch.
template <class BinT>
__global__ void __launch_bounds__(PART_THREADS)
    part_tiles(PartArgs<BinT> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Leaf s_leaf;
  __shared__ unsigned s_epoch;
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_leaf = read_leaf(a.step, a.R, a.Np, a.bound);
    if (s_leaf.bad && blockIdx.x == 0) step_error(a.step, ERR_RANGE);
    s_epoch = *(volatile unsigned*)a.epoch;
  }
  __syncthreads();
  const Leaf lf = s_leaf;
  const int ntiles =
      lf.cnt ? (int)((lf.start + lf.cnt - (lf.start & ~15LL) + a.T - 1) /
                     a.T)
             : 0;
  if (lf.cnt == 0 && blockIdx.x == 0 && tid == 0) a.nl_out[0] = 0;
  const int takers = min((int)gridDim.x, ntiles);
  if ((int)blockIdx.x >= takers) return;
  while (true) {
    if (tid == 0) {
      const int k = (int)atomicAdd(a.ticket, 1u);
      if (k == ntiles + takers - 1) *a.ticket = 0u;
      s_tile = k;
    }
    __syncthreads();
    const int k = s_tile;
    if (k >= ntiles) return;
    part_tile(a, lf, s_epoch, k, ntiles, smem);
    __syncthreads();
  }
}

// Copy the r = cnt - nl rights from scratch to [start + nl, start + cnt):
// one thread per (row, aligned 16-row chunk of the destination), striding
// over the chunks.  A whole chunk of a uint8 bin row is five aligned
// 4-byte loads funnel-shifted into one 16-byte store (uint16: nine loads
// into two stores); of a payload row, four 16-byte stores.  One thread
// moves the epoch on for the next launch.
template <class BinT>
__global__ void __launch_bounds__(COPY_THREADS)
    part_copyback(PartArgs<BinT> a) {
  BinT* __restrict__ bins = a.bins;
  uint32_t* __restrict__ ghi = a.ghi;
  const long long Np = a.Np;
  const int R = a.R;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    const unsigned e = *a.epoch + 1u;
    *a.epoch = e ? e : 1u;
  }
  const Leaf lf = read_leaf(a.step, a.R, a.Np, a.bound);
  if (lf.cnt == 0) return;
  const int nl = *a.nl_out;
  const int n = lf.cnt - nl;
  if (n <= 0) return;
  const BinT* __restrict__ sbins = a.sbins;
  const uint32_t* __restrict__ sghi = a.sghi;
  const long long scap = a.scap;
  const long long g0 = lf.start + nl;
  const long long c0 = g0 >> 4;
  const long long nch = ((g0 + n - 1) >> 4) - c0 + 1;
  const int row = blockIdx.y;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < nch; c += (long long)gridDim.x * blockDim.x) {
    const long long p0 = (c0 + c) << 4;
    const long long j0 = p0 - g0;
    const bool full = j0 >= 0 && j0 + 16 <= n;
    if (row < R) {
      const BinT* s = sbins + row * scap;
      BinT* dst = bins + row * Np + p0;
      if (full) {
        // the chunk's 16 bins are NW words of the scratch row from
        // byte j0 * sizeof(BinT) on: NW + 1 aligned loads, shifted
        constexpr int NW = 4 * (int)sizeof(BinT);
        const long long jb = j0 * (long long)sizeof(BinT);
        const uint32_t* sw = (const uint32_t*)s + (jb >> 2);
        const int sh = (int)(jb & 3) * 8;
        uint32_t wv[NW + 1];
#pragma unroll
        for (int k = 0; k < NW; ++k) wv[k] = sw[k];
        wv[NW] = sh ? sw[NW] : 0u;
#pragma unroll
        for (int k = 0; k < NW / 4; ++k)
          ((uint4*)dst)[k] = make_uint4(
              __funnelshift_r(wv[4 * k], wv[4 * k + 1], sh),
              __funnelshift_r(wv[4 * k + 1], wv[4 * k + 2], sh),
              __funnelshift_r(wv[4 * k + 2], wv[4 * k + 3], sh),
              __funnelshift_r(wv[4 * k + 3], wv[4 * k + 4], sh));
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

// Check the host-known bounds of a partition launch: the buffers, the
// tile, and scratch for `bound` rows.  The step's own range is checked on
// the device (read_leaf).
template <class BinT>
static inline bool part_args_ok(const PartArgs<BinT>& a) {
  return a.R >= 1 && a.bound >= 0 && a.bound < (1 << 24) && a.Np % 16 == 0 &&
         a.T >= 32 && a.T <= MAX_TILE && a.T % 32 == 0 &&
         a.scap >= (long long)a.bound + 16 && a.scap % 16 == 0 &&
         a.step != nullptr && a.epoch != nullptr && a.ncat >= CAT_WORDS &&
         ((uintptr_t)a.bins | (uintptr_t)a.ghi | (uintptr_t)a.sbins |
          (uintptr_t)a.sghi) % 16 == 0;
}

// Tiles of a leaf of `bound` rows at any start: the status words the
// launch needs.
static inline long long part_tiles_for(int bound, int T) {
  return ((long long)bound + 15 + T - 1) / T;
}

// Raise a kernel's dynamic shared-memory limit once, to the most it is
// ever launched with: no attribute call is made again for a smaller
// launch (so a captured graph's launches make none).
static inline cudaError_t smem_limit(const void* fn, int* done, int smem) {
  if (smem <= *done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *done = smem;
  return e;
}

// Enqueue the partition of the step's leaf on stream s: part_tiles, then
// part_copyback, on grids fixed by the bound.  One set of statics an
// instantiation.
template <class BinT>
static inline cudaError_t partition_phases(const PartArgs<BinT>& a,
                                           cudaStream_t s) {
  static int smem_set = 0, occ_smem = -1, occ = 0, nsm = 0;
  const int smem = part_smem_bytes(a.R, a.T, (int)sizeof(BinT));
  cudaError_t e =
      smem_limit((const void*)part_tiles<BinT>, &smem_set, smem);
  if (e != cudaSuccess) return e;
  if (!nsm) {
    int dev;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (occ_smem != smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, part_tiles<BinT>, PART_THREADS, smem);
    if (e != cudaSuccess) return e;
    occ_smem = smem;
  }
  const long long tiles = std::max(part_tiles_for(a.bound, a.T), 1LL);
  const int grid = (int)std::min(tiles, (long long)nsm * std::max(occ, 1));
  part_tiles<BinT><<<grid, PART_THREADS, smem, s>>>(a);
  // the copy-back's grid: chunks of `bound` rows, at most the threads the
  // card holds at once over its R + 8 rows
  const long long need = ((long long)a.bound / 16 + 2 + COPY_THREADS - 1) /
                         COPY_THREADS;
  const int cap = std::max(1, nsm * (2048 / COPY_THREADS) / (a.R + GHI_ROWS));
  const int bx = (int)std::min(need, (long long)cap);
  part_copyback<BinT><<<dim3(bx, a.R + GHI_ROWS), COPY_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
