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
// side in its original order.  The TPU kernel carried its write frontier
// across a grid that ran in order; the card's blocks run in any order,
// so the frontier is rebuilt from a scan:
//   part_count    left count per 2048-row tile;
//   part_scan     one block: exclusive scan of the tile counts; the total
//                 is the left count, written to nl_out on the device;
//   part_scatter  per tile, a ballot scan of the decisions gives each row
//                 its stable destination in a scratch copy;
//   part_copy     copies the scratch back over the leaf range.
// The four kernels run in stream order, so the copy-back never overlaps
// the scatter, and no host sync is needed for the left count.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_THREADS 256
#define TILE_ROWS 2048
#define GHI_ROWS 8
#define SCAN_THREADS 1024

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

__global__ void part_count(const uint8_t* __restrict__ bins,
                           long long Np, long long start, int cnt,
                           SplitDecision d, int* __restrict__ tile_cnt) {
  __shared__ int wsum[TILE_THREADS / 32];
  const long long base = (long long)blockIdx.x * TILE_ROWS;
  const uint8_t* crow = bins + (long long)d.col * Np + start;
  int c = 0;
  for (int p = 0; p < TILE_ROWS; p += TILE_THREADS) {
    const long long i = base + p + threadIdx.x;
    if (i < cnt) c += decide_left(crow[i], d);
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int k = 0; k < TILE_THREADS / 32; ++k) s += wsum[k];
    tile_cnt[blockIdx.x] = s;
  }
}

__global__ void part_scan(int* __restrict__ tile_cnt, int ntiles,
                          int* __restrict__ nl_out) {
  __shared__ int sums[SCAN_THREADS];
  const int t = threadIdx.x;
  const int per = (ntiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(ntiles, t * per);
  const int hi = min(ntiles, lo + per);
  int local = 0;
  for (int j = lo; j < hi; ++j) local += tile_cnt[j];
  sums[t] = local;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    const int v = t >= off ? sums[t - off] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = sums[t] - local;
  for (int j = lo; j < hi; ++j) {
    const int v = tile_cnt[j];
    tile_cnt[j] = run;
    run += v;
  }
  if (t == SCAN_THREADS - 1) nl_out[0] = sums[t];
}

__global__ void part_scatter(const uint8_t* __restrict__ bins,
                             const uint32_t* __restrict__ ghi,
                             long long Np, int R, long long start,
                             int cnt, SplitDecision d,
                             const int* __restrict__ tile_loff,
                             const int* __restrict__ nl_ptr,
                             uint8_t* __restrict__ sbins,
                             uint32_t* __restrict__ sghi,
                             long long scap) {
  __shared__ int warp_l[TILE_THREADS / 32];
  const long long base = (long long)blockIdx.x * TILE_ROWS;
  const long long nl = *nl_ptr;
  long long lbefore = tile_loff[blockIdx.x];
  const uint8_t* crow = bins + (long long)d.col * Np + start;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int p = 0; p < TILE_ROWS; p += TILE_THREADS) {
    const long long i = base + p + threadIdx.x;
    const bool active = i < cnt;
    const int left = active ? decide_left(crow[i], d) : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, left);
    if (lane == 0) warp_l[w] = __popc(bal);
    __syncthreads();
    int woff = 0, ptotal = 0;
    for (int k = 0; k < TILE_THREADS / 32; ++k) {
      if (k < w) woff += warp_l[k];
      ptotal += warp_l[k];
    }
    if (active) {
      const long long L = lbefore + woff + __popc(bal & ((1u << lane) - 1u));
      const long long dest = left ? L : nl + (i - L);
      const long long src = start + i;
      for (int r = 0; r < R; ++r) sbins[r * scap + dest] = bins[r * Np + src];
      for (int k = 0; k < GHI_ROWS; ++k)
        sghi[k * scap + dest] = ghi[k * Np + src];
    }
    lbefore += ptotal;
    __syncthreads();
  }
}

__global__ void part_copy(uint8_t* __restrict__ bins,
                          uint32_t* __restrict__ ghi, long long Np,
                          int R, long long start, int cnt,
                          const uint8_t* __restrict__ sbins,
                          const uint32_t* __restrict__ sghi,
                          long long scap) {
  const int row = blockIdx.y;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cnt; i += (long long)gridDim.x * blockDim.x) {
    if (row < R)
      bins[row * Np + start + i] = sbins[row * scap + i];
    else
      ghi[(row - R) * Np + start + i] = sghi[(row - R) * scap + i];
  }
}

__global__ void part_set_count(int* nl_out, int v) { nl_out[0] = v; }

// Enqueue the partition of [start, start + cnt) (cnt > 0) on stream s.
// tile_cnt holds ntiles = ceil(cnt / TILE_ROWS) ints; the scratch sbins /
// sghi hold scap >= cnt rows.
static inline void partition_phases(uint8_t* bins, uint32_t* ghi, int R,
                                    long long Np, long long start, int cnt,
                                    const SplitDecision& d, int* tile_cnt,
                                    int ntiles, int* nl_out, uint8_t* sbins,
                                    uint32_t* sghi, long long scap,
                                    cudaStream_t s) {
  part_count<<<ntiles, TILE_THREADS, 0, s>>>(bins, Np, start, cnt, d,
                                             tile_cnt);
  part_scan<<<1, SCAN_THREADS, 0, s>>>(tile_cnt, ntiles, nl_out);
  part_scatter<<<ntiles, TILE_THREADS, 0, s>>>(bins, ghi, Np, R, start, cnt,
                                               d, tile_cnt, nl_out, sbins,
                                               sghi, scap);
  const int cblocks = min((cnt + 255) / 256, 4096);
  part_copy<<<dim3(cblocks, R + GHI_ROWS), 256, 0, s>>>(
      bins, ghi, Np, R, start, cnt, sbins, sghi, scap);
}
