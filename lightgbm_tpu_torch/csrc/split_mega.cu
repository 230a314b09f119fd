// Split mega-kernel on Hopper: partition one leaf's rows and build both
// children's histograms from the same split decision.
//
// Replaces the TPU kernel split_megakernel_pallas
// (lightgbm_tpu/ops/split_megakernel_pallas.py); its plain PyTorch
// version is split_mega_plain in lightgbm_tpu_torch/ops/split_mega.py.
// The contract (ops/partition.py): a stable two-way partition of the
// leaf range [start, start + cnt) of the (R, Np) uint8 bin rows and the
// eight (8, Np) 32-bit payload rows (moved as raw words: row 2 holds row
// ids), the left count, and the (G, 4, Bp) histogram -- left-grad,
// left-hess, right-grad, right-hess over bin = hi * 16 + lo -- of the
// rows as they were before the partition.  cnt == 0 moves nothing and
// returns zeros.  The TPU kernel's packed payload and roll-network
// compaction are its own mechanism and are not carried over.
//
// What bounds it on this card: bytes.  A split reads the leaf's rows
// (R bin bytes + 8 payload words each) and writes them twice (scratch,
// then back in place); the histogram work is a few integer and f32
// operations per (row, group), far below the card's operation rate.
// The design:
//   mega_hist         grid (G, chunks): one block per (group, chunk of
//                     rows), so small leaves still spread over G blocks
//                     and a root-sized leaf over thousands.  Each warp
//                     owns a private 4 x Bp histogram in shared memory
//                     and takes 32-row batches in a fixed round-robin.
//                     Lanes whose (side, bin) agree are combined by the
//                     lowest such lane in lane order (__match_any_sync),
//                     so every add lands in an order fixed by the row
//                     order: the histogram is bit-identical run to run,
//                     with no float atomics.  Cost: one shuffle-free
//                     shared-memory staging round per 32 rows.
//   mega_hist_reduce  sums the per-chunk partials in chunk order.
//   mega_count        left count per 2048-row tile.
//   mega_scan         one block: exclusive scan of the tile counts; the
//                     total is the left count.
//   mega_scatter      per tile, a ballot scan of the decisions gives
//                     each row its stable destination in a scratch copy.
//   mega_copy         copies the scratch back over the leaf range.
// The row reads of mega_hist are repeated for each group block of a
// chunk; blockIdx.x runs over groups so those blocks run together and
// the repeated payload reads hit L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

#define HIST_WARPS 8
#define HIST_THREADS (HIST_WARPS * 32)
#define MAX_BP 256
#define TILE_THREADS 256
#define TILE_ROWS 2048
#define GHI_ROWS 8
#define SCAN_THREADS 1024

__global__ void mega_hist(const uint8_t* __restrict__ bins, long long Np,
                          const float* __restrict__ ghi, long long start,
                          int cnt, int chunk_rows, SplitDecision d, int G,
                          int Bp, float* __restrict__ partials) {
  __shared__ float whist[HIST_WARPS][4 * MAX_BP];
  __shared__ float stg[HIST_WARPS][2][32];
  const int g = blockIdx.x;
  const int ch = blockIdx.y;
  const long long lo = (long long)ch * chunk_rows;
  const long long hi = min((long long)cnt, lo + chunk_rows);
  for (int k = threadIdx.x; k < HIST_WARPS * 4 * MAX_BP; k += HIST_THREADS)
    (&whist[0][0])[k] = 0.0f;
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* brow = bins + (long long)g * Np + start;
  const uint8_t* crow = bins + (long long)d.col * Np + start;
  const float* grow = ghi + start;
  const float* hrow = ghi + Np + start;
  float* wh = whist[w];
  for (long long base = lo + w * 32; base < hi; base += HIST_THREADS) {
    const long long i = base + lane;
    const bool active = i < hi;
    int key = -1, b = 0, side = 0;
    float gv = 0.0f, hv = 0.0f;
    if (active) {
      b = brow[i];
      side = decide_left(crow[i], d) ? 0 : 1;
      gv = grow[i];
      hv = hrow[i];
      key = side * MAX_BP + b;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    stg[w][0][lane] = gv;
    stg[w][1][lane] = hv;
    __syncwarp();
    if (active && lane == __ffs(peers) - 1) {
      float sg = 0.0f, sh = 0.0f;
      for (unsigned m = peers; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        sg = sg + stg[w][0][j];
        sh = sh + stg[w][1][j];
      }
      wh[(2 * side) * Bp + b] = wh[(2 * side) * Bp + b] + sg;
      wh[(2 * side + 1) * Bp + b] = wh[(2 * side + 1) * Bp + b] + sh;
    }
    __syncwarp();
  }
  __syncthreads();
  float* out = partials + ((long long)ch * G + g) * 4 * Bp;
  for (int k = threadIdx.x; k < 4 * Bp; k += HIST_THREADS) {
    float s = 0.0f;
    for (int ww = 0; ww < HIST_WARPS; ++ww) s = s + whist[ww][k];
    out[k] = s;
  }
}

__global__ void mega_hist_reduce(const float* __restrict__ partials,
                                 int nchunks, int n, float* __restrict__ hist) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int ch = 0; ch < nchunks; ++ch) s = s + partials[(long long)ch * n + i];
  hist[i] = s;
}

__global__ void mega_count(const uint8_t* __restrict__ bins, long long Np,
                           long long start, int cnt, SplitDecision d,
                           int* __restrict__ tile_cnt) {
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

__global__ void mega_scan(int* __restrict__ tile_cnt, int ntiles,
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

__global__ void mega_scatter(const uint8_t* __restrict__ bins,
                             const uint32_t* __restrict__ ghi, long long Np,
                             int R, long long start, int cnt, SplitDecision d,
                             const int* __restrict__ tile_loff,
                             const int* __restrict__ nl_ptr,
                             uint8_t* __restrict__ sbins,
                             uint32_t* __restrict__ sghi, long long scap) {
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

__global__ void mega_copy(uint8_t* __restrict__ bins,
                          uint32_t* __restrict__ ghi, long long Np, int R,
                          long long start, int cnt,
                          const uint8_t* __restrict__ sbins,
                          const uint32_t* __restrict__ sghi, long long scap) {
  const int row = blockIdx.y;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cnt; i += (long long)gridDim.x * blockDim.x) {
    if (row < R)
      bins[row * Np + start + i] = sbins[row * scap + i];
    else
      ghi[(row - R) * Np + start + i] = sghi[(row - R) * scap + i];
  }
}

__global__ void mega_set_count(int* nl_out, int v) { nl_out[0] = v; }

extern "C" int split_mega_launch(
    uint8_t* bins, int R, long long Np, uint32_t* ghi, float* partials,
    int chunk_rows, int nchunks, int* tile_cnt, int ntiles, int* nl_out,
    uint8_t* sbins, uint32_t* sghi, long long scap, float* hist,
    long long start, int cnt, int col, int bstart, int isb, int nb,
    int dbin, int mtype, int thr, int dl, int G, int Bp, int move,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Bp < 16 || Bp > MAX_BP || Bp % 16 || G < 1 || G > R || col < 0 ||
      col >= R || cnt < 0)
    return (int)cudaErrorInvalidValue;
  if (cnt == 0) {
    cudaMemsetAsync(hist, 0, sizeof(float) * 4 * (size_t)G * Bp, s);
    mega_set_count<<<1, 1, 0, s>>>(nl_out, 0);
    return (int)cudaGetLastError();
  }
  const SplitDecision d{col, bstart, isb, nb, dbin, mtype, thr, dl};
  mega_hist<<<dim3(G, nchunks), HIST_THREADS, 0, s>>>(
      bins, Np, (const float*)ghi, start, cnt, chunk_rows, d, G, Bp,
      partials);
  const int n = 4 * G * Bp;
  mega_hist_reduce<<<(n + 255) / 256, 256, 0, s>>>(partials, nchunks, n,
                                                   hist);
  if (!move) {
    mega_set_count<<<1, 1, 0, s>>>(nl_out, cnt);
    return (int)cudaGetLastError();
  }
  mega_count<<<ntiles, TILE_THREADS, 0, s>>>(bins, Np, start, cnt, d,
                                             tile_cnt);
  mega_scan<<<1, SCAN_THREADS, 0, s>>>(tile_cnt, ntiles, nl_out);
  mega_scatter<<<ntiles, TILE_THREADS, 0, s>>>(bins, ghi, Np, R, start, cnt,
                                               d, tile_cnt, nl_out, sbins,
                                               sghi, scap);
  const int cblocks = min((cnt + 255) / 256, 4096);
  mega_copy<<<dim3(cblocks, R + GHI_ROWS), 256, 0, s>>>(
      bins, ghi, Np, R, start, cnt, sbins, sghi, scap);
  return (int)cudaGetLastError();
}
