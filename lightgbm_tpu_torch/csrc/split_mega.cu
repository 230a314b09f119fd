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
//   then the partition phases of csrc/partition.cuh (tile counts, one-
//   block scan, ballot-scan scatter to scratch, copy-back), shared with
//   csrc/partition.cu.
// The row reads of mega_hist are repeated for each group block of a
// chunk; blockIdx.x runs over groups so those blocks run together and
// the repeated payload reads hit L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

#define HIST_WARPS 8
#define HIST_THREADS (HIST_WARPS * 32)
#define MAX_BP 256

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
    part_set_count<<<1, 1, 0, s>>>(nl_out, 0);
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
    part_set_count<<<1, 1, 0, s>>>(nl_out, cnt);
    return (int)cudaGetLastError();
  }
  partition_phases(bins, ghi, R, Np, start, cnt, d, tile_cnt, ntiles, nl_out,
                   sbins, sghi, scap, s);
  return (int)cudaGetLastError();
}
