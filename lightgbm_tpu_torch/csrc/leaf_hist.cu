// Leaf histogram on Hopper: per (group, bin) sums of grad and hess over
// one leaf's contiguous rows.
//
// Replaces the TPU kernel leaf_hist_pallas
// (lightgbm_tpu/ops/histogram.py); its plain PyTorch version is
// leaf_hist_plain in lightgbm_tpu_torch/ops/histogram.py.  Output: the
// (2, G, Bp) f32 planes (grad plane, hess plane; bin b at column b) of
// the rows [s, s + c) of the (R, Np) uint8 bin rows, grad and hess read
// from payload rows 0 and 1.  The range comes from the host, or -- for a
// child of the split just made, whose size is known only on the device
// -- from the partition's left count nl: side 1 is the left child
// [start, start + nl), side 2 the right child [start + nl, start + cnt).
// The grid is sized for the parent's cnt rows; blocks past the child's
// rows add nothing.  Rows outside the range contribute nothing.
//
// What bounds it on this card: bytes -- each row's G bin bytes and its
// grad and hess words are read once by the contract; the work is two
// f32 adds per (row, group).  The design is one side of the split
// mega-kernel's histogram pass:
//   lh_rows    grid (G, chunks): one block per (group, chunk of rows).
//              Each warp owns a private 2 x 256 histogram in shared
//              memory and takes 32-row batches in a fixed round-robin;
//              lanes with the same bin are combined by the lowest such
//              lane in lane order (__match_any_sync), so every add lands
//              in an order fixed by the row order.  The warps' histograms
//              are summed in warp order into the block's partial.
//   lh_reduce  sums the per-chunk partials in chunk order.
// No float atomics: the histogram is bit-identical run to run.  The
// grad/hess reads repeat for each group block of a chunk; blockIdx.x
// runs over groups so those blocks run together and the repeats hit L2.

#include <cuda_runtime.h>
#include <stdint.h>

#define HIST_WARPS 8
#define HIST_THREADS (HIST_WARPS * 32)
#define MAX_BP 256

__global__ void lh_rows(const uint8_t* __restrict__ bins, long long Np,
                        const float* __restrict__ ghi, long long start,
                        int cnt, const int* __restrict__ nl, int side,
                        int chunk_rows, int G, int Bp,
                        float* __restrict__ partials) {
  __shared__ float whist[HIST_WARPS][2 * MAX_BP];
  __shared__ float stg[HIST_WARPS][2][32];
  long long s0 = start;
  int c = cnt;
  if (side == 1) {
    c = *nl;
  } else if (side == 2) {
    s0 += *nl;
    c = cnt - *nl;
  }
  const int g = blockIdx.x;
  const int ch = blockIdx.y;
  const long long lo = (long long)ch * chunk_rows;
  const long long hi = min((long long)c, lo + chunk_rows);
  for (int k = threadIdx.x; k < HIST_WARPS * 2 * MAX_BP; k += HIST_THREADS)
    (&whist[0][0])[k] = 0.0f;
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* brow = bins + (long long)g * Np + s0;
  const float* grow = ghi + s0;
  const float* hrow = ghi + Np + s0;
  float* wh = whist[w];
  for (long long base = lo + w * 32; base < hi; base += HIST_THREADS) {
    const long long i = base + lane;
    const bool active = i < hi;
    int key = -1;
    float gv = 0.0f, hv = 0.0f;
    if (active) {
      key = brow[i];
      gv = grow[i];
      hv = hrow[i];
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
      wh[key] = wh[key] + sg;
      wh[MAX_BP + key] = wh[MAX_BP + key] + sh;
    }
    __syncwarp();
  }
  __syncthreads();
  // block partial (chunk, group, plane, bin)
  float* out = partials + ((long long)ch * G + g) * 2 * Bp;
  for (int k = threadIdx.x; k < 2 * Bp; k += HIST_THREADS) {
    const int sidx = (k / Bp) * MAX_BP + k % Bp;
    float s = 0.0f;
    for (int ww = 0; ww < HIST_WARPS; ++ww) s = s + whist[ww][sidx];
    out[k] = s;
  }
}

__global__ void lh_reduce(const float* __restrict__ partials, int nchunks,
                          int G, int Bp, float* __restrict__ hist) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * G * Bp) return;
  // output (plane, group, bin); partial (chunk, group, plane, bin)
  const int plane = i / (G * Bp);
  const int g = (i / Bp) % G;
  const int b = i % Bp;
  const long long off = ((long long)g * 2 + plane) * Bp + b;
  const long long stride = 2LL * G * Bp;
  float s = 0.0f;
  for (int ch = 0; ch < nchunks; ++ch) s = s + partials[ch * stride + off];
  hist[i] = s;
}

extern "C" int leaf_hist_launch(const uint8_t* bins, int R, long long Np,
                                const float* ghi, long long start, int cnt,
                                const int* nl, int side, float* partials,
                                int chunk_rows, int nchunks, int G, int Bp,
                                float* hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Bp < 16 || Bp > MAX_BP || Bp % 16 || G < 1 || G > R || cnt < 0 ||
      start < 0 || start + cnt > Np || side < 0 || side > 2 ||
      (side != 0 && nl == nullptr) || chunk_rows < 1 ||
      (long long)chunk_rows * nchunks < cnt)
    return (int)cudaErrorInvalidValue;
  if (cnt == 0) {
    cudaMemsetAsync(hist, 0, sizeof(float) * 2 * (size_t)G * Bp, s);
    return (int)cudaGetLastError();
  }
  lh_rows<<<dim3(G, nchunks), HIST_THREADS, 0, s>>>(
      bins, Np, ghi, start, cnt, nl, side, chunk_rows, G, Bp, partials);
  const int n = 2 * G * Bp;
  lh_reduce<<<(n + 255) / 256, 256, 0, s>>>(partials, nchunks, G, Bp, hist);
  return (int)cudaGetLastError();
}
