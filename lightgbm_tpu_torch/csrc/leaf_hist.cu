// Leaf histogram on Hopper: per (group, bin) sums of grad and hess over
// one leaf's contiguous rows; and, in its state launch, the
// histogram-state update of the histogram-subtraction split path.
//
// Replaces the TPU kernels leaf_hist_pallas
// (lightgbm_tpu/ops/histogram.py) and hist_rmw_pallas
// (lightgbm_tpu/ops/hist_state_pallas.py).  Plain PyTorch versions:
// leaf_hist_plain (the f32 contract the CPU runs) and
// leaf_hist_fixed_plain (this kernel's arithmetic, bit for bit) in
// lightgbm_tpu_torch/ops/histogram.py; for the state launch
// hist_rmw_plain (the CPU's) and leaf_hist_rmw_fixed_plain (bit for bit)
// in lightgbm_tpu_torch/ops/hist_state.py.
//
// leaf_hist_fixed: the (2, G, Bp) f32 planes (grad plane, hess plane;
// bin b at column b) of the rows [s, s + c) of the (R, Np) uint8 bin
// rows, grad and hess read from payload rows 0 and 1.  The range comes
// from the host, or -- for a child of the split just made, whose size is
// known only on the device -- from the partition's left count nl: side 1
// is the left child [start, start + nl), side 2 the right child
// [start + nl, start + cnt).  The grid is sized for the parent's cnt
// rows; the child's range and 16-row alignment are worked out on the
// device.  The fixed-point scale comes from kcnt when it is given, else
// from the count of the rows summed (a child's is read on the device).
// A child of no rows gives zeros.
//
// leaf_hist_state: the same histogram at the tree's scale (kcnt, the
// root's row count, and a per-tree bound), then the state epilogue.  The
// state is (slots, 2, G, Bp) int64: each leaf's exact fixed-point sums.
// For [parent, wa, wb, small_is_left], the thread that holds an entry of
// the smaller child's exact sum reads the parent slot's entry first (wa
// may be the parent's slot), forms large = parent - small in int64,
// writes left to slot wa, then right to slot wb (wa == wb, a trash slot,
// ends holding the right child), and writes both, (int64 -> double) *
// 2^-k -> f32, into children (2, 2, G, Bp) = (plane, child, G, Bp): the
// pair search's (2G, Bp) grad and hess inputs, the left child's rows
// first (csrc/split_pair.cu).  parent < 0 (the root): slot wa gets the
// histogram and both children are it.  The integer subtraction is exact,
// so the larger child's slot and planes are bit-identical to a direct
// fixed-point histogram of its own rows at the tree's scale.  No sum
// overflows: rows < 2^24 and |v| <= the bound give |sum| < 2^62.
//
// What bounds it on this card: bytes by the roofline -- each row's G bin
// bytes and its grad and hess words are read once; the epilogue reads a
// parent slot and writes two slots and two f32 children, 32 bytes an
// entry -- and in practice the shared-memory adds, two 64-bit adds per
// (row, group).  The design is the fixed-point histogram of
// csrc/hist_fixed.cuh, shared with the split mega-kernel's histogram:
// exact integer sums by shared-memory atomics, in any order; two planes a
// group (4 KB at Bp = 256: all 28 HIGGS groups in one block); each lane
// reads its 16 rows' grad and hess once for all the block's groups; the
// group sets combine by 64-bit global atomics and the last block
// converts -- and, in the state launch, runs the subtraction on its exact
// sums, so the state update costs no launch of its own.  What the fused
// update costs is tail time: it runs on each group set's last block
// alone, so at a leaf of millions of rows (one group set) a single SM
// reads and writes the whole slot's ~0.5 MB; its loads are batched
// (hist_fixed_finish) but not spread over SMs.  The TPU kernel's (8, WL)
// lane-flattened state is a TPU tiling rule and is not carried over.  One
// launch per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"

struct LeafArgs {
  const uint8_t* bins;          // (R, Np)
  long long Np;
  const float* ghi;             // rows 0, 1: grad, hess
  long long start;
  int cnt;                      // the parent's rows (side != 0)
  const int* nl;                // the partition's left count (side != 0)
  int side;                     // 0 whole range, 1 left child, 2 right
  int kcnt;                     // > 0: the count that sets the scale
  int G, GB, Bp;                // groups, groups per block, padded bins
  const float* absmax;          // (2,): bounds of |grad|, |hess|
  unsigned long long* acc;      // (G, 2, Bp), zero before and after
  unsigned* done;               // one per group set, zero before and after
  float* out;                   // (2, G, Bp) planes; state: (2, 2, G, Bp)
  long long* state;             // (slots, 2, G, Bp) int64 (state launch)
  int parent, wa, wb, sil;      // slots; parent < 0: no parent
};

template <bool STATE>
__device__ __forceinline__ void leaf_hist_body(const LeafArgs& a) {
  extern __shared__ __align__(16) unsigned shist[];
  const int tid = threadIdx.x;
  const int Bp = a.Bp;
  const int g_lo = blockIdx.y * a.GB;
  const int gn = min(a.GB, a.G - g_lo);
  unsigned* slo = shist;                  // low words, (gn, 2, Bp)
  unsigned* shi = shist + a.GB * 2 * Bp;  // high words
  for (int i = tid; i < 2 * a.GB * 2 * Bp; i += HIST_THREADS) shist[i] = 0u;
  long long s0 = a.start;
  int c = a.cnt;
  if (a.side == 1) {
    c = *a.nl;
  } else if (a.side == 2) {
    s0 += *a.nl;
    c = a.cnt - *a.nl;
  }
  const int kc = a.kcnt > 0 ? a.kcnt : c;
  const int kg = fixed_exponent(a.absmax[0], kc);
  const int kh = fixed_exponent(a.absmax[1], kc);
  const long long plane = (long long)a.G * Bp;
  const long long n = 2 * plane;                // one slot
  const bool sub = STATE && a.parent >= 0;
  __syncthreads();

  hist_fixed_rows<2>(a.bins, a.Np, a.ghi, s0, c, g_lo, gn, Bp,
                     ldexp(1.0, kg), ldexp(1.0, kh), slo, shi,
                     [](long long) { return 0u; });
  __syncthreads();

  // block entry i = (gl, plane, bin) -> slot entry (plane, g_lo + gl, bin)
  const double ig = ldexp(1.0, -kg), ih = ldexp(1.0, -kh);
  auto entry = [&](int i) {
    return ((i / Bp) & 1) * plane + (long long)(g_lo + i / (2 * Bp)) * Bp +
           i % Bp;
  };
  // no __restrict__ on the state: slot wa may be slot parent, so each
  // entry's parent word is loaded (pre) before any store of its round
  hist_fixed_finish(
      slo, shi, gn * 2 * Bp, Bp, a.acc + (long long)g_lo * 2 * Bp,
      a.done + blockIdx.y, ig, ih,
      [&](int i) { return sub ? a.state[a.parent * n + entry(i)] : 0ll; },
      [&](int i, long long v, long long parent, float f) {
        const long long e = entry(i);
        if (!STATE) {
          a.out[e] = f;
          return;
        }
        // children (plane, child, G, Bp): plane p's left child at
        // e + p * plane, its right child at e + (p + 1) * plane
        const int p = (i / Bp) & 1;
        long long left = v, right = v;
        if (sub) {
          const long long large = parent - v;
          left = a.sil ? v : large;
          right = a.sil ? large : v;
          a.state[a.wa * n + e] = left;
          a.state[a.wb * n + e] = right;
        } else {
          a.state[a.wa * n + e] = v;
        }
        const double inv = p ? ih : ig;
        a.out[e + p * plane] = (float)((double)left * inv);
        a.out[e + (p + 1) * plane] = (float)((double)right * inv);
      });
}

__global__ void __launch_bounds__(HIST_THREADS, 1)
    leaf_hist_fixed(LeafArgs a) {
  leaf_hist_body<false>(a);
}

__global__ void __launch_bounds__(HIST_THREADS, 1)
    leaf_hist_state(LeafArgs a) {
  leaf_hist_body<true>(a);
}

// state == nullptr: leaf_hist_fixed into out (2, G, Bp); otherwise
// leaf_hist_state on the (slots, 2, G, Bp) state into out (2, 2, G, Bp),
// which needs kcnt > 0.
extern "C" int leaf_hist_launch(const uint8_t* bins, int R, long long Np,
                                const float* ghi, long long start, int cnt,
                                const int* nl, int side, int kcnt,
                                const float* absmax, unsigned long long* acc,
                                unsigned* done, int G, int Bp, float* out,
                                long long* state, int slots, int parent,
                                int wa, int wb, int sil, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool st = state != nullptr;
  if (Bp < 16 || Bp > MAX_BP || Bp % 16 || G < 1 || G > R || cnt < 0 ||
      start < 0 || start + cnt > Np || Np % 16 || side < 0 || side > 2 ||
      (side != 0 && nl == nullptr) || kcnt < 0 || (kcnt > 0 && kcnt < cnt) ||
      ((uintptr_t)bins | (uintptr_t)ghi) % 16)
    return (int)cudaErrorInvalidValue;
  if (st && (kcnt == 0 || parent < -1 || parent >= slots || wa < 0 ||
             wa >= slots || wb < 0 || wb >= slots || (sil != 0 && sil != 1)))
    return (int)cudaErrorInvalidValue;
  if (cnt == 0 && !st) {
    cudaMemsetAsync(out, 0, sizeof(float) * 2 * (size_t)G * Bp, s);
    return (int)cudaGetLastError();
  }
  HistGrid g;
  const long long nu =
      std::max((start + cnt - (start & ~15LL) + 15) >> 4, 1LL);
  cudaError_t e = hist_grid(G, 2, Bp, nu, &g);
  if (e != cudaSuccess) return (int)e;
  const void* fn = st ? (const void*)leaf_hist_state
                      : (const void*)leaf_hist_fixed;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           g.smem);
  if (e != cudaSuccess) return (int)e;
  const LeafArgs a{bins,  Np,   ghi, start, cnt,   nl,    side,
                   kcnt,  G,    g.GB, Bp,  absmax, acc, done,
                   out,   state, parent, wa, wb,   sil};
  if (st)
    leaf_hist_state<<<dim3(g.nrb, g.ngb), HIST_THREADS, g.smem, s>>>(a);
  else
    leaf_hist_fixed<<<dim3(g.nrb, g.ngb), HIST_THREADS, g.smem, s>>>(a);
  return (int)cudaGetLastError();
}
