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
// leaf_hist_fixed: the (2, G, Bp) f32 planes (grad plane, hess plane; bin b
// at column b) of the rows [s, s + c) of the (R, Np) bin rows (uint8, or
// uint16 when a group has more than 256 bins: the kernels are templates on
// the bin type), grad and hess read from payload rows 0 and 1.  The rows
// are the step's range [start, start + cnt), or -- for a child of the split
// just made, whose size is known only on the device -- one side of it at
// the partition's left count nl: side 1 the left child [start, start + nl),
// side 2 the right child [start + nl, start + cnt).  The range, the side
// and the state slots come from the step block on the device
// (csrc/step.cuh); the grid from a bound on a step's rows, cut into group
// sets and row blocks on the device from the rows actually summed
// (hist_split).  A step of no rows (cnt == 0) gives zeros and, in the state
// launch, writes no slot.  The fixed-point scale comes from kcnt when it is
// given, else from the count of the rows summed (a child's is read on the
// device).  A child of no rows gives zeros.
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
// Quantized training (scale != null, the (2,) device word of
// csrc/quantize.cu): grad and hess are integer carriers, the state keeps
// their exact sums, and every f32 output -- the planes, the children -- is
// the f32 value of its exact sum times the plane's scale, one f32 product
// (the scale arm; JAX learner.py _scale_hist).
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
//
// Wide bins: a group of Bp bins takes 16 Bp bytes of shared memory (two
// planes of int64), so up to ~14,500 bins a group the shared arm above
// serves any width, with fewer groups a block (28 HIGGS groups at
// Bp = 1024 take two group sets).  Past that one group does not fit a
// block, and the wide arm (hist_wide) adds each row straight into the
// group set's int64 accumulator in device memory with 64-bit global
// atomics -- exact in any order, so its result is the shared arm's bit
// for bit -- and the set's last block converts and runs the same
// epilogue.  No width is refused.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"
#include "partition.cuh"

template <class BinT>
struct LeafArgs {
  const BinT* bins;             // (R, Np)
  long long Np;
  int R;
  const float* ghi;             // rows 0, 1: grad, hess
  int* step;                    // the step block: range, side, slots
  int bound;                    // rows a step may hold
  const int* nl;                // the partition's left count (side != 0)
  int kcnt;                     // > 0: the count that sets the scale
  int G, GBL, Bp, nsm;          // groups, launch's groups a block, bins, SMs
  const float* absmax;          // (2,): bounds of |grad|, |hess|
  unsigned long long* acc;      // (G, 2, Bp), zero before and after
  unsigned* done;               // one per group set, zero before and after
  float* out;                   // (2, G, Bp) planes; state: (2, 2, G, Bp)
  long long* state;             // (slots, 2, G, Bp) int64 (state launch)
  int slots;
  const float* scale;           // (2,) quantized training: (gs, hs), or null
};

// What one launch sums, read from the step block by one thread.
struct LeafRows {
  long long s0;                 // first row summed
  int c;                        // rows summed
  int cnt;                      // rows of the step (0: write no slot)
  int parent, wa, wb, sil;
};

template <bool STATE, class BinT>
__device__ LeafRows read_rows(const LeafArgs<BinT>& a) {
  const Leaf lf = read_leaf(a.step, a.R, a.Np, a.bound);
  const int side = a.step[SB_SIDE];
  int bits = lf.bad ? ERR_RANGE : 0;
  LeafRows r{lf.start, lf.cnt, lf.cnt, -1, 0, 0, 0};
  if (side < 0 || side > 2 || (side != 0 && a.nl == nullptr) ||
      (a.kcnt > 0 && lf.cnt > a.kcnt))
    bits |= ERR_RANGE;
  if (STATE) {
    r.parent = a.step[SB_PARENT];
    r.wa = a.step[SB_WA];
    r.wb = a.step[SB_WB];
    r.sil = a.step[SB_SIL];
    if (r.parent < -1 || r.parent >= a.slots || r.wa < 0 ||
        r.wa >= a.slots || r.wb < 0 || r.wb >= a.slots ||
        (r.sil != 0 && r.sil != 1))
      bits |= ERR_STATE;
  }
  if (!bits && side != 0 && lf.cnt > 0) {
    const int nl = *a.nl;
    if (nl < 0 || nl > lf.cnt) {
      bits |= ERR_RANGE;
    } else if (side == 1) {
      r.c = nl;
    } else {
      r.s0 += nl;
      r.c = lf.cnt - nl;
    }
  }
  if (bits) {
    r.c = r.cnt = 0;
    if (blockIdx.x == 0) step_error(a.step, bits);
  }
  return r;
}

// WIDE: the wide arm (no shared histogram; global atomics into acc).
template <bool STATE, bool WIDE, class BinT>
__device__ __forceinline__ void leaf_hist_body(const LeafArgs<BinT>& a) {
  extern __shared__ __align__(16) unsigned shist[];
  __shared__ LeafRows s_rows;
  const int tid = threadIdx.x;
  if (tid == 0) s_rows = read_rows<STATE>(a);
  __syncthreads();
  const LeafRows lr = s_rows;
  const long long s0 = lr.s0;
  const int c = lr.c;
  const long long nu = c ? (s0 + c - (s0 & ~15LL) + 15) >> 4 : 0;
  const HistSplit sp = hist_split(a.G, a.GBL, nu, gridDim.x, a.nsm);
  if ((int)blockIdx.x >= sp.ngb * sp.nrb) return;
  const int set = blockIdx.x / sp.nrb, rb = blockIdx.x % sp.nrb;
  const int Bp = a.Bp;
  const int g_lo = set * sp.GB;
  const int gn = min(sp.GB, a.G - g_lo);
  unsigned* slo = shist;                   // low words, (gn, 2, Bp)
  unsigned* shi = shist + sp.GB * 2 * Bp;  // high words
  if (!WIDE)
    for (int i = tid; i < 2 * sp.GB * 2 * Bp; i += HIST_THREADS)
      shist[i] = 0u;
  unsigned long long* acc = a.acc + (long long)g_lo * 2 * Bp;
  const int kc = a.kcnt > 0 ? a.kcnt : c;
  const int kg = fixed_exponent(a.absmax[0], kc);
  const int kh = fixed_exponent(a.absmax[1], kc);
  const long long plane = (long long)a.G * Bp;
  const long long n = 2 * plane;                // one slot
  // a step of no rows writes no slot
  const bool live = STATE && lr.cnt > 0;
  const bool sub = live && lr.parent >= 0;
  __syncthreads();

  hist_fixed_rows<2, WIDE>(a.bins, a.Np, a.ghi, s0, c, g_lo, gn, Bp,
                           ldexp(1.0, kg), ldexp(1.0, kh), slo, shi, rb,
                           sp.nrb, [](long long) { return 0u; }, acc);
  __syncthreads();

  // block entry i = (gl, plane, bin) -> slot entry (plane, g_lo + gl, bin)
  const double ig = ldexp(1.0, -kg), ih = ldexp(1.0, -kh);
  auto entry = [&](int i) {
    return ((i / Bp) & 1) * plane + (long long)(g_lo + i / (2 * Bp)) * Bp +
           i % Bp;
  };
  // no __restrict__ on the state: slot wa may be slot parent, so each
  // entry's parent word is loaded (pre) before any store of its round
  hist_fixed_finish<WIDE>(
      slo, shi, gn * 2 * Bp, Bp, sp.nrb, acc, a.done + set, ig, ih,
      [&](int i) { return sub ? a.state[lr.parent * n + entry(i)] : 0ll; },
      [&](int i, long long v, long long parent, float f) {
        const long long e = entry(i);
        const int p = (i / Bp) & 1;
        if (!STATE) {
          a.out[e] = a.scale ? __fmul_rn(f, a.scale[p]) : f;
          return;
        }
        // children (plane, child, G, Bp): plane p's left child at
        // e + p * plane, its right child at e + (p + 1) * plane
        long long left = v, right = v;
        if (sub) {
          const long long large = parent - v;
          left = lr.sil ? v : large;
          right = lr.sil ? large : v;
          a.state[lr.wa * n + e] = left;
          a.state[lr.wb * n + e] = right;
        } else if (live) {
          a.state[lr.wa * n + e] = v;
        }
        const double inv = p ? ih : ig;
        float fl = (float)((double)left * inv);
        float fr = (float)((double)right * inv);
        if (a.scale) {
          fl = __fmul_rn(fl, a.scale[p]);
          fr = __fmul_rn(fr, a.scale[p]);
        }
        a.out[e + p * plane] = fl;
        a.out[e + (p + 1) * plane] = fr;
      });
}

template <class BinT, bool WIDE>
__global__ void __launch_bounds__(HIST_THREADS, 1)
    leaf_hist_fixed(LeafArgs<BinT> a) {
  leaf_hist_body<false, WIDE>(a);
}

template <class BinT, bool WIDE>
__global__ void __launch_bounds__(HIST_THREADS, 1)
    leaf_hist_state(LeafArgs<BinT> a) {
  leaf_hist_body<true, WIDE>(a);
}

// One instantiation's launch: its grid (the wide arm's when a group's
// planes do not fit a block), its shared-memory limit raised once.
template <class BinT, bool WIDE>
static cudaError_t launch_as(const LeafArgs<BinT>& a0, long long nu_bound,
                             cudaStream_t s) {
  static int smem_fixed = 0, smem_state = 0;
  const bool st = a0.state != nullptr;
  HistGrid g;
  cudaError_t e = hist_grid(a0.G, 2, a0.Bp, nu_bound, &g, WIDE);
  if (e != cudaSuccess) return e;
  e = st ? smem_limit((const void*)leaf_hist_state<BinT, WIDE>, &smem_state,
                      g.smem)
         : smem_limit((const void*)leaf_hist_fixed<BinT, WIDE>, &smem_fixed,
                      g.smem);
  if (e != cudaSuccess) return e;
  LeafArgs<BinT> a = a0;
  a.GBL = g.GB;
  a.nsm = g.nsm;
  if (st)
    leaf_hist_state<BinT, WIDE><<<g.nblocks, HIST_THREADS, g.smem, s>>>(a);
  else
    leaf_hist_fixed<BinT, WIDE><<<g.nblocks, HIST_THREADS, g.smem, s>>>(a);
  return cudaGetLastError();
}

template <class BinT>
static cudaError_t launch_bins(const LeafArgs<BinT>& a, long long nu_bound,
                               cudaStream_t s) {
  return hist_wide(2, a.Bp) ? launch_as<BinT, true>(a, nu_bound, s)
                            : launch_as<BinT, false>(a, nu_bound, s);
}

// state == nullptr: leaf_hist_fixed into out (2, G, Bp); otherwise
// leaf_hist_state on the (slots, 2, G, Bp) state into out (2, 2, G, Bp),
// which needs kcnt > 0.  The rows, side and slots come from the step
// block; the grid from `bound`, the most rows a step may hold.
// bin_bytes is 1 for uint8 bins, 2 for uint16.
extern "C" int leaf_hist_launch(const void* bins, int R, long long Np,
                                const float* ghi, int* step, int bound,
                                const int* nl, int kcnt, const float* absmax,
                                unsigned long long* acc, unsigned* done,
                                int G, int Bp, float* out, long long* state,
                                int slots, int bin_bytes, const float* scale,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool st = state != nullptr;
  if (Bp < 16 || Bp > MAX_BP || Bp % 16 || G < 1 || G > R || bound < 0 ||
      bound >= (1 << 24) || Np % 16 || kcnt < 0 || step == nullptr ||
      (kcnt > 0 && kcnt < bound) || (st && (kcnt == 0 || slots < 1)) ||
      ((uintptr_t)bins | (uintptr_t)ghi) % 16)
    return (int)cudaErrorInvalidValue;
  const long long nu_bound = ((long long)bound + 30) >> 4;
  if (bin_bytes == 1) {
    const LeafArgs<uint8_t> a{(const uint8_t*)bins, Np,    R,     ghi,
                              step, bound, nl,    kcnt,  G,     0,
                              Bp,   0,     absmax, acc,  done,  out,
                              state, slots, scale};
    return (int)launch_bins(a, nu_bound, s);
  }
  if (bin_bytes == 2) {
    const LeafArgs<uint16_t> a{(const uint16_t*)bins, Np,    R,     ghi,
                               step, bound, nl,    kcnt,  G,     0,
                               Bp,   0,     absmax, acc,  done,  out,
                               state, slots, scale};
    return (int)launch_bins(a, nu_bound, s);
  }
  return (int)cudaErrorInvalidValue;
}
