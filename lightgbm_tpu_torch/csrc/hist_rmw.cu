// Histogram-state read-modify-write on Hopper: the parent-minus-smaller-
// child step of the histogram-subtraction split path.
//
// Replaces the TPU kernel hist_rmw_pallas
// (lightgbm_tpu/ops/hist_state_pallas.py); its plain PyTorch version is
// hist_rmw_plain in lightgbm_tpu_torch/ops/hist_state.py.  The state is
// (L+1) slots of n = 2 * G * Bp f32 (the (2, G, Bp) grad/hess planes of
// a leaf).  For idx = [parent, wa, wb, small_is_left] it reads slot
// parent and the smaller child's histogram, computes large = parent -
// small in f32, and writes left to slot wa, then right to slot wb, in
// place; wa == wb (a trash slot) ends holding the right child, as the
// serialized TPU copies leave it.  It also writes both children into
// children (2, 2, G, Bp) = (plane, child, G, Bp): children[0] and
// children[1] are the (2G, Bp) grad and hess inputs of the pair search
// (csrc/split_pair.cu), left child's rows first, with no further copy.
// The TPU kernel's (8, WL) lane flattening is a TPU tiling rule and is
// not carried over.
//
// What bounds it on this card: bytes -- two slots read, four written
// (the two state slots and the two children), one f32 subtraction per
// element.  The design is one elementwise pass: each thread owns one
// element of the slot, reads the parent before it writes wa (which may
// be the parent's slot), and writes wa before wb, so no two threads
// touch one address and the wa == wb order is the program order of one
// thread.  Compiled with --fmad=false (a lone subtraction has nothing
// to contract anyway), it is bit-identical to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void rmw_pass(float* __restrict__ state,
                         const float* __restrict__ small, long long n,
                         int gbp, int parent, int wa, int wb, int sil,
                         float* __restrict__ children) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // no __restrict__ on the state: slot wa may alias slot parent
  const float p = state[(long long)parent * n + i];
  const float sm = small[i];
  const float large = p - sm;
  const float left = sil ? sm : large;
  const float right = sil ? large : sm;
  state[(long long)wa * n + i] = left;
  state[(long long)wb * n + i] = right;
  const long long plane = i / gbp;
  const long long r = i - plane * gbp;
  children[(plane * 2) * gbp + r] = left;
  children[(plane * 2 + 1) * gbp + r] = right;
}

extern "C" int hist_rmw_launch(float* state, int slots, const float* small,
                               int G, int Bp, int parent, int wa, int wb,
                               int sil, float* children, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (G < 1 || Bp < 1 || parent < 0 || parent >= slots || wa < 0 ||
      wa >= slots || wb < 0 || wb >= slots || (sil != 0 && sil != 1))
    return (int)cudaErrorInvalidValue;
  const int gbp = G * Bp;
  const long long n = 2LL * gbp;
  rmw_pass<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      state, small, n, gbp, parent, wa, wb, sil, children);
  return (int)cudaGetLastError();
}
