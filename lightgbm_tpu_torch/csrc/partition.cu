// Leaf partition on Hopper: the stable two-way partition of one leaf's
// rows, in place.
//
// Replaces the TPU kernel partition_leaf_pallas
// (lightgbm_tpu/ops/partition_pallas.py); its plain PyTorch version is
// partition_leaf_plain in lightgbm_tpu_torch/ops/partition.py.  The
// contract: the leaf range [start, start + cnt) of the (R, Np) bin rows
// (uint8, or uint16 when a group has more than 256 bins: the two
// instantiations of csrc/partition.cuh) and of all eight (8, Np) 32-bit
// payload rows (moved as raw words: row 2 holds row ids, rows 3.. the fused
// step's score and objective rows) ends with the rows going left first, then
// the rows going right, each in their original order; the left count is
// written to nl_out on the device; rows outside the range are untouched; cnt
// == 0 moves nothing.  The TPU kernel's packed payload and roll-network
// compaction are its own mechanism and are not carried over.
//
// What bounds it on this card: bytes, (R * sizeof(bin) + 32) per row read and
// written once by the contract.  The design is that of csrc/partition.cuh,
// shared with the split mega-kernel: one tile pass that stages each tile with
// 16-byte asynchronous copies, orders it in shared memory and finds its place
// by a decoupled look-back, writing the lefts in place and the rights to
// scratch, then a vectorised copy-back of the rights -- two launches, (2 + 2 r
// / cnt) (R + 32) bytes per row for r rights.  The leaf comes from the step
// block on the device (csrc/step.cuh), and both grids from `bound`, the most
// rows a step may hold, so a captured CUDA graph replays the launch for
// whatever leaf the step block names.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

// bin_bytes picks the instantiation: 1 for uint8 bins, 2 for uint16
// (the dataset's dtype once a group has more than 256 bins); ncat is the
// word count of the step block's set.
template <class BinT>
static int launch_as(void* bins, int R, long long Np, uint32_t* ghi,
                     int* step, int bound, int* nl_out,
                     unsigned long long* status, unsigned* ticket,
                     unsigned* epoch, int T, void* sbins, uint32_t* sghi,
                     long long scap, int ncat, void* stream) {
  const PartArgs<BinT> a{(BinT*)bins, ghi,    Np,     R,
                         step,        bound,  T,      status,
                         ticket,      epoch,  nl_out, (BinT*)sbins,
                         sghi,        scap,   ncat};
  if (!part_args_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)partition_phases(a, (cudaStream_t)stream);
}

extern "C" int partition_launch(void* bins, int R, long long Np,
                                uint32_t* ghi, int* step, int bound,
                                int* nl_out, unsigned long long* status,
                                unsigned* ticket, unsigned* epoch, int T,
                                void* sbins, uint32_t* sghi, long long scap,
                                int bin_bytes, int ncat, void* stream) {
  if (bin_bytes == 1)
    return launch_as<uint8_t>(bins, R, Np, ghi, step, bound, nl_out, status,
                              ticket, epoch, T, sbins, sghi, scap, ncat,
                              stream);
  if (bin_bytes == 2)
    return launch_as<uint16_t>(bins, R, Np, ghi, step, bound, nl_out,
                               status, ticket, epoch, T, sbins, sghi, scap,
                               ncat, stream);
  return (int)cudaErrorInvalidValue;
}
