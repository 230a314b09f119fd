// Leaf partition on Hopper: the stable two-way partition of one leaf's
// rows, in place.
//
// Replaces the TPU kernel partition_leaf_pallas
// (lightgbm_tpu/ops/partition_pallas.py); its plain PyTorch version is
// partition_leaf_plain in lightgbm_tpu_torch/ops/partition.py.  The
// contract: the leaf range [start, start + cnt) of the (R, Np) uint8 bin
// rows and of all eight (8, Np) 32-bit payload rows (moved as raw words:
// row 2 holds row ids, rows 3.. the fused step's score and objective
// rows) ends with the rows going left first, then the rows going right,
// each in their original order; the left count is written to nl_out on
// the device; rows outside the range are untouched; cnt == 0 moves
// nothing.  The TPU kernel's packed payload and roll-network compaction
// are its own mechanism and are not carried over.
//
// What bounds it on this card: bytes, (R + 32) per row read and written
// once by the contract.  The design is that of csrc/partition.cuh,
// shared with the split mega-kernel: one tile pass that stages each tile
// with 16-byte asynchronous copies, orders it in shared memory and finds
// its place by a decoupled look-back, writing the lefts in place and the
// rights to scratch, then a vectorised copy-back of the rights -- two
// launches, (2 + 2 r / cnt) (R + 32) bytes per row for r rights.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

extern "C" int partition_launch(uint8_t* bins, int R, long long Np,
                                uint32_t* ghi, int* nl_out,
                                unsigned long long* status, unsigned* ticket,
                                unsigned epoch, int T, int ntiles,
                                uint8_t* sbins, uint32_t* sghi,
                                long long scap, long long start, int cnt,
                                int col, int bstart, int isb, int nb,
                                int dbin, int mtype, int thr, int dl,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cnt == 0) {
    if (R < 1 || col < 0 || col >= R || start < 0 || start > Np)
      return (int)cudaErrorInvalidValue;
    part_set_count<<<1, 1, 0, s>>>(nl_out, 0);
    return (int)cudaGetLastError();
  }
  const PartArgs a{bins, ghi, Np, R, start, cnt,
                   SplitDecision{col, bstart, isb, nb, dbin, mtype, thr, dl},
                   T, ntiles, status, ticket, epoch, nl_out, sbins, sghi,
                   scap};
  if (!part_args_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)partition_phases(a, s);
}
