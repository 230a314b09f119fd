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
// What bounds it on this card: bytes.  Each row of the leaf is read and
// written once by the contract (R bin bytes + 32 payload bytes); this
// design moves it twice (scratch, then back), since blocks that run in
// any order cannot overwrite rows another block has still to read.  The
// phases are those of csrc/partition.cuh, shared with the split
// mega-kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

extern "C" int partition_launch(uint8_t* bins, int R, long long Np,
                                uint32_t* ghi, int* tile_cnt, int ntiles,
                                int* nl_out, uint8_t* sbins, uint32_t* sghi,
                                long long scap, long long start, int cnt,
                                int col, int bstart, int isb, int nb,
                                int dbin, int mtype, int thr, int dl,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R < 1 || col < 0 || col >= R || cnt < 0 || start < 0 ||
      start + cnt > Np || (cnt > 0 && (scap < cnt ||
                                       ntiles * (long long)TILE_ROWS < cnt)))
    return (int)cudaErrorInvalidValue;
  if (cnt == 0) {
    part_set_count<<<1, 1, 0, s>>>(nl_out, 0);
    return (int)cudaGetLastError();
  }
  const SplitDecision d{col, bstart, isb, nb, dbin, mtype, thr, dl};
  partition_phases(bins, ghi, R, Np, start, cnt, d, tile_cnt, ntiles, nl_out,
                   sbins, sghi, scap, s);
  return (int)cudaGetLastError();
}
