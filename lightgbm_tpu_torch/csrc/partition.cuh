// The numerical split decision of the leaf partition, on the device.
//
// Same arithmetic as decide_left in lightgbm_tpu_torch/ops/partition.py
// and _decide_left in lightgbm_tpu/ops/partition_pallas.py: bundled bin
// offset, missing none/zero/NaN, default bin, threshold, default_left.
#pragma once

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
