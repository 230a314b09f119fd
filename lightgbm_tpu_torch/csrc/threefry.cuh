// JAX's random draw on Hopper: Threefry-2x32 (20 rounds) of a key over
// the counter (0, i), the two words xor-ed, and the uniform f32 of those
// bits, as lightgbm_tpu_torch/utils/random.py computes them
// (``torch_random_bits_at``, ``torch_uniform_at``).  Shared by the
// sampling pass (csrc/sample.cu) and the discretizer (csrc/quantize.cu).
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of (k0, k1) over the counter (0, i), the two words xor-ed
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = 0u + ks[0], b = i + ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl(b, rot[r & 1][j]) ^ a;
    }
    a += ks[(r + 1) % 3];
    b += ks[(r + 2) % 3] + (uint32_t)(r + 1);
  }
  return a ^ b;
}

__device__ __forceinline__ float bits_uniform(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(0.0f, f);
}
