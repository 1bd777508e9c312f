// Philox4x32-10 (Salmon, Moraes, Dror, Shaw: "Parallel random numbers: as
// easy as 1, 2, 3", SC'11), the counter-based generator the collect kernels
// draw from.  gym_supplychain_tpu_torch/rng/device.py computes the same
// words on tensors; tests/test_torch_collect.py pins the known answers.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t philox_word(uint4 w, int q) {
  return q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
}

// top 23 bits under the exponent of 1.0, minus 1: a float in [0, 1)
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}
