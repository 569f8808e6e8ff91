// Philox4x32-10 counter-based generator: the stochastic-rounding noise of
// every kernel in this directory.  The torch integer-op version in
// clover_tpu_torch/kernels/philox.py gives the same bits.
//
// key     = (seed, 0), seed the op's int32 seed read as uint32
// counter = (index mod 2^32, index >> 32, leg, 0), index the element's
//           global index in the padded operand, leg 0 for a quantize or
//           MVM output, 1 for an AXPY output
// u       = (word0 & 0xFFFFFF) * 2^-24, the 24-bit recipe of the TPU
//           kernels (clover_tpu/kernels/mvm.py _unoise)
//
// The noise of an element depends only on (seed, index, leg), never on the
// launch geometry.
#pragma once
#include <stdint.h>

namespace clover {

__device__ __forceinline__ uint32_t philox_word0(uint32_t seed, uint64_t index,
                                                 uint32_t leg) {
  uint32_t c0 = (uint32_t)index, c1 = (uint32_t)(index >> 32), c2 = leg, c3 = 0;
  uint32_t k0 = seed, k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// U[0,1) noise, or exactly 0 when stochastic rounding is off.
__device__ __forceinline__ float sr_noise(int noise, uint32_t seed,
                                          uint64_t index, uint32_t leg) {
  if (!noise) return 0.0f;
  return (float)(philox_word0(seed, index, leg) & 0xFFFFFFu) *
         (1.0f / 16777216.0f);
}

}  // namespace clover
