// Vector restore: f32 value = code * (s / qmax) per 64-element block, for a
// 4- or 8-bit vector.
//
// Replaces clover_tpu/kernels/restore.py _rvec_kernel (restore_vec_pallas).
//
// Op order of restore_vec_pallas and ops/_core.py expand_vec_scales: the
// multiplier s / qmax is divided first (IEEE, once per block), then one
// product per element, so the values are bit-identical to the plain version
// and to clover_tpu.  The TPU kernel's indicator-matmul scale expansion and
// AND-only nibble planes were Mosaic workarounds; here a lane reads its code.
//
// Bound: 4 bytes written per element.  At the traced solver's n = 16384 that
// is 64 KB, so the time is the launch, not bandwidth.  Design: a warp per
// 64-element block, as the quantize kernel; lane j reads byte j of the block
// (4-bit: elements j and j + 32 in its two nibbles; 8-bit: bytes j and
// j + 32) and writes elements 64b + j and 64b + j + 32, two coalesced
// 128-byte stores per warp.
#include "common.cuh"

namespace clover {

__global__ void __launch_bounds__(256)
restore_vec_kernel(const int8_t* __restrict__ codes,
                   const float* __restrict__ scales, float* __restrict__ out,
                   int64_t nb, int bits) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= nb) return;  // uniform across the warp
  const float mult = scales[b] / (bits == 4 ? 7.0f : 127.0f);
  int c0, c1;
  if (bits == 4) {
    const int p = codes[b * 32 + lane];
    c0 = low_code(p);
    c1 = high_code(p);
  } else {
    c0 = codes[b * 64 + lane];
    c1 = codes[b * 64 + 32 + lane];
  }
  out[b * 64 + lane] = (float)c0 * mult;
  out[b * 64 + 32 + lane] = (float)c1 * mult;
}

}  // namespace clover

extern "C" int clover_restore_vec(const int8_t* codes, const float* scales,
                                  float* out, int64_t n_pad, int bits,
                                  void* stream) {
  const int64_t nb = n_pad / 64;
  const unsigned grid = (unsigned)((nb + 7) / 8);
  clover::restore_vec_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      codes, scales, out, nb, bits);
  return (int)cudaGetLastError();
}
