// Fused requantizing MVM, with an optional scaleAndAdd epilogue, for a 4- or
// 8-bit matrix A times a 4- or 8-bit vector x: modes 4x4 (4-bit output),
// 4x8 and 8x8 (8-bit output).
//
// Replaces clover_tpu/kernels/mvm.py mvm_pallas and mvm_axpy_pallas (bodies
// _kernel_4x4, _kernel_4x4_i4, _kernel_4x8 and _kernel_8x8, epilogues
// _requant_write and _requant_axpy_write):
//
//   y   = A x                       exact int32 dot per (row, 64-block),
//                                   times (sA/qA)*(sx/qx) in f32, summed
//   q1  = band-requant(y)           absmax, SR, per 64-row band, qmax qO
//   out = q1                                          (mvm)
//   out = band-requant(u*(us/qO) + alpha*(q1*(s1/qO)))  (mvm_axpy)
//
// with qA, qx, qO = 7 for 4 bits and 127 for 8 bits.  The intermediate q1 is
// always formed, never skipped.  The scale combine is (sA/qA)*(sx/qx), the
// order of the XLA path (clover_tpu/ops/mvm.py); the TPU kernels'
// sA*sx*(1/(qA*qx)) rounds differently, within the 1-LSB contract.
//
// Bound: device memory.  Each matrix byte is read once (two int8
// multiply-adds for a packed 4-bit byte, one for an 8-bit byte).  Design: one
// CTA per 64-row band, 8 warps x 8 rows.  Per 512-byte chunk of a row, a
// group of lanes owns one 64-element block, each lane 16 bytes (one uint4):
// a lane pair for a 32-byte packed 4-bit block, a lane quad for a 64-byte
// 8-bit block.  Packed nibbles unpack with byte-SIMD ops into signed int8x4
// words; __dp4a takes them (and 8-bit bytes as they are) against x's int8x4
// words, and shuffles within the group join the block's exact dot.  4x8: the
// low nibbles of a block's byte j dot x[64b + j], the high nibbles
// x[64b + 32 + j], so a lane of the pair reads both 16-byte runs of x.  A warp
// walks its 8 rows together, so every chunk keeps 8 independent 16-byte loads
// in flight per lane and reads x once.  Hopper has no int4 tensor-core path
// and a GEMV has nothing to reuse, so no tensor core is used.  Known limit:
// m_pad/64 CTAs, 128 on the 8192-row leg, fewer than the 132 SMs.
//
// Summation order, mirrored op for op by the plain version
// (clover_tpu_torch/kernels/mvm.py blocked_sum): with G = 16 groups per warp
// (4-bit A) or 8 (8-bit A), group g adds the products of blocks g, g + G,
// g + 2G, ... in that order, starting from 0; then the G group sums reduce
// as (g, g ^ G/2), (g, g ^ G/4), ..., (g, g ^ 1).
#include "mvm.cuh"

namespace clover {

// One CTA per 64-row band; the band's body is mvm_band (mvm.cuh), which the
// whole-iteration kernels (iteration.cu) run too.
template <int BA, int BX>
__global__ void __launch_bounds__(MV_THREADS)
mvm_kernel(const int8_t* __restrict__ a, const float* __restrict__ a_scales,
           const int8_t* __restrict__ x, const float* __restrict__ x_scales,
           const int8_t* __restrict__ u, const float* __restrict__ u_scales,
           float alpha, int8_t* __restrict__ out,
           float* __restrict__ out_scales, int64_t n_pad, int noise1,
           uint32_t seed1, int noise2, uint32_t seed2) {
  mvm_band<BA, BX, false>(blockIdx.x, a, a_scales, x, x_scales, u, u_scales,
                          alpha, out, out_scales, n_pad, noise1, seed1,
                          noise2, seed2);
}

}  // namespace clover

extern "C" int clover_mvm(const int8_t* a, const float* a_scales,
                          const int8_t* x, const float* x_scales,
                          const int8_t* u, const float* u_scales, float alpha,
                          int8_t* out, float* out_scales, int64_t m_pad,
                          int64_t n_pad, int bits_a, int bits_x, int noise1,
                          uint32_t seed1, int noise2, uint32_t seed2,
                          void* stream) {
  const unsigned grid = (unsigned)(m_pad / 64);
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int T = clover::MV_THREADS;
  if (bits_a == 4 && bits_x == 4)
    clover::mvm_kernel<4, 4><<<grid, T, 0, s>>>(
        a, a_scales, x, x_scales, u, u_scales, alpha, out, out_scales, n_pad,
        noise1, seed1, noise2, seed2);
  else if (bits_a == 4 && bits_x == 8)
    clover::mvm_kernel<4, 8><<<grid, T, 0, s>>>(
        a, a_scales, x, x_scales, u, u_scales, alpha, out, out_scales, n_pad,
        noise1, seed1, noise2, seed2);
  else if (bits_a == 8 && bits_x == 8)
    clover::mvm_kernel<8, 8><<<grid, T, 0, s>>>(
        a, a_scales, x, x_scales, u, u_scales, alpha, out, out_scales, n_pad,
        noise1, seed1, noise2, seed2);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
