// Fused requantizing 4-bit MVM, with an optional scaleAndAdd epilogue.
//
// Replaces clover_tpu/kernels/mvm.py mvm_pallas and mvm_axpy_pallas in 4x4
// mode (bodies _kernel_4x4 and _kernel_4x4_i4, epilogues _requant_write and
// _requant_axpy_write):
//
//   y   = A x                       exact int32 dot per (row, 64-block),
//                                   times (sA/7)*(sx/7) in f32, summed
//   q1  = band-requant(y)           absmax, SR, per 64-row band
//   out = q1                                        (mvm)
//   out = band-requant(u*(us/7) + alpha*(q1*(s1/7)))  (mvm_axpy)
//
// The intermediate q1 is always formed, never skipped.
//
// Bound: device memory.  Each packed matrix byte is read once (two codes, two
// int8 multiply-adds).  Design: one CTA per 64-row band, 8 warps x 8 rows.  A
// lane pair owns one 32-byte block of a row per 512-byte chunk, each lane 16
// bytes (one uint4); the nibbles of A and of x unpack with byte-SIMD ops into
// signed int8x4 words for __dp4a, and one shuffle joins the two halves into
// the block's exact dot.  A warp walks its 8 rows together, so every chunk
// keeps 8 independent 16-byte loads in flight per lane and unpacks x once.
// Hopper has no int4 tensor-core path and a GEMV has nothing to reuse, so no
// tensor core is used.  Known limit: m_pad/64 CTAs, 128 on the 8192-row leg,
// fewer than the 132 SMs.
//
// Summation order, mirrored op for op by the plain version
// (clover_tpu_torch/kernels/mvm.py _blocked_sum): lane pair p adds the
// products of blocks p, p + 16, p + 32, ... in that order, starting from
// 0; then the 16 pair sums reduce as (p, p^8), (p, p^4), (p, p^2), (p, p^1).
#include "common.cuh"

namespace clover {

constexpr int MV_WARPS = 8;
constexpr int MV_ROWS = 64 / MV_WARPS;  // rows per warp
constexpr int MV_CHUNK = 512;           // bytes of a row per warp step

// Packed word of 4 bytes -> (low codes, high codes) as signed int8x4.
__device__ __forceinline__ void unpack_word(uint32_t w, int& lo, int& hi) {
  lo = (int)__vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
  hi = (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__global__ void __launch_bounds__(256)
mvm4_kernel(const int8_t* __restrict__ a, const float* __restrict__ a_scales,
            const int8_t* __restrict__ x, const float* __restrict__ x_scales,
            const int8_t* __restrict__ u, const float* __restrict__ u_scales,
            float alpha, int8_t* __restrict__ out,
            float* __restrict__ out_scales, int64_t n_pad, int noise1,
            uint32_t seed1, int noise2, uint32_t seed2) {
  __shared__ float ys[64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t band = blockIdx.x;
  const int64_t wa = n_pad / 2, nb = n_pad / 64;
  const int half = lane & 1, pair = lane >> 1;
  const int8_t* rows = a + (band * 64 + warp * MV_ROWS) * wa;
  const float* band_scales = a_scales + band * nb;

  float acc[MV_ROWS];
#pragma unroll
  for (int r = 0; r < MV_ROWS; ++r) acc[r] = 0.0f;

  for (int64_t c = 0; c * MV_CHUNK < wa; ++c) {
    const int64_t b = c * 16 + pair;
    const bool valid = b < nb;
    const int64_t off = b * 32 + half * 16;
    uint4 xw = make_uint4(0u, 0u, 0u, 0u);
    float comb = 0.0f;
    if (valid) {
      xw = *reinterpret_cast<const uint4*>(x + off);
      comb = (band_scales[b] / 7.0f) * (x_scales[b] / 7.0f);
    }
    int xl[4], xh[4];
    unpack_word(xw.x, xl[0], xh[0]);
    unpack_word(xw.y, xl[1], xh[1]);
    unpack_word(xw.z, xl[2], xh[2]);
    unpack_word(xw.w, xl[3], xh[3]);
    uint4 aw[MV_ROWS];
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r)
      aw[r] = valid ? *reinterpret_cast<const uint4*>(rows + r * wa + off)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) {
      int al, ah, d = 0;
      unpack_word(aw[r].x, al, ah);
      d = __dp4a(al, xl[0], d);
      d = __dp4a(ah, xh[0], d);
      unpack_word(aw[r].y, al, ah);
      d = __dp4a(al, xl[1], d);
      d = __dp4a(ah, xh[1], d);
      unpack_word(aw[r].z, al, ah);
      d = __dp4a(al, xl[2], d);
      d = __dp4a(ah, xh[2], d);
      unpack_word(aw[r].w, al, ah);
      d = __dp4a(al, xl[3], d);
      d = __dp4a(ah, xh[3], d);
      d += __shfl_xor_sync(FULL_MASK, d, 1);  // the block's exact dot
      acc[r] = acc[r] + comb * (float)d;      // both lanes of the pair alike
    }
  }

#pragma unroll
  for (int r = 0; r < MV_ROWS; ++r) {
    float v = acc[r];
    v = v + __shfl_xor_sync(FULL_MASK, v, 16);
    v = v + __shfl_xor_sync(FULL_MASK, v, 8);
    v = v + __shfl_xor_sync(FULL_MASK, v, 4);
    v = v + __shfl_xor_sync(FULL_MASK, v, 2);
    if (lane == 0) ys[warp * MV_ROWS + r] = v;
  }
  __syncthreads();
  if (warp != 0) return;

  // band requant: lane j holds band rows j and j + 32, the two nibbles of
  // output byte j
  const int64_t i0 = band * 64 + lane, i1 = i0 + 32;
  const float y0 = ys[lane], y1 = ys[lane + 32];
  const float s1 = nonzero_scale(warp_max(fmaxf(fabsf(y0), fabsf(y1))));
  const float mult1 = 7.0f / s1;
  int q0 = sr_code(y0, mult1, 7.0f, sr_noise(noise1, seed1, i0, 0));
  int q1 = sr_code(y1, mult1, 7.0f, sr_noise(noise1, seed1, i1, 0));
  float s_out = s1;
  if (u != nullptr) {
    // scaleAndAdd in the op order of clover_tpu/ops/axpy.py:
    // restore(u) + alpha * restore(q1), then a second band requant
    const int p = u[band * 32 + lane];
    const float um = u_scales[band] / 7.0f;
    const float tm = s1 / 7.0f;
    const float x0 = (float)low_code(p) * um + alpha * ((float)q0 * tm);
    const float x1 = (float)high_code(p) * um + alpha * ((float)q1 * tm);
    const float s2 = nonzero_scale(warp_max(fmaxf(fabsf(x0), fabsf(x1))));
    const float mult2 = 7.0f / s2;
    q0 = sr_code(x0, mult2, 7.0f, sr_noise(noise2, seed2, i0, 1));
    q1 = sr_code(x1, mult2, 7.0f, sr_noise(noise2, seed2, i1, 1));
    s_out = s2;
  }
  out[band * 32 + lane] = pack_byte(q0, q1);
  if (lane == 0) out_scales[band] = s_out;
}

}  // namespace clover

extern "C" int clover_mvm4(const int8_t* a, const float* a_scales,
                           const int8_t* x, const float* x_scales,
                           const int8_t* u, const float* u_scales, float alpha,
                           int8_t* out, float* out_scales, int64_t m_pad,
                           int64_t n_pad, int noise1, uint32_t seed1,
                           int noise2, uint32_t seed2, void* stream) {
  clover::mvm4_kernel<<<(unsigned)(m_pad / 64), 256, 0, (cudaStream_t)stream>>>(
      a, a_scales, x, x_scales, u, u_scales, alpha, out, out_scales, n_pad,
      noise1, seed1, noise2, seed2);
  return (int)cudaGetLastError();
}
