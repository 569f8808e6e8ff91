// Geometry, nibble unpacking and the one-band body shared by the MVM
// kernels.  The single (mvm.cu), batched (mvm_batched.cu) and whole-iteration
// (iteration.cu) kernels walk a row of A in the same chunks, groups and
// lanes, so their block sums are the single kernel's, op for op.
#pragma once
#include "common.cuh"

namespace clover {

constexpr int MV_WARPS = 8;
constexpr int MV_THREADS = 32 * MV_WARPS;
constexpr int MV_ROWS = 64 / MV_WARPS;  // rows per warp
constexpr int MV_CHUNK = 512;           // bytes of a row per warp step

// Packed word of 4 bytes -> (low codes, high codes) as signed int8x4.
__device__ __forceinline__ void unpack_word(uint32_t w, int& lo, int& hi) {
  lo = (int)__vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
  hi = (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// One 64-row band of the fused requantizing MVM(+AXPY) (mvm.cu gives the
// math, the layout and the summation order), run by a CTA of MV_THREADS:
// block dots of rows band*64 ... band*64 + 63 against x, the band requant,
// and with u the scaleAndAdd epilogue.  Writes the band's 64 output codes
// and its scale.  Warps 1..7 return once their row sums are in shared
// memory; warp 0 runs the epilogue, so a caller that loops over bands
// __syncthreads() before the next band.  CG loads x, u and their scales
// through ld_cg (the cooperative kernels, where another CTA wrote them).
// With F32 (mvm.cu mvm_f32_kernel) the CTA writes the band's 64 f32 sums
// to out_f32[band*64 ...] instead and does no requant (u, out and
// out_scales unused).  The chunk loop's ``valid`` guard covers a partial
// last chunk, so any n_pad that is a multiple of 64 works.
template <int BA, int BX, bool CG, bool F32 = false>
__device__ __forceinline__ void mvm_band(
    int64_t band, const int8_t* __restrict__ a,
    const float* __restrict__ a_scales, const int8_t* __restrict__ x,
    const float* __restrict__ x_scales, const int8_t* __restrict__ u,
    const float* __restrict__ u_scales, float alpha, int8_t* __restrict__ out,
    float* __restrict__ out_scales, int64_t n_pad, int noise1, uint32_t seed1,
    int noise2, uint32_t seed2, float* __restrict__ out_f32 = nullptr) {
  constexpr int BO = (BA == 4 && BX == 4) ? 4 : 8;  // output bits
  constexpr float QA = BA == 4 ? 7.0f : 127.0f;
  constexpr float QX = BX == 4 ? 7.0f : 127.0f;
  constexpr float QO = BO == 4 ? 7.0f : 127.0f;
  constexpr int LANES = BA == 4 ? 2 : 4;  // lanes sharing one block of A
  constexpr int GROUPS = 32 / LANES;      // blocks per warp per chunk
  constexpr int A_BLOCK = 8 * BA;         // bytes of one 64-element block
  __shared__ float ys[64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t wa = n_pad * BA / 8, nb = n_pad / 64;
  const int part = lane & (LANES - 1), group = lane / LANES;
  const int8_t* rows = a + (band * 64 + warp * MV_ROWS) * wa;
  const float* band_scales = a_scales + band * nb;

  float acc[MV_ROWS];
#pragma unroll
  for (int r = 0; r < MV_ROWS; ++r) acc[r] = 0.0f;

  for (int64_t c = 0; c * MV_CHUNK < wa; ++c) {
    const int64_t b = c * GROUPS + group;
    const bool valid = b < nb;
    const int64_t off = b * A_BLOCK + part * 16;  // this lane's bytes of A
    // this lane's bytes of x: packed like A's (4x4), or 8-bit elements
    // 64b + 16 part ... (the low nibbles' partners when A is 4-bit) and,
    // for 4x8, the high nibbles' partners 32 bytes on
    const int64_t xo = BX == 4 ? off : b * 64 + part * 16;
    uint4 xa = make_uint4(0u, 0u, 0u, 0u), xb = xa;
    float comb = 0.0f;
    if (valid) {
      xa = ld<CG>(reinterpret_cast<const uint4*>(x + xo));
      if constexpr (BA == 4 && BX == 8)
        xb = ld<CG>(reinterpret_cast<const uint4*>(x + xo + 32));
      comb = (band_scales[b] / QA) * (ld<CG>(x_scales + b) / QX);
    }
    // x as int8x4 words: xl[i] meets A's word i (its low codes when A is
    // 4-bit), xh[i] the high codes of A's word i
    int xl[4], xh[4];
    if constexpr (BX == 4) {
      unpack_word(xa.x, xl[0], xh[0]);
      unpack_word(xa.y, xl[1], xh[1]);
      unpack_word(xa.z, xl[2], xh[2]);
      unpack_word(xa.w, xl[3], xh[3]);
    } else {
      xl[0] = (int)xa.x; xl[1] = (int)xa.y; xl[2] = (int)xa.z; xl[3] = (int)xa.w;
      xh[0] = (int)xb.x; xh[1] = (int)xb.y; xh[2] = (int)xb.z; xh[3] = (int)xb.w;
    }
    uint4 aw[MV_ROWS];
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r)
      aw[r] = valid ? *reinterpret_cast<const uint4*>(rows + r * wa + off)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) {
      int d = 0;
      if constexpr (BA == 4) {
        int al, ah;
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
      } else {
        d = __dp4a((int)aw[r].x, xl[0], d);
        d = __dp4a((int)aw[r].y, xl[1], d);
        d = __dp4a((int)aw[r].z, xl[2], d);
        d = __dp4a((int)aw[r].w, xl[3], d);
      }
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1)
        d += __shfl_xor_sync(FULL_MASK, d, o);  // the block's exact dot
      acc[r] = acc[r] + comb * (float)d;       // every lane of the group alike
    }
  }

#pragma unroll
  for (int r = 0; r < MV_ROWS; ++r) {
    float v = acc[r];
#pragma unroll
    for (int o = 16; o >= LANES; o >>= 1)
      v = v + __shfl_xor_sync(FULL_MASK, v, o);
    if (lane == 0) ys[warp * MV_ROWS + r] = v;
  }
  __syncthreads();
  if constexpr (F32) {
    if (threadIdx.x < 64) out_f32[band * 64 + threadIdx.x] = ys[threadIdx.x];
    return;
  }
  if (warp != 0) return;

  // band requant: lane j holds band rows j and j + 32 (the two nibbles of
  // output byte j when the output is 4-bit)
  const int64_t i0 = band * 64 + lane, i1 = i0 + 32;
  const float y0 = ys[lane], y1 = ys[lane + 32];
  const float s1 = nonzero_scale(warp_max(fmaxf(fabsf(y0), fabsf(y1))));
  const float mult1 = QO / s1;
  int q0 = sr_code(y0, mult1, QO, sr_noise(noise1, seed1, i0, 0));
  int q1 = sr_code(y1, mult1, QO, sr_noise(noise1, seed1, i1, 0));
  float s_out = s1;
  if (u != nullptr) {
    // scaleAndAdd in the op order of clover_tpu/ops/axpy.py:
    // restore(u) + alpha * restore(q1), then a second band requant
    int u0, u1;
    if constexpr (BO == 4) {
      const int p = ld<CG>(u + band * 32 + lane);
      u0 = low_code(p);
      u1 = high_code(p);
    } else {
      u0 = ld<CG>(u + i0);
      u1 = ld<CG>(u + i1);
    }
    const float um = ld<CG>(u_scales + band) / QO;
    const float tm = s1 / QO;
    const float x0 = (float)u0 * um + alpha * ((float)q0 * tm);
    const float x1 = (float)u1 * um + alpha * ((float)q1 * tm);
    const float s2 = nonzero_scale(warp_max(fmaxf(fabsf(x0), fabsf(x1))));
    const float mult2 = QO / s2;
    q0 = sr_code(x0, mult2, QO, sr_noise(noise2, seed2, i0, 1));
    q1 = sr_code(x1, mult2, QO, sr_noise(noise2, seed2, i1, 1));
    s_out = s2;
  }
  if constexpr (BO == 4) {
    out[band * 32 + lane] = pack_byte(q0, q1);
  } else {
    out[i0] = (int8_t)q0;
    out[i1] = (int8_t)q1;
  }
  if (lane == 0) out_scales[band] = s_out;
}

}  // namespace clover
