// The row sums and the band epilogue of the fused MVM (mvm.cu gives the
// math, the summation order and the design), shared by mvm.cu's kernels
// and both iteration kernels (iteration.cu): a warp's R rows walked in the
// order of mvm.cu's note through a ring of registers, so every kernel gives
// a row the same f32 sum.
#pragma once
#include "mvm.cuh"

namespace clover {

// The launch's operands (the requant kernel's; the f32 mode reads a, x,
// their scales, n_pad and out_f32).
struct MvmArgs {
  const int8_t* a;
  const float* a_scales;
  const int8_t* x;
  const float* x_scales;
  const int8_t* u;
  const float* u_scales;
  float alpha;
  int8_t* out;
  float* out_scales;
  float* out_f32;
  int64_t n_pad;
  int noise1;
  uint32_t seed1;
  int noise2;
  uint32_t seed2;
};

// d = c + sum a_i * b_i over the 4 bytes, a unsigned and b signed.
__device__ __forceinline__ int dp4a_us(uint32_t a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The signed int8x4 codes of a packed word's low and high nibbles
// (formats.py: a low nibble is its code + 8, a high nibble its code in
// 4-bit two's complement): a nibble v + 0x78 stays below 0x100 in every
// byte, and ^ 0x80 recentres it (low: v - 8; high: the 4-bit two's
// complement of v, rebased the same way after ^ 8).
__device__ __forceinline__ int low_codes(uint32_t w) {
  return (int)(((w & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u);
}
__device__ __forceinline__ int high_codes(uint32_t w) {
  return (int)(((((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^
               0x80808080u);
}

// Loads that stay where they are written (volatile: the compiler neither
// sinks a prefetch towards its use nor drops it), zeros when !valid: A
// streamed (ld.global.cs, touched once), x and the scales through the
// read-only path (every warp of a CTA reads them).
__device__ __forceinline__ uint4 ld_stream(const int8_t* p, bool valid) {
  uint4 v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %5, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  mov.b32 %1, 0;\n"
      "  mov.b32 %2, 0;\n"
      "  mov.b32 %3, 0;\n"
      "  @q ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      "}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"((int)valid));
  return v;
}
__device__ __forceinline__ uint4 ld_ro(const int8_t* p, bool valid) {
  uint4 v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %5, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  mov.b32 %1, 0;\n"
      "  mov.b32 %2, 0;\n"
      "  mov.b32 %3, 0;\n"
      "  @q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      "}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"((int)valid));
  return v;
}
__device__ __forceinline__ float ld_ro(const float* p, bool valid) {
  float v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %2, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  @q ld.global.nc.f32 %0, [%1];\n"
      "}\n"
      : "=f"(v)
      : "l"(p), "r"((int)valid));
  return v;
}

// This lane's exact share of a block dot: its 16 bytes of A against the x
// words xl (A's low codes, or its 8-bit codes) and xh (A's high codes).
// bias = -8 * (the sum of xl's bytes) when A is 4-bit.
template <int BA>
__device__ __forceinline__ int lane_dot(const uint4& w, const int (&xl)[4],
                                        const int (&xh)[4], int bias) {
  if constexpr (BA == 4) {
    int lo = bias, hi = 0;
    lo = dp4a_us(w.x & 0x0F0F0F0Fu, xl[0], lo);
    hi = __dp4a((int)(w.x & 0xF0F0F0F0u), xh[0], hi);
    lo = dp4a_us(w.y & 0x0F0F0F0Fu, xl[1], lo);
    hi = __dp4a((int)(w.y & 0xF0F0F0F0u), xh[1], hi);
    lo = dp4a_us(w.z & 0x0F0F0F0Fu, xl[2], lo);
    hi = __dp4a((int)(w.z & 0xF0F0F0F0u), xh[2], hi);
    lo = dp4a_us(w.w & 0x0F0F0F0Fu, xl[3], lo);
    hi = __dp4a((int)(w.w & 0xF0F0F0F0u), xh[3], hi);
    return lo + (hi >> 4);  // hi is a multiple of 16: the shift is exact
  } else {
    int d = 0;
    d = __dp4a((int)w.x, xl[0], d);
    d = __dp4a((int)w.y, xl[1], d);
    d = __dp4a((int)w.z, xl[2], d);
    d = __dp4a((int)w.w, xl[3], d);
    return d;
  }
}

// Chunks of a row in flight per warp: PA of A (R rows each), PX of x.
template <int R>
struct Depth {
  static constexpr int PA = R == 2 ? 4 : 2;
  static constexpr int PX = PA;
};

// The loads of row_sums in mvm.cu: A streamed (touched once), x and the
// scales through the read-only path.
struct StreamLoads {
  static __device__ __forceinline__ uint4 a(const int8_t* p, bool valid) {
    return ld_stream(p, valid);
  }
  static __device__ __forceinline__ uint4 x(const int8_t* p, bool valid) {
    return ld_ro(p, valid);
  }
  static __device__ __forceinline__ float sa(const float* p, bool valid) {
    return ld_ro(p, valid);
  }
  static __device__ __forceinline__ float sx(const float* p, bool valid) {
    return ld_ro(p, valid);
  }
};

// The f32 sums of R consecutive rows of A (``rows`` is the first; the
// band's scales at ``band_scales``) against x, one warp, in the order of
// mvm.cu's source note: v[r] is the same in every lane.  L gives the
// loads: A (L::a), x (L::x) and their scales (L::sa, L::sx), each a
// volatile asm returning zeros when !valid; PA chunks of A and of x are in
// flight.
template <int BA, int BX, int R, class L = StreamLoads,
          int PA = Depth<R>::PA>
__device__ __forceinline__ void row_sums(const int8_t* __restrict__ rows,
                                         const float* __restrict__ band_scales,
                                         const int8_t* __restrict__ x,
                                         const float* __restrict__ x_scales,
                                         int64_t n_pad, float (&v)[R]) {
  constexpr float QA = BA == 4 ? 7.0f : 127.0f;
  constexpr float QX = BX == 4 ? 7.0f : 127.0f;
  constexpr int LANES = BA == 4 ? 2 : 4;  // lanes sharing one block of A
  constexpr int GROUPS = 32 / LANES;      // blocks per warp per chunk
  constexpr int A_BLOCK = 8 * BA;         // bytes of one 64-element block
  constexpr int XW = (BA == 4 && BX == 8) ? 2 : 1;  // uint4 of x per lane
  constexpr int64_t X_CHUNK = BX == 4 ? MV_CHUNK : GROUPS * 64;
  constexpr int PX = PA;
  const int lane = threadIdx.x & 31;
  const int part = lane & (LANES - 1), group = lane / LANES;
  const int64_t wa = n_pad * BA / 8, nb = n_pad / 64;
  const int64_t nch = (wa + MV_CHUNK - 1) / MV_CHUNK;
  // this lane's bytes of chunk 0: A's 16 (block ``group``), and x's -- packed
  // like A's (4x4), or the 8-bit elements 64 group + 16 part ... (the low
  // nibbles' partners when A is 4-bit) and, for 4x8, the high nibbles'
  // partners 32 bytes on
  const int8_t* ap = rows + group * A_BLOCK + part * 16;
  const int8_t* xp = x + (BX == 4 ? group * A_BLOCK : group * 64) + part * 16;
  uint4 aw[PA][R];
  uint4 xw[PX][XW];
  float sa[PX], sx[PX];
  // Loads of chunk c into the rings (zeros past the row's last block, which
  // add exactly +0 below).
  auto load_a = [&](uint4(&dst)[R], int64_t c) {
    const bool valid = c * GROUPS + group < nb;
#pragma unroll
    for (int r = 0; r < R; ++r)
      dst[r] = L::a(ap + r * wa + c * MV_CHUNK, valid);
  };
  auto load_x = [&](uint4(&dst)[XW], float& s_a, float& s_x, int64_t c) {
    const int64_t b = c * GROUPS + group;
    const bool valid = b < nb;
    dst[0] = L::x(xp + c * X_CHUNK, valid);
    if constexpr (XW == 2) dst[1] = L::x(xp + c * X_CHUNK + 32, valid);
    s_a = L::sa(band_scales + b, valid);
    s_x = L::sx(x_scales + b, valid);
  };

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int s = 0; s < PA - 1; ++s) load_a(aw[s], s);
#pragma unroll
  for (int s = 0; s < PX - 1; ++s) load_x(xw[s], sa[s], sx[s], s);

  for (int64_t c0 = 0; c0 < nch; c0 += PA) {
#pragma unroll
    for (int s = 0; s < PA; ++s) {
      const int64_t c = c0 + s;
      load_a(aw[(s + PA - 1) % PA], c + PA - 1);
      load_x(xw[(s + PX - 1) % PX], sa[(s + PX - 1) % PX],
             sx[(s + PX - 1) % PX], c + PX - 1);
      if (c < nch) {
        const int k = s % PX;
        // (0 / qA) * (0 / qX) = +0 past the last block
        const float comb = (sa[k] / QA) * (sx[k] / QX);
        int xl[4], xh[4], bias = 0;
        if constexpr (BX == 4) {
          xl[0] = low_codes(xw[k][0].x);
          xh[0] = high_codes(xw[k][0].x);
          xl[1] = low_codes(xw[k][0].y);
          xh[1] = high_codes(xw[k][0].y);
          xl[2] = low_codes(xw[k][0].z);
          xh[2] = high_codes(xw[k][0].z);
          xl[3] = low_codes(xw[k][0].w);
          xh[3] = high_codes(xw[k][0].w);
        } else {
          xl[0] = (int)xw[k][0].x;
          xl[1] = (int)xw[k][0].y;
          xl[2] = (int)xw[k][0].z;
          xl[3] = (int)xw[k][0].w;
          xh[0] = xh[1] = xh[2] = xh[3] = 0;
          if constexpr (XW == 2) {
            xh[0] = (int)xw[k][1].x;
            xh[1] = (int)xw[k][1].y;
            xh[2] = (int)xw[k][1].z;
            xh[3] = (int)xw[k][1].w;
          }
        }
        if constexpr (BA == 4) {
          constexpr int MINUS8 = (int)0xF8F8F8F8u;  // -8 in every byte
          bias = __dp4a(xl[0], MINUS8, bias);
          bias = __dp4a(xl[1], MINUS8, bias);
          bias = __dp4a(xl[2], MINUS8, bias);
          bias = __dp4a(xl[3], MINUS8, bias);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          int d = lane_dot<BA>(aw[s][r], xl, xh, bias);
#pragma unroll
          for (int o = 1; o < LANES; o <<= 1)
            d += __shfl_xor_sync(FULL_MASK, d, o);  // the block's exact dot
          acc[r] = acc[r] + comb * (float)d;       // every lane of the group
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    float w = acc[r];
#pragma unroll
    for (int o = 16; o >= LANES; o >>= 1)
      w = w + __shfl_xor_sync(FULL_MASK, w, o);
    v[r] = w;
  }
}

// The band requant and scaleAndAdd epilogue of the fused MVM (mvm.cu's
// note), run by one warp on the band's 64 row sums ys.
template <int BA, int BX>
__device__ __forceinline__ void band_epilogue(int64_t band, const float* ys,
                                              const MvmArgs p) {
  constexpr int BO = (BA == 4 && BX == 4) ? 4 : 8;  // output bits
  constexpr float QO = BO == 4 ? 7.0f : 127.0f;
  const int lane = threadIdx.x & 31;
  // lane j holds band rows j and j + 32 (the two nibbles of output byte j
  // when the output is 4-bit)
  const int64_t i0 = band * 64 + lane, i1 = i0 + 32;
  const float y0 = ys[lane], y1 = ys[lane + 32];
  const float s1 = nonzero_scale(warp_max(fmaxf(fabsf(y0), fabsf(y1))));
  const float mult1 = QO / s1;
  int q0 = sr_code(y0, mult1, QO, sr_noise(p.noise1, p.seed1, i0, 0));
  int q1 = sr_code(y1, mult1, QO, sr_noise(p.noise1, p.seed1, i1, 0));
  float s_out = s1;
  if (p.u != nullptr) {
    // scaleAndAdd in the op order of clover_tpu/ops/axpy.py:
    // restore(u) + alpha * restore(q1), then a second band requant
    int u0, u1;
    if constexpr (BO == 4) {
      const int b = p.u[band * 32 + lane];
      u0 = low_code(b);
      u1 = high_code(b);
    } else {
      u0 = p.u[i0];
      u1 = p.u[i1];
    }
    const float um = p.u_scales[band] / QO;
    const float tm = s1 / QO;
    const float x0 = (float)u0 * um + p.alpha * ((float)q0 * tm);
    const float x1 = (float)u1 * um + p.alpha * ((float)q1 * tm);
    const float s2 = nonzero_scale(warp_max(fmaxf(fabsf(x0), fabsf(x1))));
    const float mult2 = QO / s2;
    q0 = sr_code(x0, mult2, QO, sr_noise(p.noise2, p.seed2, i0, 1));
    q1 = sr_code(x1, mult2, QO, sr_noise(p.noise2, p.seed2, i1, 1));
    s_out = s2;
  }
  if constexpr (BO == 4) {
    p.out[band * 32 + lane] = pack_byte(q0, q1);
  } else {
    p.out[i0] = (int8_t)q0;
    p.out[i1] = (int8_t)q1;
  }
  if (lane == 0) p.out_scales[band] = s_out;
}

}  // namespace clover
