// Fused requantizing MVM, with an optional scaleAndAdd epilogue, for a 4- or
// 8-bit matrix A times a 4- or 8-bit vector x: modes 4x4 (4-bit output),
// 4x8 and 8x8 (8-bit output); and its f32-output mode.
//
// Replaces clover_tpu/kernels/mvm.py mvm_pallas and mvm_axpy_pallas (bodies
// _kernel_4x4, _kernel_4x4_i4, _kernel_4x8 and _kernel_8x8, epilogues
// _requant_write and _requant_axpy_write), and mvm_pallas_f32 (the same
// bodies, _build_call with out_bits 32): mvm_f32_kernel writes the 64 f32
// sums y of a band and no codes, for the sharded path, which sums the
// shards' partials before the band requant (clover_tpu/parallel/ops.py
// mvm_psum):
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
// Summation order, mirrored op for op by the plain version
// (clover_tpu_torch/kernels/mvm.py blocked_sum): a row of A is walked by one
// warp in 512-byte chunks; per chunk a group of lanes owns one 64-element
// block, each lane 16 bytes (a lane pair for a 32-byte packed 4-bit block,
// a lane quad for a 64-byte 8-bit block), so G = 16 groups (4-bit A) or 8.
// Group g adds the products of blocks g, g + G, g + 2G, ... in that order,
// starting from 0; then the G group sums reduce as (g, g ^ G/2),
// (g, g ^ G/4), ..., (g, g ^ 1).  The whole-iteration and batched kernels
// (mvm.cuh mvm_band, mvm_batched.cu) keep the same order, so every kernel
// gives a row the same f32 sum.
//
// Bound: device memory.  Each matrix byte is read once; x (at most 512 KB)
// and the scales are re-read from L1/L2.  The design keeps enough bytes of
// A in flight on every SM at every m:
//   - Rows, not the reduction, are split across CTAs.  A 64-row band is
//     shared by a thread-block cluster of C = 8 / R CTAs, each of 8 warps x
//     R rows (R = 2, 4 or 8; kernels/mvm.py rows_per_warp takes the most
//     rows per warp that still gives every SM a CTA, the fastest geometry
//     at every shape kernel_ab.py --rows times: R = 2 at m = 2048, 128
//     CTAs where the parent had 32; R = 4 at m = 8192, 256 CTAs).  Each
//     CTA stores its 8R row sums into the cluster leader's ys[64] through
//     distributed shared memory, then a cluster barrier; the leader's warp
//     0 runs the band requant and the AXPY epilogue as mvm_band does.  The
//     f32 mode needs no cluster: each warp stores its own sums.
//   - Split-K (a row's chunks over several CTAs) was not taken: it changes
//     the order in which a row's blocks are added, and with it the bits of
//     y, which the plain versions, the batched kernel and the
//     whole-iteration kernels all share.  A row split keeps each row's
//     order as it is.
//   - Each warp streams its R rows through a ring of registers PA chunks
//     deep (PA = 4 for R = 2, else 2): the loads of chunk c + PA - 1 are
//     issued before chunk c is consumed, so (PA - 1) * R * 512 bytes of A
//     per warp stay in flight while the warp computes, 24-32 KB per SM; x
//     and the scales run as far ahead.  A is read with ld.global.cs
//     (streamed: it is touched once), x through the read-only path, each
//     load a volatile asm so that no prefetch is moved towards its use.
//   - The block dot needs no unpacking of A: for 4-bit A,
//       sum lo*xl + hi*xh = dp4a_us(w & 0x0F0F0F0F, xl) - 8 sum xl
//                           + dp4a(w & 0xF0F0F0F0, xh) / 16
//     since a low nibble is its code + 8 and a masked high nibble is 16
//     times its signed code; the integers are those of unpack_word, so
//     every block dot is exact and equal to mvm_band's.  x is unpacked once
//     per chunk per warp and shared by the warp's R rows.
// Hopper has no int4 tensor-core path and a GEMV has nothing to reuse, so
// no tensor core is used.
#include <cooperative_groups.h>

#include "mvm.cuh"

namespace cgrp = cooperative_groups;

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

// The signed int8x4 codes of a packed word's low and high nibbles, the
// values unpack_word gives: a nibble v + 0x78 stays below 0x100 in every
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

// The f32 sums of R consecutive rows of A (``rows`` is the first; the
// band's scales at ``band_scales``) against x, one warp, in the order of
// the source note: v[r] is the same in every lane.
template <int BA, int BX, int R>
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
  constexpr int PA = Depth<R>::PA, PX = Depth<R>::PX;
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
  // add exactly +0 below, as mvm_band's guard does).
  auto load_a = [&](uint4(&dst)[R], int64_t c) {
    const bool valid = c * GROUPS + group < nb;
#pragma unroll
    for (int r = 0; r < R; ++r)
      dst[r] = ld_stream(ap + r * wa + c * MV_CHUNK, valid);
  };
  auto load_x = [&](uint4(&dst)[XW], float& s_a, float& s_x, int64_t c) {
    const int64_t b = c * GROUPS + group;
    const bool valid = b < nb;
    dst[0] = ld_ro(xp + c * X_CHUNK, valid);
    if constexpr (XW == 2) dst[1] = ld_ro(xp + c * X_CHUNK + 32, valid);
    s_a = ld_ro(band_scales + b, valid);
    s_x = ld_ro(x_scales + b, valid);
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

// The band requant and scaleAndAdd epilogue of mvm_band (mvm.cuh), op for
// op, run by one warp on the band's 64 row sums ys.
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

// CTA i owns rows 8R i ... 8R i + 8R - 1, warp w the R from 8R i + R w; a
// cluster of MV_ROWS / R CTAs holds one band.
template <int BA, int BX, int R>
__global__ void __launch_bounds__(MV_THREADS, 2) mvm_kernel(const MvmArgs p) {
  constexpr int C = MV_ROWS / R;  // CTAs per band
  __shared__ float ys[64];
  cgrp::cluster_group cluster = cgrp::this_cluster();
  // every CTA of the cluster has started before any writes the leader's ys
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t band = blockIdx.x / C;
  const int first = (int)(blockIdx.x % C) * (MV_WARPS * R) + warp * R;
  const int64_t wa = p.n_pad * BA / 8, nb = p.n_pad / 64;
  float v[R];
  row_sums<BA, BX, R>(p.a + (band * 64 + first) * wa, p.a_scales + band * nb,
                      p.x, p.x_scales, p.n_pad, v);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  float* lead = cluster.map_shared_rank(ys, 0);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) lead[first + r] = v[r];
  }
  cluster.sync();
  if (cluster.block_rank() != 0 || warp != 0) return;
  band_epilogue<BA, BX>(band, ys, p);
}

// f32-output mode: each warp writes its R sums y[row] (the sums the
// requant would read); no Philox, no AXPY, no cluster.  n_pad and m_pad
// need only be multiples of 64 (a shard's side).
template <int BA, int BX, int R>
__global__ void __launch_bounds__(MV_THREADS, 2)
mvm_f32_kernel(const MvmArgs p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * (MV_WARPS * R) + warp * R;
  const int64_t wa = p.n_pad * BA / 8, nb = p.n_pad / 64;
  float v[R];
  row_sums<BA, BX, R>(p.a + row * wa, p.a_scales + (row / 64) * nb, p.x,
                      p.x_scales, p.n_pad, v);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) p.out_f32[row + r] = v[r];
  }
}

template <int BA, int BX, int R, bool F32>
cudaError_t launch_rows(const MvmArgs& p, int64_t m_pad, cudaStream_t s) {
  constexpr int C = MV_ROWS / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(m_pad / 64 * C));
  cfg.blockDim = dim3(MV_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = F32 ? 0 : 1;
  if constexpr (F32)
    return cudaLaunchKernelEx(&cfg, mvm_f32_kernel<BA, BX, R>, p);
  else
    return cudaLaunchKernelEx(&cfg, mvm_kernel<BA, BX, R>, p);
}

template <int BA, int BX, bool F32>
cudaError_t launch_mode(const MvmArgs& p, int64_t m_pad, int rows_per_warp,
                        cudaStream_t s) {
  switch (rows_per_warp) {
    case 2:
      return launch_rows<BA, BX, 2, F32>(p, m_pad, s);
    case 4:
      return launch_rows<BA, BX, 4, F32>(p, m_pad, s);
    case 8:
      return launch_rows<BA, BX, 8, F32>(p, m_pad, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool F32>
int launch(const MvmArgs& p, int64_t m_pad, int bits_a, int bits_x,
           int rows_per_warp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (bits_a == 4 && bits_x == 4)
    e = launch_mode<4, 4, F32>(p, m_pad, rows_per_warp, s);
  else if (bits_a == 4 && bits_x == 8)
    e = launch_mode<4, 8, F32>(p, m_pad, rows_per_warp, s);
  else if (bits_a == 8 && bits_x == 8)
    e = launch_mode<8, 8, F32>(p, m_pad, rows_per_warp, s);
  else
    return (int)cudaErrorInvalidValue;
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace clover

extern "C" int clover_mvm(const int8_t* a, const float* a_scales,
                          const int8_t* x, const float* x_scales,
                          const int8_t* u, const float* u_scales, float alpha,
                          int8_t* out, float* out_scales, int64_t m_pad,
                          int64_t n_pad, int bits_a, int bits_x, int noise1,
                          uint32_t seed1, int noise2, uint32_t seed2,
                          int rows_per_warp, void* stream) {
  const clover::MvmArgs p = {a,     a_scales, x,     x_scales, u,
                             u_scales, alpha, out, out_scales, nullptr,
                             n_pad, noise1,   seed1, noise2,   seed2};
  return clover::launch<false>(p, m_pad, bits_a, bits_x, rows_per_warp,
                               stream);
}

extern "C" int clover_mvm_f32(const int8_t* a, const float* a_scales,
                              const int8_t* x, const float* x_scales,
                              float* out, int64_t m_pad, int64_t n_pad,
                              int bits_a, int bits_x, int rows_per_warp,
                              void* stream) {
  const clover::MvmArgs p = {a,       a_scales, x,  x_scales, nullptr,
                             nullptr, 0.0f,     nullptr, nullptr, out,
                             n_pad,   0,        0u, 0,        0u};
  return clover::launch<true>(p, m_pad, bits_a, bits_x, rows_per_warp,
                              stream);
}
