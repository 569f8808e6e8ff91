// Batched requantizing MVM: 1 <= B <= 32 vectors against one 4- or 8-bit
// matrix A, modes 4x4 (4-bit output), 4x8 and 8x8 (8-bit output), and its
// f32-output mode.
//
// Replaces clover_tpu/kernels/mvm_batched.py mvm_batched_pallas (bodies
// _kernel_4x4_b, _kernel_4x8_b, _kernel_8x8_b, epilogue _epilogue_b) in its
// requantizing modes, and mvm_batched_pallas_f32 (the same bodies,
// _build_call_b with out_bits 32): with F32 the epilogue writes vector j's
// 64 f32 band sums y_j to out_f32[j, band*64 ...] instead of requantizing,
// for the sharded server, which sums the shards' partials first
// (clover_tpu/parallel/ops.py mvm_batched_psum).  Vector j's output is that
// of csrc/mvm.cu without the AXPY epilogue, with seed1 = seed + j:
//
//   y_j = A x_j        exact int32 dot per (row, 64-block), times
//                      (sA/qA)*(sx_j/qx) in f32, summed in mvm.cu's order
//   out_j = band-requant(y_j)   absmax, SR (Philox leg 0, seed + j,
//                               counter = output row), per 64-row band
//
// so each vector's codes and scales equal a single-vector launch bit for
// bit.  (The TPU kernel's seed base + i*B + j follows its row tiles; the
// seed + j here is that of clover_tpu's vmapped path, ops/gemm.py.)
//
// Bound: device memory for small B, the __dp4a issue rate as B grows (each
// matrix byte meets every vector: 2 int8 multiply-adds per packed 4-bit
// byte, 1 per 8-bit byte, per vector).  Design: mvm.cu's kernel with a tile
// of BT vectors per CTA.  Grid (cdiv(B, BT), m_pad/64): blockIdx.x picks
// the vector tile, blockIdx.y the 64-row band, so the tiles of one band are
// scheduled together and share its bytes of A through L2.  Per 512-byte
// chunk a warp loads its 8 rows' A words once (unpacked once for 4-bit A)
// and __dp4a's them against each of the BT vectors' x words; the group and
// lane order is mvm.cu's, so every vector's sums are the single kernel's.
// BT is 4 or 8 (a template parameter), bounding the BT x 8 accumulators
// per thread.  m_pad and n_pad need only be multiples of 64 (mvm.cuh).
// out_f32 is the last parameter and the F32 branch leaves the requant's
// statement order alone, so the requantizing instances compile to the
// machine code of a kernel without the F32 mode (kernel_ab.py --sass).
// No tensor core is used; an int8 MMA redesign (nibbles unpacked to s8 in
// shared memory) is a later step.
#include "mvm.cuh"

namespace clover {

template <int BA, int BX, int BT, bool F32>
__global__ void __launch_bounds__(256)
mvm_batched_kernel(const int8_t* __restrict__ a,
                   const float* __restrict__ a_scales,
                   const int8_t* __restrict__ x,
                   const float* __restrict__ x_scales,
                   int8_t* __restrict__ out, float* __restrict__ out_scales,
                   int64_t m_pad, int64_t n_pad, int batch, int noise,
                   uint32_t seed, float* __restrict__ out_f32) {
  constexpr int BO = (BA == 4 && BX == 4) ? 4 : 8;  // output bits
  constexpr float QA = BA == 4 ? 7.0f : 127.0f;
  constexpr float QX = BX == 4 ? 7.0f : 127.0f;
  constexpr float QO = BO == 4 ? 7.0f : 127.0f;
  constexpr int LANES = BA == 4 ? 2 : 4;  // lanes sharing one block of A
  constexpr int GROUPS = 32 / LANES;      // blocks per warp per chunk
  constexpr int A_BLOCK = 8 * BA;         // bytes of one 64-element block
  __shared__ float ys[BT][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v0 = blockIdx.x * BT;
  const int nv = min(BT, batch - v0);     // live vectors of this tile
  const int64_t band = blockIdx.y;
  const int64_t wa = n_pad * BA / 8, wx = n_pad * BX / 8, nb = n_pad / 64;
  const int part = lane & (LANES - 1), group = lane / LANES;
  const int8_t* rows = a + (band * 64 + warp * MV_ROWS) * wa;
  const float* band_scales = a_scales + band * nb;
  const int8_t* xt = x + v0 * wx;
  const float* xst = x_scales + v0 * nb;

  float acc[BT][MV_ROWS];
#pragma unroll
  for (int t = 0; t < BT; ++t)
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) acc[t][r] = 0.0f;

  for (int64_t c = 0; c * MV_CHUNK < wa; ++c) {
    const int64_t b = c * GROUPS + group;
    const bool valid = b < nb;
    const int64_t off = b * A_BLOCK + part * 16;  // this lane's bytes of A
    // this lane's bytes of each x, as in mvm.cu
    const int64_t xo = BX == 4 ? off : b * 64 + part * 16;
    const float sa = valid ? band_scales[b] / QA : 0.0f;
    // A's words as int8x4: for 4-bit A, al/ah the low/high codes of word i
    int al[MV_ROWS][4], ah[MV_ROWS][4];
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) {
      const uint4 w = valid ? *reinterpret_cast<const uint4*>(rows + r * wa + off)
                            : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (BA == 4) {
        unpack_word(w.x, al[r][0], ah[r][0]);
        unpack_word(w.y, al[r][1], ah[r][1]);
        unpack_word(w.z, al[r][2], ah[r][2]);
        unpack_word(w.w, al[r][3], ah[r][3]);
      } else {
        al[r][0] = (int)w.x; al[r][1] = (int)w.y;
        al[r][2] = (int)w.z; al[r][3] = (int)w.w;
      }
    }
#pragma unroll
    for (int t = 0; t < BT; ++t) {
      if (t >= nv) break;  // uniform across the CTA
      uint4 xa = make_uint4(0u, 0u, 0u, 0u), xb = xa;
      float comb = 0.0f;
      if (valid) {
        xa = *reinterpret_cast<const uint4*>(xt + t * wx + xo);
        if constexpr (BA == 4 && BX == 8)
          xb = *reinterpret_cast<const uint4*>(xt + t * wx + xo + 32);
        comb = sa * (xst[t * nb + b] / QX);
      }
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
#pragma unroll
      for (int r = 0; r < MV_ROWS; ++r) {
        int d = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d = __dp4a(al[r][i], xl[i], d);
          if constexpr (BA == 4) d = __dp4a(ah[r][i], xh[i], d);
        }
#pragma unroll
        for (int o = 1; o < LANES; o <<= 1)
          d += __shfl_xor_sync(FULL_MASK, d, o);  // the block's exact dot
        acc[t][r] = acc[t][r] + comb * (float)d;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < BT; ++t) {
    if (t >= nv) break;
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) {
      float v = acc[t][r];
#pragma unroll
      for (int o = 16; o >= LANES; o >>= 1)
        v = v + __shfl_xor_sync(FULL_MASK, v, o);
      if (lane == 0) ys[t][warp * MV_ROWS + r] = v;
    }
  }
  __syncthreads();
  if (warp >= nv) return;

  // band requant of vector v0 + warp: lane j holds band rows j and j + 32
  const int vec = v0 + warp;
  const uint32_t seed1 = seed + (uint32_t)vec;
  const int64_t i0 = band * 64 + lane, i1 = i0 + 32;
  const float y0 = ys[warp][lane], y1 = ys[warp][lane + 32];
  if constexpr (F32) {
    out_f32[vec * m_pad + i0] = y0;
    out_f32[vec * m_pad + i1] = y1;
    return;
  }
  const float s1 = nonzero_scale(warp_max(fmaxf(fabsf(y0), fabsf(y1))));
  const float mult1 = QO / s1;
  const int q0 = sr_code(y0, mult1, QO, sr_noise(noise, seed1, i0, 0));
  const int q1 = sr_code(y1, mult1, QO, sr_noise(noise, seed1, i1, 0));
  int8_t* o = out + vec * (m_pad * BO / 8);
  if constexpr (BO == 4) {
    o[band * 32 + lane] = pack_byte(q0, q1);
  } else {
    o[i0] = (int8_t)q0;
    o[i1] = (int8_t)q1;
  }
  if (lane == 0) out_scales[vec * (m_pad / 64) + band] = s1;
}

template <int BA, int BX, bool F32>
int launch_batched(const int8_t* a, const float* a_scales, const int8_t* x,
                   const float* x_scales, int8_t* out, float* out_scales,
                   float* out_f32, int64_t m_pad, int64_t n_pad, int batch,
                   int noise, uint32_t seed, cudaStream_t s) {
  if (batch <= 4) {
    const dim3 grid((unsigned)((batch + 3) / 4), (unsigned)(m_pad / 64));
    mvm_batched_kernel<BA, BX, 4, F32><<<grid, 256, 0, s>>>(
        a, a_scales, x, x_scales, out, out_scales, m_pad, n_pad, batch,
        noise, seed, out_f32);
  } else {
    const dim3 grid((unsigned)((batch + 7) / 8), (unsigned)(m_pad / 64));
    mvm_batched_kernel<BA, BX, 8, F32><<<grid, 256, 0, s>>>(
        a, a_scales, x, x_scales, out, out_scales, m_pad, n_pad, batch,
        noise, seed, out_f32);
  }
  return (int)cudaGetLastError();
}

// Dispatch on the mode; out_f32 selects the f32-output mode.
template <bool F32>
int launch_mode(const int8_t* a, const float* a_scales, const int8_t* x,
                const float* x_scales, int8_t* out, float* out_scales,
                float* out_f32, int64_t m_pad, int64_t n_pad, int batch,
                int bits_a, int bits_x, int noise, uint32_t seed,
                cudaStream_t s) {
  if (batch < 1 || batch > 32) return (int)cudaErrorInvalidValue;
  if (bits_a == 4 && bits_x == 4)
    return launch_batched<4, 4, F32>(a, a_scales, x, x_scales, out,
                                     out_scales, out_f32, m_pad, n_pad,
                                     batch, noise, seed, s);
  if (bits_a == 4 && bits_x == 8)
    return launch_batched<4, 8, F32>(a, a_scales, x, x_scales, out,
                                     out_scales, out_f32, m_pad, n_pad,
                                     batch, noise, seed, s);
  if (bits_a == 8 && bits_x == 8)
    return launch_batched<8, 8, F32>(a, a_scales, x, x_scales, out,
                                     out_scales, out_f32, m_pad, n_pad,
                                     batch, noise, seed, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace clover

extern "C" int clover_mvm_batched(const int8_t* a, const float* a_scales,
                                  const int8_t* x, const float* x_scales,
                                  int8_t* out, float* out_scales,
                                  int64_t m_pad, int64_t n_pad, int batch,
                                  int bits_a, int bits_x, int noise,
                                  uint32_t seed, void* stream) {
  return clover::launch_mode<false>(a, a_scales, x, x_scales, out,
                                    out_scales, nullptr, m_pad, n_pad, batch,
                                    bits_a, bits_x, noise, seed,
                                    (cudaStream_t)stream);
}

extern "C" int clover_mvm_batched_f32(const int8_t* a, const float* a_scales,
                                      const int8_t* x, const float* x_scales,
                                      float* out, int64_t m_pad, int64_t n_pad,
                                      int batch, int bits_a, int bits_x,
                                      void* stream) {
  return clover::launch_mode<true>(a, a_scales, x, x_scales, nullptr,
                                   nullptr, out, m_pad, n_pad, batch, bits_a,
                                   bits_x, 0, 0u, (cudaStream_t)stream);
}
