// Quantize: per-64-block (vector) or per-64x64-tile (matrix) absmax scale,
// stochastic rounding, 4-bit nibble pack.
//
// Replaces clover_tpu/kernels/quantize.py _qvec_kernel (quantize_vec_pallas)
// and _qmat_kernel (quantize_mat_pallas).
//
// Bound: device memory.  A matrix reads 4 bytes and writes half a byte (4-bit)
// per element; the absmax and the rounding are a few operations per element,
// and in SR mode one Philox evaluation (about 60 integer operations).
// Design: a warp owns a 64-element row segment, lane j holding elements j and
// j + 32, which are exactly the two nibbles of packed byte j: the warp max is
// the block scale, and lane j writes its byte without any exchange.  A matrix
// tile is one CTA of 8 warps x 8 rows; each row segment is two coalesced
// 128-byte loads, the tile max goes through shared memory, and the values stay
// in registers between the max and the rounding.
#include "common.cuh"

namespace clover {

__global__ void __launch_bounds__(256)
quantize_vec_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                    float* __restrict__ scales, int64_t nb, int bits,
                    int noise, uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= nb) return;  // uniform across the warp
  const float qm = bits == 4 ? 7.0f : 127.0f;
  const int64_t i0 = b * 64 + lane, i1 = i0 + 32;
  const float v0 = x[i0], v1 = x[i1];
  const float s = nonzero_scale(warp_max(fmaxf(fabsf(v0), fabsf(v1))));
  const float mult = qm / s;
  const int q0 = sr_code(v0, mult, qm, sr_noise(noise, seed, i0, 0));
  const int q1 = sr_code(v1, mult, qm, sr_noise(noise, seed, i1, 0));
  if (bits == 4) {
    codes[b * 32 + lane] = pack_byte(q0, q1);
  } else {
    codes[i0] = (int8_t)q0;
    codes[i1] = (int8_t)q1;
  }
  if (lane == 0) scales[b] = s;
}

constexpr int QM_WARPS = 8;
constexpr int QM_ROWS = 64 / QM_WARPS;  // rows per warp

__global__ void __launch_bounds__(256)
quantize_mat_kernel(const float* __restrict__ a, int8_t* __restrict__ codes,
                    float* __restrict__ scales, int64_t n_pad, int bits,
                    int noise, uint32_t seed) {
  __shared__ float warp_amax[QM_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tj = blockIdx.x, ti = blockIdx.y;
  const int64_t col = tj * 64 + lane;
  const float qm = bits == 4 ? 7.0f : 127.0f;
  float v[QM_ROWS][2];
  float m = 0.0f;
#pragma unroll
  for (int r = 0; r < QM_ROWS; ++r) {
    const int64_t row = ti * 64 + warp * QM_ROWS + r;
    v[r][0] = a[row * n_pad + col];
    v[r][1] = a[row * n_pad + col + 32];
    m = fmaxf(m, fmaxf(fabsf(v[r][0]), fabsf(v[r][1])));
  }
  m = warp_max(m);
  if (lane == 0) warp_amax[warp] = m;
  __syncthreads();
  float s = warp_amax[0];
#pragma unroll
  for (int w = 1; w < QM_WARPS; ++w) s = fmaxf(s, warp_amax[w]);
  s = nonzero_scale(s);
  const float mult = qm / s;
#pragma unroll
  for (int r = 0; r < QM_ROWS; ++r) {
    const int64_t row = ti * 64 + warp * QM_ROWS + r;
    const int64_t i0 = row * n_pad + col;
    const int q0 = sr_code(v[r][0], mult, qm, sr_noise(noise, seed, i0, 0));
    const int q1 = sr_code(v[r][1], mult, qm, sr_noise(noise, seed, i0 + 32, 0));
    if (bits == 4) {
      codes[row * (n_pad / 2) + tj * 32 + lane] = pack_byte(q0, q1);
    } else {
      codes[i0] = (int8_t)q0;
      codes[i0 + 32] = (int8_t)q1;
    }
  }
  if (threadIdx.x == 0) scales[ti * (n_pad / 64) + tj] = s;
}

}  // namespace clover

extern "C" int clover_quantize_vec(const float* x, int8_t* codes, float* scales,
                                   int64_t n_pad, int bits, int noise,
                                   uint32_t seed, void* stream) {
  const int64_t nb = n_pad / 64;
  const unsigned grid = (unsigned)((nb + 7) / 8);
  clover::quantize_vec_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      x, codes, scales, nb, bits, noise, seed);
  return (int)cudaGetLastError();
}

extern "C" int clover_quantize_mat(const float* a, int8_t* codes, float* scales,
                                   int64_t m_pad, int64_t n_pad, int bits,
                                   int noise, uint32_t seed, void* stream) {
  const dim3 grid((unsigned)(n_pad / 64), (unsigned)(m_pad / 64));
  clover::quantize_mat_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      a, codes, scales, n_pad, bits, noise, seed);
  return (int)cudaGetLastError();
}

extern "C" const char* clover_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
