// Vector and matrix restore: f32 value = code * (s / qmax) per 64-element
// block (vector) or 64x64 tile (matrix), for 4- or 8-bit codes.
//
// Replaces clover_tpu/kernels/restore.py _rvec_kernel (restore_vec_pallas)
// and _rmat_kernel (restore_mat_pallas).
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
//
// Matrix restore: the same warp body over one 64-element segment of a row
// (row r, column block j), with the tile scale scales[r / 64][j].  Bound:
// 4.5 bytes per element (4-bit: half a byte read, four written) or 5
// (8-bit); at 8192x16384 that is 0.1803 / 0.2003 ms at 3.35 TB/s, so the
// f32 stores decide: each warp writes two full 128-byte lines.  The TPU
// kernel's regrouping of the scales into (gm, gn, tm/64, tn/64) blocks was
// a BlockSpec artefact and has no counterpart.
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

// One warp per 64-element segment of a row; segment w is row w / nbc,
// column block w % nbc of an (m_pad, nbc * 64) matrix.
__global__ void __launch_bounds__(256)
restore_mat_kernel(const int8_t* __restrict__ codes,
                   const float* __restrict__ scales, float* __restrict__ out,
                   int64_t m_pad, int64_t nbc, int bits) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= m_pad * nbc) return;  // uniform across the warp
  const int64_t r = w / nbc, j = w % nbc;
  const float mult = scales[(r >> 6) * nbc + j] / (bits == 4 ? 7.0f : 127.0f);
  int c0, c1;
  if (bits == 4) {
    const int p = codes[w * 32 + lane];
    c0 = low_code(p);
    c1 = high_code(p);
  } else {
    c0 = codes[w * 64 + lane];
    c1 = codes[w * 64 + 32 + lane];
  }
  out[w * 64 + lane] = (float)c0 * mult;
  out[w * 64 + 32 + lane] = (float)c1 * mult;
}

}  // namespace clover

extern "C" int clover_restore_mat(const int8_t* codes, const float* scales,
                                  float* out, int64_t m_pad, int64_t n_pad,
                                  int bits, void* stream) {
  const int64_t segments = m_pad * (n_pad / 64);
  const unsigned grid = (unsigned)((segments + 7) / 8);
  clover::restore_mat_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      codes, scales, out, m_pad, n_pad / 64, bits);
  return (int)cudaGetLastError();
}

extern "C" int clover_restore_vec(const int8_t* codes, const float* scales,
                                  float* out, int64_t n_pad, int bits,
                                  void* stream) {
  const int64_t nb = n_pad / 64;
  const unsigned grid = (unsigned)((nb + 7) / 8);
  clover::restore_vec_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      codes, scales, out, nb, bits);
  return (int)cudaGetLastError();
}
