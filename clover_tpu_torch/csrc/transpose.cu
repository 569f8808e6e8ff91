// Quantized matrix code transpose: packed 4-bit with nibble re-pairing, or
// plain 8-bit bytes.
//
// Replaces clover_tpu/kernels/transpose.py _kernel4 and _kernel8
// (transpose_pallas).
//
// 4-bit: output byte (c, 32B + J) pairs the codes A[64B + J, c] (low nibble)
// and A[64B + J + 32, c] (high nibble), so a 64x64 element tile maps to a
// 64x64 tile with no data leaving it.  8-bit: output byte (c, r) is input
// byte (r, c).  Bound: device memory, every code byte read once and written
// once.  Design: one CTA of 256 threads per 64x64 element tile, through a
// shared code tile whose rows are padded to 65 bytes so that neither the
// row-wise fill nor the column-wise drain piles onto one bank.  Each thread
// loads one contiguous run of a tile row (8 packed bytes as a uint2, or 16
// bytes as a uint4), and after one barrier gathers one run of an output row
// and stores it the same way, so loads and stores are both coalesced.  The
// TPU kernel's int8 identity and pair-weight matmuls existed only because
// Mosaic lacks byte shuffles.
#include "common.cuh"

namespace clover {

__global__ void __launch_bounds__(256)
transpose4_kernel(const int8_t* __restrict__ a, int8_t* __restrict__ t,
                  int64_t m_pad, int64_t n_pad) {
  __shared__ int8_t e[64][65];  // e[r][c] = code of A[64 ti + r, 64 tj + c]
  const int64_t tj = blockIdx.x, ti = blockIdx.y;
  const int64_t wa = n_pad / 2, wt = m_pad / 2;  // packed row widths
  const int tid = threadIdx.x;
  {
    const int r = tid >> 2, j0 = (tid & 3) * 8;
    const uint2 w =
        *reinterpret_cast<const uint2*>(a + (ti * 64 + r) * wa + tj * 32 + j0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int p = (int)(int8_t)(((k < 4 ? w.x : w.y) >> (8 * (k & 3))) & 0xFF);
      e[r][j0 + k] = (int8_t)low_code(p);
      e[r][j0 + k + 32] = (int8_t)high_code(p);
    }
  }
  __syncthreads();
  {
    const int c = tid >> 2, j0 = (tid & 3) * 8;
    uint32_t lo_word = 0, hi_word = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int J = j0 + k;
      const uint32_t byte = (uint8_t)pack_byte(e[J][c], e[J + 32][c]);
      if (k < 4) lo_word |= byte << (8 * k);
      else hi_word |= byte << (8 * (k - 4));
    }
    *reinterpret_cast<uint2*>(t + (tj * 64 + c) * wt + ti * 32 + j0) =
        make_uint2(lo_word, hi_word);
  }
}

__global__ void __launch_bounds__(256)
transpose8_kernel(const int8_t* __restrict__ a, int8_t* __restrict__ t,
                  int64_t m_pad, int64_t n_pad) {
  __shared__ uint8_t e[64][65];  // e[r][c] = A[64 ti + r, 64 tj + c]
  const int64_t tj = blockIdx.x, ti = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = tid >> 2, k0 = (tid & 3) * 16;
  {
    const uint4 v = *reinterpret_cast<const uint4*>(
        a + (ti * 64 + row) * n_pad + tj * 64 + k0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      e[row][k0 + k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
  }
  __syncthreads();
  {
    uint32_t o[4] = {0u, 0u, 0u, 0u};  // output row `row`: A[64 ti + k0 + k, .]
#pragma unroll
    for (int k = 0; k < 16; ++k)
      o[k >> 2] |= (uint32_t)e[k0 + k][row] << (8 * (k & 3));
    *reinterpret_cast<uint4*>(t + (tj * 64 + row) * m_pad + ti * 64 + k0) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace clover

extern "C" int clover_transpose(const int8_t* a, int8_t* t, int64_t m_pad,
                                int64_t n_pad, int bits, void* stream) {
  const dim3 grid((unsigned)(n_pad / 64), (unsigned)(m_pad / 64));
  if (bits == 4)
    clover::transpose4_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        a, t, m_pad, n_pad);
  else
    clover::transpose8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        a, t, m_pad, n_pad);
  return (int)cudaGetLastError();
}
