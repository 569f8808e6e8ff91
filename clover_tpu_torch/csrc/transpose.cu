// Packed 4-bit matrix transpose with nibble re-pairing.
//
// Replaces clover_tpu/kernels/transpose.py _kernel4 (transpose_pallas).
//
// Output byte (c, 32B + J) pairs the codes A[64B + J, c] (low nibble) and
// A[64B + J + 32, c] (high nibble), so a 64x64 element tile maps to a 64x64
// tile with no data leaving it.  Bound: device memory, one byte read and one
// written per two codes.  Design: one CTA of 256 threads per tile; each
// thread loads 8 packed bytes of one tile row (uint2), unpacks them into a
// shared 64x64 code tile, and after one barrier re-packs 8 bytes of one
// output row and stores them as a uint2.  The TPU kernel's int8 identity and
// pair-weight matmuls existed only because Mosaic lacks byte shuffles.
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

}  // namespace clover

extern "C" int clover_transpose4(const int8_t* a, int8_t* t, int64_t m_pad,
                                 int64_t n_pad, void* stream) {
  const dim3 grid((unsigned)(n_pad / 64), (unsigned)(m_pad / 64));
  clover::transpose4_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(a, t, m_pad,
                                                                    n_pad);
  return (int)cudaGetLastError();
}
