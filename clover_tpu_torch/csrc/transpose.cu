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
// once.  The TPU kernel's int8 identity and pair-weight matmuls existed
// only because Mosaic lacks byte shuffles.
//
// 8-bit design: one CTA of 256 threads per 64x64 element tile, through a
// shared code tile whose rows are padded to 65 bytes so that neither the
// row-wise fill nor the column-wise drain piles onto one bank.  Each thread
// loads 16 bytes of a tile row, and after one barrier gathers 16 bytes of an
// output row and stores them the same way.
//
// 4-bit design (transpose4_kernel): a CTA of 4 warps moves a strip of 4x4
// tiles, 32 KB in and 32 KB out.  The strip lands in shared memory by
// 16-byte cp.async copies, a row's 128 bytes from 8 consecutive lanes.  A
// packed 64x64 tile is two 32x32 byte matrices, P (its rows 0-31) and Q
// (rows 32-63), and output byte (c, J) of the tile is, in nibbles,
//   c < 32:   lo(P[J][c])       | (lo(Q[J][c]) ^ 8) << 4
//   c >= 32:  hi(P[J][c-32]) ^ 8 | hi(Q[J][c-32]) << 4
// since a low nibble is biased by +8 and a high one is plain two's
// complement (formats.py), and moving a nibble across flips its bit 3.  So
// the kernel transposes P and Q as bytes, in 4x4 blocks of 32-bit words
// (eight __byte_perm each), and merges them with word masks: four output
// bytes a mask, shift and xor.  Warp w of the CTA takes tile row w of the
// strip, lane 8b + k word column k (bytes 4k..4k+3) of tile column b, so a
// warp's shared loads hit 32 banks.  A lane's 8 output rows (c = 4k..4k + 3
// and 32 + 4k ...) go back into shared memory as the output strip (chunks
// swizzled against bank conflicts), and leave it as 128-byte rows from 8
// consecutive lanes, as they came in.
#include "common.cuh"

namespace clover {

constexpr int T4_STRIP = 4;                     // tiles a side of a strip
constexpr int T4_THREADS = 32 * T4_STRIP;       // a warp per tile row
constexpr int T4_ROWS = 64 * T4_STRIP;          // input rows of a strip
constexpr int T4_WORDS = 32 * T4_STRIP / 4;     // words of a strip row

// Columns of a 4x4 byte block: in r[i] = row i, out c[e] byte i = row i's
// byte e.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// The 16-byte chunk of row ``row`` of the output strip where chunk ``c`` is
// kept in shared memory: swizzled so that the 8 rows 4k + e (k = 0..7) a
// quarter-warp writes fall on 8 distinct bank groups.
__device__ __forceinline__ int out_chunk(int row, int c) {
  return c ^ ((row >> 2) & 7);
}

__global__ void __launch_bounds__(T4_THREADS)
transpose4_kernel(const int8_t* __restrict__ a, int8_t* __restrict__ t,
                  int64_t m_pad, int64_t n_pad) {
  // the input strip (rows of 4 tiles' 32 bytes), then the output strip
  __shared__ __align__(16) uint32_t s[T4_ROWS][T4_WORDS];
  const int64_t wa = n_pad / 2, wt = m_pad / 2;  // packed row widths
  const int64_t mt = m_pad / 64, nt = n_pad / 64;
  const int64_t ti0 = (int64_t)blockIdx.y * T4_STRIP;
  const int64_t tj0 = (int64_t)blockIdx.x * T4_STRIP;
  // the strip's tiles that exist (the last strip of a side may be short):
  // input rows and 16-byte chunks of a row, output rows and chunks
  const int tiles_m = (int)(mt - ti0 < T4_STRIP ? mt - ti0 : T4_STRIP);
  const int tiles_n = (int)(nt - tj0 < T4_STRIP ? nt - tj0 : T4_STRIP);
  for (int q = threadIdx.x; q < T4_ROWS * 8; q += T4_THREADS) {
    const int row = q >> 3, chunk = q & 7;
    if (row < tiles_m * 64 && chunk < tiles_n * 2)
      cp_async16(&s[row][chunk * 4],
                 a + (ti0 * 64 + row) * wa + tj0 * 32 + chunk * 16);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const int tile_row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = lane >> 3, k = lane & 7;
  const int col = b * 8 + k;  // this lane's word of each strip row
  uint32_t lo[4][8], hi[4][8];  // [c - 4k][word of J]: output bytes 0..31
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int j0 = tile_row * 64 + g * 4;
    uint32_t p[4], q[4], tp[4], tq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = s[j0 + i][col];
      q[i] = s[j0 + 32 + i][col];
    }
    transpose4x4(p, tp);
    transpose4x4(q, tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e][g] = (tp[e] & 0x0F0F0F0Fu) |
                 (((tq[e] << 4) ^ 0x80808080u) & 0xF0F0F0F0u);
      hi[e][g] = (((tp[e] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) |
                 (tq[e] & 0xF0F0F0F0u);
    }
  }
  __syncthreads();  // every word of the input strip has been read
  // output strip row 64 b + c holds bytes 32 tile_row ... + 31 of output
  // row 64 tj + c in its chunks 2 tile_row and 2 tile_row + 1
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = b * 64 + 4 * k + e;
      *reinterpret_cast<uint4*>(
          &s[row][out_chunk(row, 2 * tile_row + x) * 4]) =
          make_uint4(lo[e][4 * x], lo[e][4 * x + 1], lo[e][4 * x + 2],
                     lo[e][4 * x + 3]);
      *reinterpret_cast<uint4*>(
          &s[row + 32][out_chunk(row + 32, 2 * tile_row + x) * 4]) =
          make_uint4(hi[e][4 * x], hi[e][4 * x + 1], hi[e][4 * x + 2],
                     hi[e][4 * x + 3]);
    }
  }
  __syncthreads();
  // 128 bytes of an output row from 8 consecutive lanes
  for (int q = threadIdx.x; q < T4_ROWS * 8; q += T4_THREADS) {
    const int row = q >> 3, chunk = q & 7;
    if (row < tiles_n * 64 && chunk < tiles_m * 2)
      *reinterpret_cast<uint4*>(t + (tj0 * 64 + row) * wt + ti0 * 32 +
                                chunk * 16) =
          *reinterpret_cast<const uint4*>(&s[row][out_chunk(row, chunk) * 4]);
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
  if (bits == 4) {
    const int side = clover::T4_STRIP * 64;
    const dim3 grid((unsigned)((n_pad + side - 1) / side),
                    (unsigned)((m_pad + side - 1) / side));
    clover::transpose4_kernel<<<grid, clover::T4_THREADS, 0,
                                (cudaStream_t)stream>>>(a, t, m_pad, n_pad);
  } else {
    const dim3 grid((unsigned)(n_pad / 64), (unsigned)(m_pad / 64));
    clover::transpose8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        a, t, m_pad, n_pad);
  }
  return (int)cudaGetLastError();
}
