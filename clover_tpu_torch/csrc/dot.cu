// Dot product of two 4- or 8-bit vectors: sum over 64-blocks b of
// ((su_b / qmax) * (sv_b / qmax)) * (float)acc_b, acc_b the exact integer
// dot of the block's codes.
//
// Replaces clover_tpu/kernels/dot.py _dot4_kernel and _dot8_kernel
// (dot_pallas).
//
// Term order: the two quotients in IEEE, their product, then the product
// with the block sum, the order of clover_tpu/ops/dot.py and golden.py dot.
// The block sums are exact: |code product| <= 127^2 and 64 of them stay
// far below 2^24, so any summation order gives the same integer.  The TPU
// kernel's bf16 indicator matmuls and its P = 256A + B split existed only
// because the MXU has no exact integer path; here __dp4a sums four int8
// products into an int32.
//
// Design: a warp reads 128 contiguous code bytes per step, 4 per lane:
// four 4-bit blocks (8 lanes a block) or two 8-bit blocks (16 lanes a
// block).  4-bit lanes unpack their word's low and high nibbles into two
// words of four int8 codes (__vsub4 re-biases and sign-extends per byte)
// and take two __dp4a; a shuffle reduction over the block's lanes gives
// acc_b.  Each CTA takes a fixed run of DOT_BLOCKS_PER_CTA blocks, sums its
// terms in a fixed order and writes one f32 partial; a second launch of one
// CTA sums the partials in a fixed order.  No float atomics, so repeated
// calls give the same bits.
//
// Bound: both code streams and both scale streams read once, 9/16 byte per
// element and vector at 4 bits (18.9 MB, 0.0056 ms at n = 2^24 and 3.35
// TB/s), 17/16 at 8 bits; at the solver's n = 16384 the launch decides.
#include "common.cuh"

namespace clover {

constexpr int DOT_THREADS = 256;
constexpr int DOT_BLOCKS_PER_CTA = 256;   // 64-blocks per CTA
constexpr int SUM_THREADS = 256;

// Low (biased) and high nibbles of four packed bytes as four int8 codes.
__device__ __forceinline__ void unpack4(unsigned w, int& lo, int& hi) {
  lo = (int)__vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
  hi = (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

template <int BITS>
__global__ void __launch_bounds__(DOT_THREADS)
dot_partial_kernel(const int8_t* __restrict__ u, const int8_t* __restrict__ v,
                   const float* __restrict__ su, const float* __restrict__ sv,
                   float* __restrict__ partial, int64_t nb) {
  // lanes per block and blocks per warp step
  constexpr int LPB = BITS == 4 ? 8 : 16;
  constexpr int BPS = 32 / LPB;
  constexpr int STEPS = DOT_BLOCKS_PER_CTA / (BPS * (DOT_THREADS / 32));
  constexpr float QM = BITS == 4 ? 7.0f : 127.0f;
  __shared__ float warp_sum[DOT_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = (int64_t)blockIdx.x * DOT_BLOCKS_PER_CTA;
  float sum = 0.0f;   // lane 0: this warp's terms, in block order
  for (int s = 0; s < STEPS; ++s) {
    const int64_t b0 = first + ((int64_t)warp * STEPS + s) * BPS;
    const int64_t b = b0 + lane / LPB;
    int acc = 0;
    if (b < nb) {
      // 128 contiguous code bytes from block b0 on; word `lane`
      const unsigned wu = ((const unsigned*)(u + b0 * 8 * BITS))[lane];
      const unsigned wv = ((const unsigned*)(v + b0 * 8 * BITS))[lane];
      if (BITS == 4) {
        int ul, uh, vl, vh;
        unpack4(wu, ul, uh);
        unpack4(wv, vl, vh);
        acc = __dp4a(ul, vl, __dp4a(uh, vh, 0));
      } else {
        acc = __dp4a((int)wu, (int)wv, 0);
      }
    }
#pragma unroll
    for (int o = LPB / 2; o; o >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, o);
    float t = 0.0f;
    if (b < nb && lane % LPB == 0)
      t = (su[b] / QM) * (sv[b] / QM) * (float)acc;
    // lane 0 adds the step's terms in block order
#pragma unroll
    for (int g = 0; g < BPS; ++g) {
      const float tg = __shfl_sync(FULL_MASK, t, g * LPB);
      if (lane == 0) sum += tg;
    }
  }
  if (lane == 0) warp_sum[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.0f;
    for (int w = 0; w < DOT_THREADS / 32; ++w) c += warp_sum[w];
    partial[blockIdx.x] = c;
  }
}

// One CTA: thread t sums partials t, t + SUM_THREADS, ... in order, then a
// fixed tree over the threads.
__global__ void __launch_bounds__(SUM_THREADS)
dot_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
               int64_t count) {
  __shared__ float s[SUM_THREADS];
  float c = 0.0f;
  for (int64_t i = threadIdx.x; i < count; i += SUM_THREADS) c += partial[i];
  s[threadIdx.x] = c;
  __syncthreads();
  for (int w = SUM_THREADS / 2; w; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = s[0];
}

}  // namespace clover

// The partials buffer holds one f32 per CTA: ceil(n_pad / 64 /
// DOT_BLOCKS_PER_CTA) (kernels/dot.py BLOCKS_PER_CTA).

extern "C" int clover_dot(const int8_t* u, const int8_t* v, const float* su,
                          const float* sv, float* partial, float* out,
                          int64_t n_pad, int bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nb = n_pad / 64;
  const int ctas = (int)((nb + clover::DOT_BLOCKS_PER_CTA - 1) /
                         clover::DOT_BLOCKS_PER_CTA);
  if (bits == 4)
    clover::dot_partial_kernel<4><<<ctas, clover::DOT_THREADS, 0, st>>>(
        u, v, su, sv, partial, nb);
  else
    clover::dot_partial_kernel<8><<<ctas, clover::DOT_THREADS, 0, st>>>(
        u, v, su, sv, partial, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  clover::dot_sum_kernel<<<1, clover::SUM_THREADS, 0, st>>>(partial, out,
                                                             ctas);
  return (int)cudaGetLastError();
}
