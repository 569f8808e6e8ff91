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
// Summation order, a function of n alone (kernels/dot.py
// dot_plain_ordered repeats it with elementwise f32 adds):
//   - The blocks fall into tiles of DOT_TILE = 256.  A warp step reads G
//     blocks, 512 contiguous bytes of u and of v, 16 a lane (G = 32 /
//     lanes a block: 16 at 4 bits, 8 at 8 bits), so a tile is STEPS = 2
//     (4-bit) or 4 (8-bit) steps of the DOT_WARPS warps: warp w's step s
//     reads blocks t DOT_TILE + (s DOT_WARPS + w) G + g, g < G.
//   - Group g of warp w adds its STEPS terms in step order, from +0; the G
//     group sums reduce as (g, g ^ G/2), ..., (g, g ^ 1), then the
//     DOT_WARPS warp sums as (w, w ^ 4), (w, w ^ 2), (w, w ^ 1): the tile's
//     partial.  Blocks past the last are +0 terms.
//   - The partials are summed by thread j of one CTA as partials j, j +
//     DOT_THREADS, ... in order, from +0, then over the threads by the same
//     halving trees (lanes, then warps).
//   No float atomics, and no order that depends on the grid: a CTA walks
//   tiles blockIdx.x, blockIdx.x + gridDim.x, ..., so any grid and every
//   repeated call give the same bits.
//
// One launch a call: each CTA writes its tiles' partials, makes them
// visible (__threadfence) and takes an integer ticket (atomicAdd); the CTA
// that draws the last ticket sums the partials, reading them from L2
// (ld.global.cg), writes the result and resets the ticket to 0 for the next
// call.  The caller keeps one ticket per stream (kernels/dot.py), since two
// calls on one stream never overlap and calls on two streams must not share
// a count.  The parent's second launch, one CTA summing the partials, cost
// a launch floor at every n.
//
// Bound: both code streams and both scale streams read once, 9/16 byte per
// element and vector at 4 bits (18.9 MB, 0.0056 ms at n = 2^24 and 3.35
// TB/s), 17/16 at 8 bits; at the solver's n = 16384 and -v's sizes the
// launch decides.  Every load of a tile -- STEPS 16-byte loads of u and of
// v and their scales per lane, 16 KB (4-bit) or 32 KB (8-bit) of codes a
// CTA -- is issued before the first term is formed, and one tile a CTA is
// the default grid (1024 CTAs at 2^24), so the card holds megabytes of
// loads in flight.  A tile of 256 blocks measured faster than one of 512
// or 1024 at 4 bits and than one of 128 or 512 at 8 bits (PERF.md §6).
#include "mvm_rows.cuh"

namespace clover {

constexpr int DOT_THREADS = 256;
constexpr int DOT_WARPS = DOT_THREADS / 32;
constexpr int DOT_TILE = 256;  // blocks of a tile

template <int BITS>
struct DotGeom {
  static constexpr int LANES = BITS == 4 ? 2 : 4;  // lanes sharing a block
  static constexpr int G = 32 / LANES;              // blocks a warp step
  static constexpr int STEPS = DOT_TILE / (DOT_WARPS * G);  // loaded at once
};

// The int8x4 codes of four bytes: 4-bit words give their low and high
// nibbles (low_codes, high_codes), 8-bit words are their codes.
template <int BITS>
__device__ __forceinline__ int dot_words(const uint4& a, const uint4& b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
  const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
  int d = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (BITS == 4) {
      d = __dp4a(low_codes(wa[j]), low_codes(wb[j]), d);
      d = __dp4a(high_codes(wa[j]), high_codes(wb[j]), d);
    } else {
      d = __dp4a((int)wa[j], (int)wb[j], d);
    }
  }
  return d;
}

// Lane 0's value of the butterfly (v, v ^ o) for o = FIRST, FIRST / 2, ...,
// LAST: the halving tree of the order note.
template <int FIRST, int LAST>
__device__ __forceinline__ float halve(float v) {
#pragma unroll
  for (int o = FIRST; o >= LAST; o >>= 1)
    v = v + __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

template <int BITS>
__global__ void __launch_bounds__(DOT_THREADS)
dot_kernel(const int8_t* __restrict__ u, const int8_t* __restrict__ v,
           const float* __restrict__ su, const float* __restrict__ sv,
           float* partial, unsigned* ticket, float* out, int64_t nb,
           int64_t tiles) {
  using Geo = DotGeom<BITS>;
  constexpr float QM = BITS == 4 ? 7.0f : 127.0f;
  constexpr int BLOCK_BYTES = 8 * BITS;
  __shared__ float warp_sum[DOT_WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane / Geo::LANES;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    uint4 wu[Geo::STEPS], wv[Geo::STEPS];
    float fu[Geo::STEPS], fv[Geo::STEPS];
#pragma unroll
    for (int s = 0; s < Geo::STEPS; ++s) {
      const int64_t b0 = tile * DOT_TILE + (s * DOT_WARPS + warp) * Geo::G;
      const int64_t b = b0 + group;
      const bool valid = b < nb;
      const int64_t off = b0 * BLOCK_BYTES + lane * 16;
      wu[s] = ld_ro(u + off, valid);
      wv[s] = ld_ro(v + off, valid);
      fu[s] = ld_ro(su + b, valid);
      fv[s] = ld_ro(sv + b, valid);
    }
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < Geo::STEPS; ++s) {
      int d = dot_words<BITS>(wu[s], wv[s]);
#pragma unroll
      for (int o = 1; o < Geo::LANES; o <<= 1)
        d += __shfl_xor_sync(FULL_MASK, d, o);  // the block's exact dot
      // (0 / qmax) * (0 / qmax) * 0 = +0 past the last block
      acc = acc + (fu[s] / QM) * (fv[s] / QM) * (float)d;
    }
    acc = halve<16, Geo::LANES>(acc);
    if (lane == 0) warp_sum[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      const float w = halve<DOT_WARPS / 2, 1>(
          lane < DOT_WARPS ? warp_sum[lane] : 0.0f);
      if (lane == 0) partial[tile] = w;
    }
    __syncthreads();  // warp_sum is free for the next tile
  }
  __threadfence();  // this CTA's partials reach L2 before its ticket
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other CTA's partials, read below from L2
  float c = 0.0f;
  for (int64_t i = threadIdx.x; i < tiles; i += DOT_THREADS)
    c = c + ld_cg(partial + i);
  c = halve<16, 1>(c);
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  if (warp == 0) {
    const float w =
        halve<DOT_WARPS / 2, 1>(lane < DOT_WARPS ? warp_sum[lane] : 0.0f);
    if (lane == 0) {
      out[0] = w;
      *ticket = 0u;  // the stream's next call starts from 0
    }
  }
}

}  // namespace clover

// partial: one f32 per tile, ceil(n_pad / 64 / DOT_TILE); ticket: the
// stream's counter, 0 between calls; grid: CTAs, at least 1.
extern "C" int clover_dot(const int8_t* u, const int8_t* v, const float* su,
                          const float* sv, float* partial, unsigned* ticket,
                          float* out, int64_t n_pad, int bits, int grid,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nb = n_pad / 64;
  if (grid < 1 || (bits != 4 && bits != 8)) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (nb + clover::DOT_TILE - 1) / clover::DOT_TILE;
  if (bits == 4)
    clover::dot_kernel<4><<<grid, clover::DOT_THREADS, 0, st>>>(
        u, v, su, sv, partial, ticket, out, nb, tiles);
  else
    clover::dot_kernel<8><<<grid, clover::DOT_THREADS, 0, st>>>(
        u, v, su, sv, partial, ticket, out, nb, tiles);
  return (int)cudaGetLastError();
}
