// The large-n 4-bit threshold's two streaming passes: a per-block histogram
// of code magnitudes (hist4), and the mask that keeps |v| > tau plus the
// first `fill` ties at tau in index order (mask4).  tau and fill come from
// an exact selector over the compressed multiset {c * s_b/7 with weight
// h[b][c]} that runs in torch between the two launches
// (ops/threshold.py hybrid_select); neither leaves the device.
//
// Replaces clover_tpu/kernels/threshold.py _hist4_kernel (hist4_pallas) and
// _mask4_kernel (mask4_pallas).
//
// hist4: one warp per 64-block.  Lane j reads byte j of the block (element
// j in the low nibble, j + 32 in the high one) and counts per magnitude
// c = 0..7 come from __ballot_sync and __popc; lane c writes h[b][c] as an
// int32 (clover_tpu's counts are f32 holding the same integers).  The TPU
// kernel's bf16 indicator matmuls summed lanes on the MXU; a ballot does it
// here in one instruction.
//
// mask4: one warp per 64-block, the same byte layout.  v = (float)|c| *
// m7[b] is threshold4_plain's expression (m7 = s/7 divided once, IEEE), so
// v equals the selector's candidate c * m7[b] bit for bit.  An element is
// kept when v > tau, or when v == tau and offset[b] + rank < fill, rank the
// number of earlier ties of the block in element order (low nibbles 0..31,
// then high nibbles 32..63: a ballot and a popc under the lane mask), and
// offset[b] the ties of all earlier blocks (an exclusive prefix sum over
// the blocks, computed in torch from the histogram).  The TPU kernel
// carried the running tie count from one sequential grid step to the next;
// here blocks run in parallel and the prefix takes the carry's place.
//
// Bound: hist4 reads n/2 code bytes and writes 32 bytes per block (about n
// bytes in all); mask4 reads n/2 and writes n/2, plus 12 bytes per block of
// m7 and offsets.  At n = 2^20 and 2^23 (0.5-4 MB) both are launch- and
// latency-bound, not bandwidth-bound: a warp moves 32 bytes per block.
#include "common.cuh"

namespace clover {

constexpr int HYB_THREADS = 256;

__global__ void __launch_bounds__(HYB_THREADS)
hist4_kernel(const int8_t* __restrict__ codes, int* __restrict__ hist,
             int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * (HYB_THREADS / 32) + (threadIdx.x >> 5);
  if (b >= nb) return;  // uniform across the warp
  const int p = codes[b * 32 + lane];
  const int lo = abs(low_code(p)), hi = abs(high_code(p));
  int mine = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int n = __popc(__ballot_sync(FULL_MASK, lo == c)) +
                  __popc(__ballot_sync(FULL_MASK, hi == c));
    if (lane == c) mine = n;
  }
  if (lane < 8) hist[b * 8 + lane] = mine;
}

__global__ void __launch_bounds__(HYB_THREADS)
mask4_kernel(const int8_t* __restrict__ codes, const float* __restrict__ m7,
             const float* __restrict__ tau_p, const int64_t* __restrict__ fill_p,
             const int64_t* __restrict__ offset, int8_t* __restrict__ out,
             int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * (HYB_THREADS / 32) + (threadIdx.x >> 5);
  if (b >= nb) return;  // uniform across the warp
  const float tau = *tau_p;
  const int64_t fill = *fill_p, off = offset[b];
  const float m = m7[b];
  const int p = codes[b * 32 + lane];
  const int lo = low_code(p), hi = high_code(p);
  const float vlo = (float)abs(lo) * m, vhi = (float)abs(hi) * m;
  const unsigned tlo = __ballot_sync(FULL_MASK, vlo == tau);
  const unsigned thi = __ballot_sync(FULL_MASK, vhi == tau);
  const unsigned below = (1u << lane) - 1u;
  const int64_t rlo = off + __popc(tlo & below);
  const int64_t rhi = off + __popc(tlo) + __popc(thi & below);
  const bool klo = vlo > tau || (vlo == tau && rlo < fill);
  const bool khi = vhi > tau || (vhi == tau && rhi < fill);
  out[b * 32 + lane] = pack_byte(klo ? lo : 0, khi ? hi : 0);
}

}  // namespace clover

extern "C" int clover_hist4(const int8_t* codes, int* hist, int64_t n_pad,
                            void* stream) {
  const int64_t nb = n_pad / 64;
  const unsigned grid = (unsigned)((nb + 7) / 8);
  clover::hist4_kernel<<<grid, clover::HYB_THREADS, 0, (cudaStream_t)stream>>>(
      codes, hist, nb);
  return (int)cudaGetLastError();
}

extern "C" int clover_mask4(const int8_t* codes, const float* m7,
                            const float* tau, const int64_t* fill,
                            const int64_t* offset, int8_t* out, int64_t n_pad,
                            void* stream) {
  const int64_t nb = n_pad / 64;
  const unsigned grid = (unsigned)((nb + 7) / 8);
  clover::mask4_kernel<<<grid, clover::HYB_THREADS, 0, (cudaStream_t)stream>>>(
      codes, m7, tau, fill, offset, out, nb);
  return (int)cudaGetLastError();
}
