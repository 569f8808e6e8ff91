// Exact 4-bit hard threshold: keep the K largest |code * s/7|, zero the rest.
//
// Replaces clover_tpu/kernels/threshold.py _kernel4 (threshold4_pallas).
//
// Order is the golden one (clover_tpu/golden.py threshold): |value|
// descending, then index ascending.  |value| is compared as the bit pattern
// of the f32 product |code| * (s/7), the expression of threshold4_pallas
// (s/7 divided first, IEEE), whose non-negative patterns order like the
// values.  Scales are never touched.
//
// Design: one CTA of 1024 threads.  A radix select over the 32-bit patterns,
// four passes of 8 bits with a shared 256-bin histogram, finds the exact
// K-th largest pattern tau and how many ties at tau to keep; neither leaves
// the device.  A last pass gives each thread one 64-element block, counts
// its ties in index order, takes a block-wide exclusive scan of the counts
// (carried across chunks of 1024 blocks), and writes the kept codes packed.
// Bound: at the solver's n = 16384 the 8 KB of codes sit in L1/L2, so the
// time is the passes' latency on one SM, not bandwidth: the known limit of a
// single-CTA select.  The TPU kernel's bisection, indicator matmuls and
// triangular-matmul prefix sums were workarounds for Mosaic's lack of sort,
// scatter and scan.
#include "common.cuh"

namespace clover {

constexpr int TH_THREADS = 1024;

__device__ __forceinline__ uint32_t value_bits(int code, float m7) {
  return __float_as_uint((float)abs(code) * m7);
}

__device__ __forceinline__ int byte_of(const uint32_t (&w)[8], int j) {
  return (int)(int8_t)((w[j >> 2] >> (8 * (j & 3))) & 0xFFu);
}

__global__ void __launch_bounds__(TH_THREADS)
threshold4_kernel(const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, int8_t* __restrict__ out,
                  int64_t n_pad, int64_t k) {
  __shared__ uint32_t hist[256];
  __shared__ uint32_t sel_digit, sel_rank, chunk_ties, running;
  __shared__ uint32_t warp_off[TH_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t nbytes = n_pad / 2, nb = n_pad / 64;

  // ---- radix select: tau = K-th largest pattern, fill = ties to keep ----
  // (k = 0 keeps nothing: tau above every non-negative pattern, fill 0)
  uint32_t prefix = k > 0 ? 0u : 0xFFFFFFFFu, mask = 0, kk = (uint32_t)k;
  for (int shift = 24; k > 0 && shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += TH_THREADS) hist[i] = 0;
    __syncthreads();
    for (int64_t i = tid; i < nbytes; i += TH_THREADS) {
      const int p = codes[i];
      const float m7 = scales[i >> 5] / 7.0f;
      const uint32_t blo = value_bits(low_code(p), m7);
      const uint32_t bhi = value_bits(high_code(p), m7);
      if ((blo & mask) == prefix) atomicAdd(&hist[(blo >> shift) & 255u], 1u);
      if ((bhi & mask) == prefix) atomicAdd(&hist[(bhi >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds digits 255 - 8l ... 255 - 8l - 7 (descending)
      uint32_t c[8], tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - (8 * lane + j)];
        tot += c[j];
      }
      uint32_t incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += t;
      }
      const uint32_t excl = incl - tot;
      if (excl < kk && kk <= incl) {
        uint32_t cum = excl;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (cum + c[j] >= kk) {
            sel_digit = 255 - (8 * lane + j);
            sel_rank = kk - cum;
            break;
          }
          cum += c[j];
        }
      }
    }
    __syncthreads();
    prefix |= sel_digit << shift;
    mask |= 0xFFu << shift;
    kk = sel_rank;
    __syncthreads();
  }
  const uint32_t tau = prefix, fill = kk;

  // ---- mask: keep > tau, and the first `fill` ties in index order ----
  if (tid == 0) running = 0;
  for (int64_t base = 0; base < nb; base += TH_THREADS) {
    const int64_t b = base + tid;
    const bool valid = b < nb;
    uint32_t w[8];
    float m7 = 1.0f;
    if (valid) {
      const uint4 w0 = *reinterpret_cast<const uint4*>(codes + b * 32);
      const uint4 w1 = *reinterpret_cast<const uint4*>(codes + b * 32 + 16);
      w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
      w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
      m7 = scales[b] / 7.0f;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = 0x08080808u;  // zero codes
    }
    uint32_t ties = 0;
    if (valid) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int p = byte_of(w, j);
        ties += value_bits(low_code(p), m7) == tau;
        ties += value_bits(high_code(p), m7) == tau;
      }
    }
    // block-wide exclusive scan of the tie counts
    uint32_t incl = ties;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const uint32_t tot = warp_off[lane];
      uint32_t wi = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(FULL_MASK, wi, o);
        if (lane >= o) wi += t;
      }
      warp_off[lane] = wi - tot;
      if (lane == 31) chunk_ties = wi;
    }
    __syncthreads();
    if (valid) {
      uint32_t rank = running + warp_off[warp] + (incl - ties);
      uint32_t keep_lo = 0, keep_hi = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {  // elements 64b + j: low nibbles
        const uint32_t v = value_bits(low_code(byte_of(w, j)), m7);
        bool keep = v > tau;
        if (v == tau) keep = rank++ < fill;
        keep_lo |= (uint32_t)keep << j;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {  // elements 64b + 32 + j: high nibbles
        const uint32_t v = value_bits(high_code(byte_of(w, j)), m7);
        bool keep = v > tau;
        if (v == tau) keep = rank++ < fill;
        keep_hi |= (uint32_t)keep << j;
      }
      uint32_t o[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int p = byte_of(w, j);
        const int lo = (keep_lo >> j) & 1 ? low_code(p) : 0;
        const int hi = (keep_hi >> j) & 1 ? high_code(p) : 0;
        o[j >> 2] |= (uint32_t)(uint8_t)pack_byte(lo, hi) << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(out + b * 32) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(out + b * 32 + 16) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
    __syncthreads();
    if (tid == 0) running += chunk_ties;
    __syncthreads();
  }
}

}  // namespace clover

extern "C" int clover_threshold4(const int8_t* codes, const float* scales,
                                 int8_t* out, int64_t n_pad, int64_t k,
                                 void* stream) {
  clover::threshold4_kernel<<<1, clover::TH_THREADS, 0, (cudaStream_t)stream>>>(
      codes, scales, out, n_pad, k);
  return (int)cudaGetLastError();
}
