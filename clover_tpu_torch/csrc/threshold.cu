// Exact hard threshold of a 4- or 8-bit vector: keep the K largest
// |code * s/qmax|, zero the rest.
//
// Replaces clover_tpu/kernels/threshold.py _kernel4 (threshold4_pallas) and
// _kernel8 (threshold8_pallas).
//
// Order is the golden one (clover_tpu/golden.py threshold): |value|
// descending, then index ascending.  |value| is compared as the bit pattern
// of the f32 product |code| * (s/qmax), the expression of both TPU kernels
// (s/qmax divided first, IEEE), whose non-negative patterns order like the
// values.  Scales are never touched.
//
// Design: one CTA of 1024 threads per vector; a stacked batch of B vectors
// (rows of n_pad elements, contiguous) launches B CTAs, blockIdx.x picking
// the row, as clover_tpu vmaps the threshold over a batch
// (models/batch.py).  A radix select over the 32-bit patterns,
// four passes of 8 bits with a shared 256-bin histogram, finds the exact
// K-th largest pattern tau and how many ties at tau to keep; neither leaves
// the device.  A last pass gives each thread one 64-element block, counts
// its ties in index order, takes a block-wide exclusive scan of the counts
// (carried across chunks of 1024 blocks), and writes the kept codes (packed
// again for 4 bits).  Bound: at the solver's n = 16384 the 8 or 16 KB of
// codes sit in L1/L2, so the time is the passes' latency on one SM, not
// bandwidth: the known limit of a single-CTA select.  The TPU kernels'
// bisection, indicator matmuls and triangular-matmul prefix sums were
// workarounds for Mosaic's lack of sort, scatter and scan.
#include "common.cuh"

namespace clover {

constexpr int TH_THREADS = 1024;

__device__ __forceinline__ uint32_t value_bits(int code, float m) {
  return __float_as_uint((float)abs(code) * m);
}

// One histogram count for a pattern that matches the digits selected so far.
__device__ __forceinline__ void count_digit(uint32_t* hist, uint32_t v,
                                            uint32_t mask, uint32_t prefix,
                                            int shift) {
  if ((v & mask) == prefix) atomicAdd(&hist[(v >> shift) & 255u], 1u);
}

template <int W>
__device__ __forceinline__ int byte_of(const uint32_t (&w)[W], int j) {
  return (int)(int8_t)((w[j >> 2] >> (8 * (j & 3))) & 0xFFu);
}

// Code of element j (0..63) of a block held as words: 4-bit element j < 32
// is the low nibble of byte j, element j >= 32 the high nibble of byte
// j - 32; 8-bit element j is byte j.
template <int BITS, int W>
__device__ __forceinline__ int element(const uint32_t (&w)[W], int j) {
  if constexpr (BITS == 4)
    return j < 32 ? low_code(byte_of(w, j)) : high_code(byte_of(w, j - 32));
  else
    return byte_of(w, j);
}

template <int BITS>
__global__ void __launch_bounds__(TH_THREADS)
threshold_kernel(const int8_t* __restrict__ codes,
                 const float* __restrict__ scales, int8_t* __restrict__ out,
                 int64_t n_pad, int64_t k) {
  constexpr int BYTES = 8 * BITS;  // bytes of one 64-element block
  constexpr int BYTES_LOG2 = BITS == 4 ? 5 : 6;
  constexpr int WORDS = BYTES / 4;
  constexpr float QM = BITS == 4 ? 7.0f : 127.0f;
  __shared__ uint32_t hist[256];
  __shared__ uint32_t sel_digit, sel_rank, chunk_ties, running;
  __shared__ uint32_t warp_off[TH_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t nb = n_pad / 64, nbytes = nb * BYTES;
  codes += blockIdx.x * nbytes;  // this CTA's row of a stacked batch
  scales += blockIdx.x * nb;
  out += blockIdx.x * nbytes;

  // ---- radix select: tau = K-th largest pattern, fill = ties to keep ----
  // (k = 0 keeps nothing: tau above every non-negative pattern, fill 0)
  uint32_t prefix = k > 0 ? 0u : 0xFFFFFFFFu, mask = 0, kk = (uint32_t)k;
  for (int shift = 24; k > 0 && shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += TH_THREADS) hist[i] = 0;
    __syncthreads();
    for (int64_t i = tid; i < nbytes; i += TH_THREADS) {
      const int p = codes[i];
      const float m = scales[i >> BYTES_LOG2] / QM;
      if constexpr (BITS == 4) {
        count_digit(hist, value_bits(low_code(p), m), mask, prefix, shift);
        count_digit(hist, value_bits(high_code(p), m), mask, prefix, shift);
      } else {
        count_digit(hist, value_bits(p, m), mask, prefix, shift);
      }
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
    uint32_t w[WORDS];
    float m = 1.0f;
    if (valid) {
#pragma unroll
      for (int q = 0; q < WORDS / 4; ++q) {
        const uint4 v = *reinterpret_cast<const uint4*>(codes + b * BYTES + 16 * q);
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
      m = scales[b] / QM;
    } else {
#pragma unroll
      for (int j = 0; j < WORDS; ++j) w[j] = BITS == 4 ? 0x08080808u : 0u;
    }
    uint32_t ties = 0;
    if (valid) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        ties += value_bits(element<BITS>(w, j), m) == tau;
        ties += value_bits(element<BITS>(w, j + 32), m) == tau;
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
      uint32_t keep_lo = 0, keep_hi = 0;  // elements 64b + j, 64b + 32 + j
#pragma unroll
      for (int j = 0; j < 32; ++j) {  // in index order
        const uint32_t v = value_bits(element<BITS>(w, j), m);
        bool keep = v > tau;
        if (v == tau) keep = rank++ < fill;
        keep_lo |= (uint32_t)keep << j;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t v = value_bits(element<BITS>(w, j + 32), m);
        bool keep = v > tau;
        if (v == tau) keep = rank++ < fill;
        keep_hi |= (uint32_t)keep << j;
      }
      uint32_t o[WORDS];
#pragma unroll
      for (int j = 0; j < WORDS; ++j) o[j] = 0u;
#pragma unroll
      for (int j = 0; j < BYTES; ++j) {
        const int p = byte_of(w, j);
        uint32_t byte;
        if constexpr (BITS == 4) {
          const int lo = (keep_lo >> j) & 1 ? low_code(p) : 0;
          const int hi = (keep_hi >> j) & 1 ? high_code(p) : 0;
          byte = (uint8_t)pack_byte(lo, hi);
        } else {
          const uint32_t kept = j < 32 ? keep_lo >> j : keep_hi >> (j - 32);
          byte = kept & 1 ? (uint32_t)(uint8_t)p : 0u;
        }
        o[j >> 2] |= byte << (8 * (j & 3));
      }
#pragma unroll
      for (int q = 0; q < WORDS / 4; ++q)
        *reinterpret_cast<uint4*>(out + b * BYTES + 16 * q) =
            make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    }
    __syncthreads();
    if (tid == 0) running += chunk_ties;
    __syncthreads();
  }
}

}  // namespace clover

extern "C" int clover_threshold(const int8_t* codes, const float* scales,
                                int8_t* out, int64_t n_pad, int64_t k,
                                int bits, int64_t batch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)batch;
  if (bits == 4)
    clover::threshold_kernel<4><<<grid, clover::TH_THREADS, 0, s>>>(
        codes, scales, out, n_pad, k);
  else
    clover::threshold_kernel<8><<<grid, clover::TH_THREADS, 0, s>>>(
        codes, scales, out, n_pad, k);
  return (int)cudaGetLastError();
}
