// The exact top-K select of one 4- or 8-bit vector (threshold.cu gives the
// order and the design), run by one CTA of THREADS threads: the standalone
// threshold kernel (1024 threads) and phase C of the chained iteration
// kernel (iteration.cu, 256).  The kept set is the unique golden selection,
// so every thread count writes the same bytes.
#pragma once
#include "common.cuh"

namespace clover {

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

// out = the n_pad-element vector (codes, scales) with all but its k largest
// |code * s/qmax| zeroed.  Every thread of the CTA calls it; CG reads codes
// and scales through ld_cg (another CTA of a cooperative launch wrote them).
template <int BITS, int THREADS, bool CG>
__device__ __forceinline__ void threshold_select(
    const int8_t* __restrict__ codes, const float* __restrict__ scales,
    int8_t* __restrict__ out, int64_t n_pad, int64_t k) {
  constexpr int BYTES = 8 * BITS;  // bytes of one 64-element block
  constexpr int BYTES_LOG2 = BITS == 4 ? 5 : 6;
  constexpr int WORDS = BYTES / 4;
  constexpr int WARPS = THREADS / 32;
  constexpr float QM = BITS == 4 ? 7.0f : 127.0f;
  __shared__ uint32_t hist[256];
  __shared__ uint32_t sel_digit, sel_rank, chunk_ties, running;
  __shared__ uint32_t warp_off[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t nb = n_pad / 64, nbytes = nb * BYTES;

  // ---- radix select: tau = K-th largest pattern, fill = ties to keep ----
  // (k = 0 keeps nothing: tau above every non-negative pattern, fill 0)
  uint32_t prefix = k > 0 ? 0u : 0xFFFFFFFFu, mask = 0, kk = (uint32_t)k;
  for (int shift = 24; k > 0 && shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (int64_t i = tid; i < nbytes; i += THREADS) {
      const int p = ld<CG>(codes + i);
      const float m = ld<CG>(scales + (i >> BYTES_LOG2)) / QM;
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
  for (int64_t base = 0; base < nb; base += THREADS) {
    const int64_t b = base + tid;
    const bool valid = b < nb;
    uint32_t w[WORDS];
    float m = 1.0f;
    if (valid) {
#pragma unroll
      for (int q = 0; q < WORDS / 4; ++q) {
        const uint4 v =
            ld<CG>(reinterpret_cast<const uint4*>(codes + b * BYTES + 16 * q));
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
      m = ld<CG>(scales + b) / QM;
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
      const bool mine = WARPS == 32 || lane < WARPS;
      const uint32_t tot = mine ? warp_off[lane] : 0u;
      uint32_t wi = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(FULL_MASK, wi, o);
        if (lane >= o) wi += t;
      }
      if (mine) warp_off[lane] = wi - tot;
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
