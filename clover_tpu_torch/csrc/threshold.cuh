// The exact top-K select of one 4- or 8-bit vector, run by one CTA of
// THREADS threads: the standalone threshold kernel (threshold.cu, 1024
// threads) and phase C of the chained iteration kernel (iteration.cu, 256
// threads, in every CTA).  threshold.cu gives the order and the design.
// The kept set is the unique golden selection, so every thread count and
// both paths below write the same bytes.
//
// A slot is 16 index-contiguous elements of one 64-element block: slot g
// holds elements 16g ... 16g + 15, block g / 4, quarter q = g % 4.  8-bit:
// bytes 16g ... 16g + 15.  4-bit: element j < 32 of a block is the low
// nibble of byte j, element j >= 32 the high nibble of byte j - 32, so
// quarters q and q + 2 (q < 2) share bytes 16q ... 16q + 15 of the block,
// the low and the high nibbles.  The resident path gives thread t the
// slots R t ... R t + R - 1, the streaming path the slots t, t + THREADS,
// ...
#pragma once
#include "common.cuh"

namespace clover {

// Radix digits, most significant first: bits 31..20, 19..10, 9..0.
constexpr int SEL_BINS0 = 4096, SEL_BINS = 1024;

// The select's shared memory.
template <int THREADS>
struct SelectSmem {
  uint32_t hist0[SEL_BINS0];  // pass 0; pass 2 reuses its first SEL_BINS
  uint32_t hist1[SEL_BINS];   // pass 1
  uint32_t wsum[2][THREADS / 32];
  uint32_t wlo[THREADS / 32], whi[THREADS / 32];  // per warp, in a pass
  uint32_t sel_digit, sel_rank;
};

// The f32 pattern of mag * m, mag a small non-negative integer: the float
// 2^23 + mag less 2^23 is mag exactly, so this is the bits of (float)mag *
// m without an integer conversion (a quarter-rate instruction).
__device__ __forceinline__ uint32_t mag_bits(uint32_t mag, float m) {
  return __float_as_uint((__uint_as_float(0x4B000000u | mag) - 8388608.0f) *
                         m);
}

// The 16 magnitudes |code| of a slot as bytes of 4 words: 8-bit codes as
// they are; 4-bit, the low nibbles (codes v - 8) or the high nibbles
// (signed) of its 16 bytes.  __vabs4 keeps |-128| = 128.
template <int BITS>
__device__ __forceinline__ void slot_mags(const uint4& w, bool high,
                                          uint32_t (&mag)[4]) {
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t c = in[j];
    if constexpr (BITS == 4)
      c = high ? __vsub4(((c >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u)
               : __vsub4(c & 0x0F0F0F0Fu, 0x08080808u);
    mag[j] = __vabs4(c);
  }
}

struct Slot {
  uint4 w;         // the slot's 16 code bytes (4-bit: 16 of 32 nibbles its)
  uint32_t p[16];  // the patterns |code| * m of its elements
};

// Slot g of the vector: its codes and the patterns of its elements (m =
// s / qmax, one IEEE division a slot); zeros when !valid.
template <int BITS, bool CG>
__device__ __forceinline__ void make_slot(Slot& s, const int8_t* codes,
                                          const float* scales, int64_t g,
                                          bool valid) {
  constexpr float QM = BITS == 4 ? 7.0f : 127.0f;
  float m = 0.0f;
  s.w = make_uint4(0u, 0u, 0u, 0u);
  if (valid) {
    const int64_t off = BITS == 4 ? (g >> 2) * 32 + 16 * (g & 1) : g * 16;
    s.w = ld<CG>(reinterpret_cast<const uint4*>(codes + off));
    m = ld<CG>(scales + (g >> 2)) / QM;
  }
  uint32_t mag[4];
  slot_mags<BITS>(s.w, BITS == 4 && (g & 3) >= 2, mag);
#pragma unroll
  for (int e = 0; e < 16; ++e)
    s.p[e] = mag_bits(__byte_perm(mag[e >> 2], 0, 0x4440 | (e & 3)), m);
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// One radix pass over the patterns that have ``prefix`` under ``mask``
// (pass 0: all of them): the histogram of digit (p >> SHIFT) & (BINS - 1),
// and after pass 0 the least and greatest such pattern.  If those are
// equal, tau is that pattern; else the digit whose bin holds the kk-th
// largest, and kk becomes its rank in the bin.  Returns true when tau is
// found.
template <int BITS, int THREADS, int BINS, int SHIFT, int P, typename Slots>
__device__ __forceinline__ bool radix_pass(SelectSmem<THREADS>& sm,
                                           uint32_t* hist, Slots&& slots,
                                           uint32_t& prefix, uint32_t& mask,
                                           uint32_t& kk) {
  constexpr int WARPS = THREADS / 32, BPT = BINS / THREADS;
  static_assert(BINS % THREADS == 0 && BINS % 128 == 0, "whole bins");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t lo = 0xFFFFFFFFu, hi = 0u;
  slots([&](const Slot& s, bool valid) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t p = s.p[e];
      if (!valid) continue;
      if constexpr (P == 0) {
        atomicAdd(&hist[p >> SHIFT], 1u);
      } else if ((p & mask) == prefix) {
        atomicAdd(&hist[(p >> SHIFT) & (BINS - 1)], 1u);
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
  });
  if constexpr (P > 0) {
    lo = __reduce_min_sync(FULL_MASK, lo);
    hi = __reduce_max_sync(FULL_MASK, hi);
    if (lane == 0) {
      sm.wlo[warp] = lo;
      sm.whi[warp] = hi;
    }
  }
  __syncthreads();
  if constexpr (P > 0) {
    lo = __reduce_min_sync(FULL_MASK, lane < WARPS ? sm.wlo[lane] : lo);
    hi = __reduce_max_sync(FULL_MASK, lane < WARPS ? sm.whi[lane] : hi);
    if (lo == hi) {  // one pattern left: it is tau
      prefix = lo;
      mask = 0xFFFFFFFFu;
      return true;
    }
  }
  // bins in descending digit order: thread t scans top, top - 1, ...
  const int top = BINS - 1 - tid * BPT;
  uint32_t c[BPT], tot = 0;
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    c[j] = hist[top - j];
    tot += c[j];
  }
  const uint32_t incl = warp_incl_scan(tot, lane);
  if (lane == 31) sm.wsum[0][warp] = incl;
  __syncthreads();
  const uint32_t wt = lane < WARPS ? sm.wsum[0][lane] : 0u;
  const uint32_t wi = warp_incl_scan(wt, lane);
  const uint32_t excl = __shfl_sync(FULL_MASK, wi - wt, warp) + incl - tot;
  if (excl < kk && kk <= excl + tot) {
    uint32_t cum = excl;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if (cum + c[j] >= kk) {
        sm.sel_digit = (uint32_t)(top - j);
        sm.sel_rank = kk - cum;
        break;
      }
      cum += c[j];
    }
  }
  __syncthreads();
  prefix |= sm.sel_digit << SHIFT;
  mask |= (uint32_t)(BINS - 1) << SHIFT;
  kk = sm.sel_rank;
  return false;
}

// 0xFF in byte i of the result for bit i of b (i < 4).
__device__ __forceinline__ uint32_t byte_mask(uint32_t b) {
  return (((b & 0xFu) * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// out = the vector with all but its k largest |code * s/qmax| zeroed, the
// ties at the K-th kept in index order.  ``slots(f)`` calls f(slot, valid)
// for every slot of the thread; ``chunk(c, h)`` calls h(each) once, and
// each(f) calls f(slot, valid, g) for the thread's slots g of chunk c in
// index order, every thread's slots of a chunk after those of lower
// threads and before the next chunk's (``nchunks`` chunks).  A 4-bit slot
// of quarter q >= 2 (high nibbles) sits PARTNER lanes above the slot of
// quarter q - 2 at the same place in its thread.  Every thread of the CTA
// calls it.
template <int BITS, int THREADS, int PARTNER, typename Slots, typename Chunk>
__device__ __forceinline__ void select_body(SelectSmem<THREADS>& sm,
                                            Slots&& slots, Chunk&& chunk,
                                            int64_t nchunks, int64_t n_pad,
                                            int64_t k,
                                            int8_t* __restrict__ out) {
  constexpr int WARPS = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < SEL_BINS0; i += THREADS) sm.hist0[i] = 0;
  for (int i = tid; i < SEL_BINS; i += THREADS) sm.hist1[i] = 0;
  __syncthreads();

  // ---- radix select: tau = the K-th largest pattern, fill = ties kept ----
  // (k = 0 keeps nothing: tau above every non-negative pattern, fill 0)
  uint32_t prefix = 0xFFFFFFFFu, mask = 0, kk = 0;
  if (k > 0) {
    prefix = 0;
    kk = (uint32_t)(k < n_pad ? k : n_pad);
    radix_pass<BITS, THREADS, SEL_BINS0, 20, 0>(sm, sm.hist0, slots, prefix,
                                                mask, kk);
    for (int i = tid; i < SEL_BINS; i += THREADS) sm.hist0[i] = 0;
    if (!radix_pass<BITS, THREADS, SEL_BINS, 10, 1>(sm, sm.hist1, slots,
                                                     prefix, mask, kk))
      radix_pass<BITS, THREADS, SEL_BINS, 0, 2>(sm, sm.hist0, slots, prefix,
                                                mask, kk);
  }
  const uint32_t tau = prefix, fill = kk;

  // ---- mask: keep > tau, and the first `fill` ties in index order ----
  uint32_t running = 0;  // ties in earlier chunks
  for (int64_t c = 0; c < nchunks; ++c) chunk(c, [&](auto&& each) {
    uint32_t ties = 0;
    each([&](const Slot& s, bool valid, int64_t) {
#pragma unroll
      for (int e = 0; e < 16; ++e) ties += valid && s.p[e] == tau;
    });
    const uint32_t incl = warp_incl_scan(ties, lane);
    if (lane == 31) sm.wsum[c & 1][warp] = incl;
    __syncthreads();
    const uint32_t wt = lane < WARPS ? sm.wsum[c & 1][lane] : 0u;
    const uint32_t wi = warp_incl_scan(wt, lane);
    uint32_t rank = running + __shfl_sync(FULL_MASK, wi - wt, warp) +
                    incl - ties;
    running += __shfl_sync(FULL_MASK, wi, 31);
    each([&](const Slot& s, bool valid, int64_t g) {
      uint32_t keep = 0;  // bit e: element e of the slot is kept
#pragma unroll
      for (int e = 0; e < 16; ++e) keep |= (uint32_t)(s.p[e] > tau) << e;
      if (valid && rank < fill) {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (s.p[e] == tau) keep |= (uint32_t)(rank++ < fill) << e;
      }
      const uint32_t w[4] = {s.w.x, s.w.y, s.w.z, s.w.w};
      uint32_t o[4];
      if constexpr (BITS == 4) {
        // quarter q < 2 writes its bytes: its low nibbles and, from its
        // partner, the high nibbles (a dropped low nibble is code 0, i.e.
        // 8)
        const uint32_t keep_hi = __shfl_down_sync(FULL_MASK, keep, PARTNER);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t lo = byte_mask(keep >> (4 * j));
          const uint32_t hi = byte_mask(keep_hi >> (4 * j));
          o[j] = (w[j] & lo & 0x0F0F0F0Fu) | (~lo & 0x08080808u) |
                 (w[j] & hi & 0xF0F0F0F0u);
        }
        if (valid && (g & 3) < 2)
          *reinterpret_cast<uint4*>(out + (g >> 2) * 32 + 16 * (g & 1)) =
              make_uint4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = w[j] & byte_mask(keep >> (4 * j));
        if (valid)
          *reinterpret_cast<uint4*>(out + g * 16) =
              make_uint4(o[0], o[1], o[2], o[3]);
      }
    });
  });
}

// The select with the vector's slots held in registers, R a thread: for
// n_pad <= 16 * R * THREADS.  Thread t holds slots R t ... R t + R - 1, so
// the mask pass is one chunk.  Codes and scales are read once.  CG reads
// them through ld_cg (another CTA of a cooperative launch wrote them).
template <int BITS, int THREADS, int R, bool CG>
__device__ __forceinline__ void select_resident(
    SelectSmem<THREADS>& sm, const int8_t* __restrict__ codes,
    const float* __restrict__ scales, int8_t* out, int64_t n_pad,
    int64_t k) {
  static_assert(R == 1 || R == 2, "a 4-bit slot's partner is another lane");
  const int tid = threadIdx.x;
  const int64_t nq = n_pad / 16;
  Slot reg[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t g = (int64_t)tid * R + r;
    make_slot<BITS, CG>(reg[r], codes, scales, g, g < nq);
  }
  auto slots = [&](auto&& f) {
#pragma unroll
    for (int r = 0; r < R; ++r) f(reg[r], (int64_t)tid * R + r < nq);
  };
  auto chunk = [&](int64_t, auto&& h) {
    h([&](auto&& f) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t g = (int64_t)tid * R + r;
        f(reg[r], g < nq, g);
      }
    });
  };
  select_body<BITS, THREADS, 2 / R>(sm, slots, chunk, 1, n_pad, k, out);
}

// The select streaming its slots from memory in every pass: any n_pad.
template <int BITS, int THREADS>
__device__ __forceinline__ void select_stream(SelectSmem<THREADS>& sm,
                                              const int8_t* __restrict__ codes,
                                              const float* __restrict__ scales,
                                              int8_t* out, int64_t n_pad,
                                              int64_t k) {
  const int tid = threadIdx.x;
  const int64_t nq = n_pad / 16, nchunks = (nq + THREADS - 1) / THREADS;
  auto chunk = [&](int64_t c, auto&& h) {
    const int64_t g = c * THREADS + tid;
    Slot s;
    make_slot<BITS, false>(s, codes, scales, g, g < nq);
    h([&](auto&& f) { f(s, g < nq, g); });
  };
  auto slots = [&](auto&& f) {
    for (int64_t c = 0; c < nchunks; ++c)
      chunk(c, [&](auto&& each) {
        each([&](const Slot& s, bool valid, int64_t) { f(s, valid); });
      });
  };
  select_body<BITS, THREADS, 2>(sm, slots, chunk, nchunks, n_pad, k, out);
}

}  // namespace clover
