// Quantize: per-64-block (vector) or per-64x64-tile (matrix) absmax scale,
// stochastic rounding, 4-bit nibble pack.
//
// Replaces clover_tpu/kernels/quantize.py _qvec_kernel (quantize_vec_pallas)
// and _qmat_kernel (quantize_mat_pallas).
//
// Vector design: a warp owns a 64-element block, lane j holding elements j
// and j + 32, which are exactly the two nibbles of packed byte j: the warp
// max is the block scale, and lane j writes its byte without any exchange.
//
// Matrix bound.  A matrix reads 4 bytes and writes half a byte (4-bit) or
// one byte (8-bit) per element: 604 MB at 8192x16384 4-bit, 0.180 ms at
// 3.35 TB/s, which deterministic rounding nearly reaches.  Stochastic
// rounding adds one Philox4x32-10 evaluation per element, so there the
// kernel is bound by the SM's integer pipes, not memory: on an H100 a
// kernel of Philox alone (one philox_word0_32 an element in this thread
// map, no loads, no codes) takes 0.29 ms at 8192x16384, 73 cycles of an SM
// sub-partition per 32 elements, and 0.32 ms with the rounding.
// Matrix design (quantize_mat_kernel):
//   - A persistent grid of 256-thread CTAs, as many as fit on the card,
//     walks the matrix in row-major steps of TP tiles side by side.  A
//     thread's share of a 64x64 tile is rows r and r + 32 (r = tid / 8) by
//     elements 4k..4k+3 and 32+4k..32+4k+3 (k = tid % 8): four 16-byte
//     loads, and output bytes 4k..4k+3 of each row -- for 4-bit the nibble
//     pairs (j, j + 32) of packed bytes j = 4k..4k+3 -- written as one
//     32-bit store (two for 8-bit codes).
//   - The loads run ahead through a cp.async ring in shared memory, each
//     thread copying and later reading back its own 16-byte slots (so no
//     barrier guards the ring), steps of 2 tiles: deterministic rounding
//     keeps 2 steps in flight a CTA, SR 1.  The tile max: a warp max (a
//     warp holds 4 rows of one tile), then the 8 warps' maxima through
//     shared memory, double buffered by step parity, so one barrier a step.
//     (A warp-specialized SR kernel -- a producer warp filling a ring of
//     whole tiles, consumer warps or warp groups each owning a tile with no
//     CTA barrier -- measured 0.40 ms here against this design's 0.38, in
//     every arrangement tried: the consumers' own code, without loads or
//     waits, took 0.34-0.36 ms.)
//   - SR's noise.  Operands of fewer than 2^32 elements take 32-bit
//     counters (philox_word0_32: counter words 1-3 are 0, so rounds 0-2
//     fold around launch constants formed on the host), and the kernel
//     walks round 0's product M0 * index itself: an element's product is
//     one 64-bit add from the product of its row's first element, so 16
//     products an element remain of Philox's 20.  Larger operands take the
//     64-bit path (WIDE, philox_word0, the index walked), which the
//     wrapper picks.
//   - SR's rounding: the noise added by one fused add (the product w *
//     2^-24 is exact), a clamp, and an add of +-(1.5 * 2^23 + bias) rounded
//     down, whose low byte is the code's two's complement byte (biased by 8
//     for a low nibble); bytes are packed with byte permutes (sr_bits,
//     low_bytes).
// Every value is rounded in the op order of sr_code (common.cuh; sr_code_rd
// is the same function with one conversion fewer; sr_bits the same values
// in the bits of a float), so the bytes are those of quantize_mat_plain in
// both modes.
#include "common.cuh"

namespace clover {

__global__ void __launch_bounds__(256)
quantize_vec_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                    float* __restrict__ scales, int64_t nb, int bits,
                    int noise, uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= nb) return;  // uniform across the warp
  const float qm = bits == 4 ? 7.0f : 127.0f;
  const int64_t i0 = b * 64 + lane, i1 = i0 + 32;
  const float v0 = x[i0], v1 = x[i1];
  const float s = nonzero_scale(warp_max(fmaxf(fabsf(v0), fabsf(v1))));
  const float mult = qm / s;
  const int q0 = sr_code(v0, mult, qm, sr_noise(noise, seed, i0, 0));
  const int q1 = sr_code(v1, mult, qm, sr_noise(noise, seed, i1, 0));
  if (bits == 4) {
    codes[b * 32 + lane] = pack_byte(q0, q1);
  } else {
    codes[i0] = (int8_t)q0;
    codes[i1] = (int8_t)q1;
  }
  if (lane == 0) scales[b] = s;
}

// The launch constants of philox_word0_32 for one seed, formed on the
// host: the round keys k0 = seed + r * 0x9E3779B9, and the words that round
// 1's product of the key leaves (c2 is xored with its high half and
// round 1's k1, c3 is its low half, which round 2 xors with its k1).
struct PhiloxKeys {
  uint32_t k0[10];
  uint32_t c2_xor, c2_xor_2;
};

constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;

// The 64-bit product of two 32-bit words as one IMAD.WIDE.U32 (a product
// written in C with a 64-bit constant leaves an add of the constant's zero
// high word in the machine code).
__device__ __forceinline__ uint64_t mul_wide(uint32_t a, uint32_t b) {
  uint64_t r;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(r) : "r"(a), "r"(b));
  return r;
}

// philox_word0(seed, index, 0) for index < 2^32, from round 0's product
// p = M0 * index: the counter is (index, 0, 0, 0), so round 0 multiplies one
// word and leaves (seed, 0, hi, lo), round 1's first product is of the key
// alone, and round 2's c3 is its low half: 16 products here, and round 0's,
// where philox_word0 forms 20, each one IMAD.WIDE, its halves the __umulhi
// and the low product of philox_word0; each xor with a key reads the
// launch's constants.
__device__ __forceinline__ uint32_t philox_word0_32(const PhiloxKeys& key,
                                                    uint64_t p) {
  const uint64_t p1 = mul_wide(PHILOX_M1, (uint32_t)(p >> 32));  // round 1
  uint32_t c0 = (uint32_t)(p1 >> 32) ^ key.k0[1];
  uint32_t c1 = (uint32_t)p1;
  uint32_t c2 = (uint32_t)p ^ key.c2_xor;
  const uint64_t q0 = mul_wide(PHILOX_M0, c0);  // round 2
  const uint64_t q1 = mul_wide(PHILOX_M1, c2);
  c0 = (uint32_t)(q1 >> 32) ^ c1 ^ key.k0[2];
  c1 = (uint32_t)q1;
  c2 = (uint32_t)(q0 >> 32) ^ key.c2_xor_2;
  uint32_t c3 = (uint32_t)q0;
#pragma unroll
  for (int r = 3; r < 10; ++r) {
    const uint64_t s0 = mul_wide(PHILOX_M0, c0), s1 = mul_wide(PHILOX_M1, c2);
    c0 = (uint32_t)(s1 >> 32) ^ c1 ^ key.k0[r];
    c1 = (uint32_t)s1;
    c2 = (uint32_t)(s0 >> 32) ^ c3 ^ (uint32_t)(r * 0xBB67AE85u);
    c3 = (uint32_t)s0;
  }
  return c0;
}

// sr_code (common.cuh) with one conversion where it has two: qm is an
// integer, so floor(min(mag, qm)) = min(floor(mag), qm) for every mag >= 0,
// +inf included, and fminf takes qm from a NaN mag in both orders; the
// float-to-int conversion rounding down is the floor.
__device__ __forceinline__ int sr_code_rd(float x, float mult, float qm,
                                          float u) {
  const float mag = fabsf(x) * mult + u;
  const int q = __float2int_rd(fminf(mag, qm));
  return x < 0.0f ? -q : q;
}

// sr_code's code for noise word w, in the low byte of the result's bits,
// plus ``bias``: mag = |x| * mult + u as one fused add (u = (w & 0xFFFFFF) *
// 2^-24, whose product is exact, so the add rounds as sr_code's), clamped to
// qm; then magic = 1.5 * 2^23 + bias, signed as x, plus the clamped mag,
// rounded down: M + floor(m) for x >= 0, -(M - floor(m)) for x < 0, whose
// magnitudes lie in [2^23, 2^24), where a float's unit is 1, so the low
// byte of the bits is bias + code mod 256.
__device__ __forceinline__ uint32_t sr_bits(float x, float mult, float qm,
                                            uint32_t w, float magic) {
  const float mag = __fmaf_rn((float)(w & 0xFFFFFFu), 0x1p-24f,
                              fabsf(x) * mult);
  return __float_as_uint(__fadd_rd(copysignf(magic, x), fminf(mag, qm)));
}
constexpr float SR_MAGIC = 12582912.0f;  // 1.5 * 2^23

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The keys of philox_word0_32 for ``seed``.
inline PhiloxKeys philox_keys(uint32_t seed) {
  PhiloxKeys key;
  for (int r = 0; r < 10; ++r) key.k0[r] = seed + (uint32_t)r * 0x9E3779B9u;
  const uint64_t k = (uint64_t)0xD2511F53u * seed;
  key.c2_xor = (uint32_t)(k >> 32) ^ 0xBB67AE85u;
  key.c2_xor_2 = (uint32_t)k ^ 2u * 0xBB67AE85u;
  return key;
}

constexpr int QM_THREADS = 256;
constexpr int QM_WARPS = QM_THREADS / 32;
// A CTA's step is QM_TILES tiles side by side (a 64 x 128 strip, 32 KB of
// f32), and its cp.async ring holds STAGES steps, all but one in flight:
// deterministic rounding, bound by memory, 3 (96 KB); SR, bound by the
// integer pipes, 2, so that more CTAs share an SM.
constexpr int QM_TILES = 2;
template <bool NOISE>
__host__ __device__ constexpr int qm_stages() {
  return NOISE ? 2 : 3;
}
template <bool NOISE>
__host__ __device__ constexpr int qm_smem() {  // bytes of the ring
  return qm_stages<NOISE>() * QM_TILES * 4 * QM_THREADS * 16;
}

// An element's Philox counter as the kernel walks it: for 32-bit counters
// round 0's product M0 * index, which an index below 2^32 keeps exact in 64
// bits, so that the product of index + d is one 64-bit add (on the integer
// pipe) of M0 * d away; for 64-bit counters the index.
template <bool WIDE>
__device__ __forceinline__ uint64_t counter_of(int64_t index) {
  if constexpr (WIDE)
    return (uint64_t)index;
  else
    return mul_wide(PHILOX_M0, (uint32_t)index);
}

// The noise word of the element OFF after counter c.
template <bool WIDE, uint32_t OFF>
__device__ __forceinline__ uint32_t noise_word(const PhiloxKeys& key,
                                               uint64_t c) {
  if constexpr (WIDE)
    return philox_word0(key.k0[0], c + OFF, 0);
  else
    return philox_word0_32(key, c + (uint64_t)PHILOX_M0 * OFF);
}

// sr_bits of the four elements OFF .. OFF + 3 after counter c.
template <bool WIDE, uint32_t OFF>
__device__ __forceinline__ void sr_quad(const float4& v, float mult, float qm,
                                        float magic, const PhiloxKeys& key,
                                        uint64_t c, uint32_t (&out)[4]) {
  out[0] = sr_bits(v.x, mult, qm, noise_word<WIDE, OFF>(key, c), magic);
  out[1] = sr_bits(v.y, mult, qm, noise_word<WIDE, OFF + 1>(key, c), magic);
  out[2] = sr_bits(v.z, mult, qm, noise_word<WIDE, OFF + 2>(key, c), magic);
  out[3] = sr_bits(v.w, mult, qm, noise_word<WIDE, OFF + 3>(key, c), magic);
}

// A step of the row-major step order and its (tile row, step column),
// advanced by a fixed stride without a division.
struct StepAt {
  int64_t t, ti, sj;
  __device__ __forceinline__ void advance(int64_t by, int64_t by_rows,
                                          int64_t by_cols, int64_t ns) {
    t += by;
    ti += by_rows;
    sj += by_cols;
    if (sj >= ns) {
      sj -= ns;
      ++ti;
    }
  }
};

// Copies of this thread's 16 TP elements of step (ti, sj) into ring stage
// ``stage``, committed as one group (an empty group past the last step, so
// that every thread counts groups alike): slot [stage][4p + 2h + q][tid] =
// tile p of the step, row r + 32 h, elements 4k + 32 q ... + 3.
template <int TP>
__device__ __forceinline__ void fetch_step(const float* __restrict__ a,
                                           float4* ring, int stage,
                                           const StepAt& at, int64_t steps,
                                           int64_t n_pad, int r, int k) {
  if (at.t < steps) {
    const float* p = a + (at.ti * 64 + r) * n_pad + at.sj * 64 * TP + 4 * k;
#pragma unroll
    for (int t = 0; t < TP; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          cp_async16(ring + ((stage * TP + t) * 4 + 2 * h + q) * QM_THREADS +
                         threadIdx.x,
                     p + h * 32 * n_pad + t * 64 + q * 32);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int BITS, bool NOISE, bool WIDE>
__global__ void __launch_bounds__(QM_THREADS)
quantize_mat_kernel(const float* __restrict__ a, int8_t* __restrict__ codes,
                    float* __restrict__ scales, int64_t steps, int64_t ns,
                    int64_t n_pad, const PhiloxKeys key) {
  constexpr int TP = QM_TILES, STAGES = qm_stages<NOISE>();
  extern __shared__ float4 ring[];  // [STAGES][TP][4][QM_THREADS]
  __shared__ float warp_amax[2][TP][QM_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = threadIdx.x >> 3, k = threadIdx.x & 7;
  constexpr float qm = BITS == 4 ? 7.0f : 127.0f;
  // a low nibble is biased by 8 (formats.py)
  constexpr float lo_magic = BITS == 4 ? SR_MAGIC + 8.0f : SR_MAGIC;
  const int64_t by = gridDim.x, by_rows = by / ns, by_cols = by % ns;
  StepAt at = {blockIdx.x, blockIdx.x / ns, blockIdx.x % ns};
  StepAt ahead = at;
#pragma unroll
  for (int stage = 0; stage < STAGES - 1; ++stage) {
    fetch_step<TP>(a, ring, stage, ahead, steps, n_pad, r, k);
    ahead.advance(by, by_rows, by_cols, ns);
  }
  for (int i = 0; at.t < steps; ++i) {
    // the stage read last time round is this thread's own: refill it
    fetch_step<TP>(a, ring, (i + STAGES - 1) % STAGES, ahead, steps, n_pad, r,
                   k);
    ahead.advance(by, by_rows, by_cols, ns);
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 1) : "memory");
    const float4* slot =
        ring + (i % STAGES) * TP * 4 * QM_THREADS + threadIdx.x;
    float4 v[TP][2][2];
#pragma unroll
    for (int t = 0; t < TP; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          v[t][h][q] = slot[(t * 4 + 2 * h + q) * QM_THREADS];
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      float m = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          m = fmaxf(m, fmaxf(fmaxf(fabsf(v[t][h][q].x), fabsf(v[t][h][q].y)),
                             fmaxf(fabsf(v[t][h][q].z),
                                   fabsf(v[t][h][q].w))));
      m = warp_max(m);
      if (lane == 0) warp_amax[i & 1][t][warp] = m;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      float s = warp_amax[i & 1][t][0];
#pragma unroll
      for (int w = 1; w < QM_WARPS; ++w)
        s = fmaxf(s, warp_amax[i & 1][t][w]);
      s = nonzero_scale(s);
      const float mult = qm / s;
      const int64_t tj = at.sj * TP + t;
      const int64_t row = at.ti * 64 + r, col = tj * 64 + 4 * k;
      if constexpr (NOISE) {
        // the counters of the thread's first element in rows r and r + 32
        const uint64_t c0 = counter_of<WIDE>(row * n_pad + col);
        const uint64_t c_half = counter_of<WIDE>(32 * n_pad);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint64_t c = h ? c0 + c_half : c0;
          uint32_t lo[4], hi[4];
          sr_quad<WIDE, 0>(v[t][h][0], mult, qm, lo_magic, key, c, lo);
          sr_quad<WIDE, 32>(v[t][h][1], mult, qm, SR_MAGIC, key, c, hi);
          if constexpr (BITS == 4) {
            // byte j: element 4k + j's code + 8, element 32 + 4k + j's above
            *reinterpret_cast<uint32_t*>(codes + (row + h * 32) * (n_pad / 2) +
                                         tj * 32 + 4 * k) =
                low_bytes(lo[0], lo[1], lo[2], lo[3]) |
                ((low_bytes(hi[0], hi[1], hi[2], hi[3]) << 4) & 0xF0F0F0F0u);
          } else {
            int8_t* o = codes + (row + h * 32) * n_pad + col;
            *reinterpret_cast<uint32_t*>(o) =
                low_bytes(lo[0], lo[1], lo[2], lo[3]);
            *reinterpret_cast<uint32_t*>(o + 32) =
                low_bytes(hi[0], hi[1], hi[2], hi[3]);
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int c[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float x[4] = {v[t][h][q].x, v[t][h][q].y, v[t][h][q].z,
                                v[t][h][q].w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              c[q][j] = sr_code_rd(x[j], mult, qm, 0.0f);
          }
          if constexpr (BITS == 4) {
            uint32_t w = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              w |= (uint32_t)(uint8_t)pack_byte(c[0][j], c[1][j]) << (8 * j);
            *reinterpret_cast<uint32_t*>(codes + (row + h * 32) * (n_pad / 2) +
                                         tj * 32 + 4 * k) = w;
          } else {
            int8_t* o = codes + (row + h * 32) * n_pad + col;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              uint32_t w = 0;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                w |= (uint32_t)(uint8_t)c[q][j] << (8 * j);
              *reinterpret_cast<uint32_t*>(o + q * 32) = w;
            }
          }
        }
      }
      if (threadIdx.x == 0) scales[at.ti * ns * TP + tj] = s;
    }
    at.advance(by, by_rows, by_cols, ns);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <int BITS, bool NOISE, bool WIDE>
int launch_qmat(const float* a, int8_t* codes, float* scales, int64_t m_pad,
                int64_t n_pad, uint32_t seed, cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  // CTAs of this instance that a device holds at once, found at its first
  // launch there (the host calls cost more than a small launch)
  static int64_t fill[MAX_DEVICES] = {};
  auto kernel = quantize_mat_kernel<BITS, NOISE, WIDE>;
  constexpr int smem = qm_smem<NOISE>();
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (fill[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  QM_THREADS, smem);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fill[device] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  }
  // n_pad is a multiple of 128, so a tile row holds whole steps
  const int64_t ns = n_pad / 64 / QM_TILES, steps = m_pad / 64 * ns;
  const unsigned grid =
      (unsigned)(steps < fill[device] ? steps : fill[device]);
  kernel<<<grid, QM_THREADS, smem, stream>>>(a, codes, scales, steps, ns,
                                             n_pad, philox_keys(seed));
  return (int)cudaGetLastError();
}

template <int BITS, bool NOISE>
int launch_quantize_mat(const float* a, int8_t* codes, float* scales,
                        int64_t m_pad, int64_t n_pad, int wide, uint32_t seed,
                        cudaStream_t stream) {
  return wide ? launch_qmat<BITS, NOISE, true>(a, codes, scales, m_pad, n_pad,
                                                seed, stream)
              : launch_qmat<BITS, NOISE, false>(a, codes, scales, m_pad,
                                                 n_pad, seed, stream);
}

}  // namespace clover

extern "C" int clover_quantize_vec(const float* x, int8_t* codes, float* scales,
                                   int64_t n_pad, int bits, int noise,
                                   uint32_t seed, void* stream) {
  const int64_t nb = n_pad / 64;
  const unsigned grid = (unsigned)((nb + 7) / 8);
  clover::quantize_vec_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      x, codes, scales, nb, bits, noise, seed);
  return (int)cudaGetLastError();
}

// wide: 64-bit element counters (kernels/quantize.py counter_bits picks
// them for operands of 2^32 elements or more)
extern "C" int clover_quantize_mat(const float* a, int8_t* codes, float* scales,
                                   int64_t m_pad, int64_t n_pad, int bits,
                                   int noise, int wide, uint32_t seed,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 4)
    return noise ? clover::launch_quantize_mat<4, true>(a, codes, scales,
                                                        m_pad, n_pad, wide,
                                                        seed, s)
                 : clover::launch_quantize_mat<4, false>(a, codes, scales,
                                                         m_pad, n_pad, wide,
                                                         seed, s);
  return noise ? clover::launch_quantize_mat<8, true>(a, codes, scales, m_pad,
                                                      n_pad, wide, seed, s)
               : clover::launch_quantize_mat<8, false>(a, codes, scales,
                                                       m_pad, n_pad, wide,
                                                       seed, s);
}

extern "C" const char* clover_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
