// Batched requantizing MVM: 1 <= B <= 32 vectors against one 4- or 8-bit
// matrix A, modes 4x4 (4-bit output), 4x8 and 8x8 (8-bit output), and its
// f32-output mode, on the int8 tensor cores.
//
// Replaces clover_tpu/kernels/mvm_batched.py mvm_batched_pallas (bodies
// _kernel_4x4_b, _kernel_4x8_b, _kernel_8x8_b, epilogue _epilogue_b) in its
// requantizing modes, and mvm_batched_pallas_f32 (the same bodies,
// _build_call_b with out_bits 32): with F32 the kernel writes vector j's
// f32 row sums y_j to out_f32[j, row] instead of requantizing, for the
// sharded server, which sums the shards' partials first
// (clover_tpu/parallel/ops.py mvm_batched_psum).  Vector j's output is that
// of csrc/mvm.cu without the AXPY epilogue, with seed1 = seed + j:
//
//   y_j = A x_j        exact int32 dot per (row, 64-block), times
//                      (sA/qA)*(sx_j/qx) in f32, summed in mvm.cu's order
//   out_j = band-requant(y_j)   absmax, SR (Philox leg 0, seed + j,
//                               counter = output row), per 64-row band
//
// so each vector's codes and scales equal a single-vector launch bit for
// bit.  (The TPU kernel's seed base + i*B + j follows its row tiles; the
// seed + j here is that of clover_tpu's vmapped path, ops/gemm.py.)
//
// Bound: device memory, 0.020 ms for A at 8192x16384 4-bit on an H100.
// A is streamed once for all B vectors (2 int8 multiply-adds per packed
// 4-bit byte per vector, at most 64 per byte at B = 32), so the work is a
// few percent of the int8 tensor-core peak; what must keep up with the
// memory is the issue of the nibble unpacking and of the exact f32
// combine (a multiply and an add per row, block and vector, in a fixed
// order), and the x bytes each CTA reads again from L2.  Design:
//   - Block dots on mma.sync.m16n8k32 s8 x s8 -> s32: 16 rows of A by 8
//     vectors (an n-tile), two steps of depth 32 per 64-element block, so
//     no mma spans two blocks (each block has its own scale).  Within a
//     block the k order is free (the integer sum is exact), so each lane
//     loads contiguous bytes: for 4-bit A, bytes 8t ... 8t + 7 of the
//     block (t = lane % 4), whose low nibbles are elements 8t ... 8t + 7
//     (step 0) and high nibbles elements 8t + 32 ... (step 1), unpacked to
//     s8 in registers; for 8-bit A, bytes 16t ... 16t + 15 (elements 16t
//     ... 16t + 7 in step 0, the rest in step 1).  The x fragment pairs the
//     same elements: x's bytes at the same offsets when it is packed like
//     A (4x4) or 8-bit with 8-bit A; for 4x8 the bytes 8t ... and 32 + 8t
//     ... of x's 64-byte block.  The accumulator enters the first mma as
//     0x4B400000, the bits of 1.5 * 2^23, so the tensor core adds the
//     exact dot d (|d| <= 2^20) to it and float(d) is one f32 subtract,
//     with no integer conversion.
//   - Groups are warps.  A CTA's G warps are mvm.cu's G lane groups (16
//     for 4-bit A, 8 for 8-bit): warp g adds the products of blocks g, g +
//     G, g + 2G, ... in that order from 0, so no group's chain is split.
//     The G partials of each (row, vector) then meet in shared memory and
//     reduce as (g, g + G/2), (g, g + G/4), ..., mvm.cu's tree.  Blocks
//     past the row's last add exactly +0, as in blocked_sum.
//   - One pass over A for every B <= 32: each warp runs NT = cdiv(B, 8)
//     n-tiles against each A fragment of its MT m-tiles (mb_tiles: MT = 4,
//     a 64-row band per CTA, for 4-bit A up to B = 24; else MT = 2, a band
//     a cluster of two CTAs, each storing its 32 row sums per vector into
//     the leader's shared memory, as mvm.cu does).  The band's leader
//     requantizes it, one vector per warp.  The f32 mode needs no cluster:
//     each CTA writes its rows.
//   - Loads stay in flight: a register ring of P chunks per warp (the loads
//     of chunk c + P - 1 are issued before chunk c is consumed), A read
//     with ld.global.cs (touched once).
//   - Each block scale over q is divided once per warp, not once per lane
//     and chunk (those IEEE divisions cost more than the unpacking): lane l
//     divides A's scale of chunk l of every 32, and the x scale of (chunk,
//     vector) (l / BP, l % BP) of every 32 / BP (BP = B rounded up to a
//     power of 2); the lanes that need a quotient take it by a shuffle.
// m_pad and n_pad need only be multiples of 64 (the f32 mode's shards).
#include <cooperative_groups.h>

#include "mvm.cuh"

namespace cgrp = cooperative_groups;

namespace clover {

constexpr int MB_MAX_DEVICES = 64;
// 12582912.0f = 1.5 * 2^23; its bits plus an integer |d| < 2^22 are the
// float 12582912 + d, exactly
constexpr int MAGIC_BITS = 0x4B400000;
constexpr float MAGIC = 12582912.0f;

// The launch's operands (the f32 mode writes out_f32 and reads no seed).
struct BatchedArgs {
  const int8_t* a;
  const float* a_scales;
  const int8_t* x;
  const float* x_scales;
  int8_t* out;
  float* out_scales;
  float* out_f32;
  int64_t m_pad;
  int64_t n_pad;
  int batch;
  int noise;
  uint32_t seed;
};

// The signed int8x4 codes of a packed word's low and high nibbles (as
// mvm_rows.cuh low_codes, high_codes): a nibble v + 0x78 stays below 0x100 in
// every byte, and ^ 0x80 recentres it (low: v - 8; high: the 4-bit two's
// complement of v, rebased the same way after ^ 8).
__device__ __forceinline__ int nibbles_lo(uint32_t w) {
  return (int)(((w & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u);
}
__device__ __forceinline__ int nibbles_hi(uint32_t w) {
  return (int)(((((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^
               0x80808080u);
}

// W = 2 or 4 words of A at p into w, or zeros when !valid: streamed
// (ld.global.cs: A is touched once), each miss filling 128 bytes of L2.
// Volatile, so the compiler neither sinks a prefetch towards its use nor
// drops it.
template <int W>
__device__ __forceinline__ void ld_stream(uint32_t* w, const int8_t* p,
                                          bool valid) {
  if constexpr (W == 2)
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n mov.b32 %0, 0;\n"
        " mov.b32 %1, 0;\n @q ld.global.cs.L2::128B.v2.u32 {%0, %1}, [%2];\n"
        "}\n"
        : "=r"(w[0]), "=r"(w[1])
        : "l"(p), "r"((int)valid));
  else
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n mov.b32 %0, 0;\n"
        " mov.b32 %1, 0;\n mov.b32 %2, 0;\n mov.b32 %3, 0;\n"
        " @q ld.global.cs.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p), "r"((int)valid));
}
__device__ __forceinline__ float ld_scale(const float* p, bool valid) {
  float v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
      " @q ld.global.nc.f32 %0, [%1];\n}\n"
      : "=f"(v)
      : "l"(p), "r"((int)valid));
  return v;
}

// d = A B + d for one m16n8k32 tile: a the lane's A fragment (rows r and
// r + 8 of the tile at k 4t ... 4t + 3, then at k 16 + 4t ...: registers
// {row r k-low, row r + 8 k-low, row r k-high, row r + 8 k-high}), b its B
// fragment (vector n = lane / 4 at the same k), d the accumulators of rows
// r, r + 8 (r = lane / 4) and vectors 2t, 2t + 1 (t = lane % 4):
// {(r, 2t), (r, 2t + 1), (r + 8, 2t), (r + 8, 2t + 1)}.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BA>
__host__ __device__ constexpr int mb_groups() {
  return BA == 4 ? 16 : 8;
}

// m16 tiles of A per warp: a CTA holds 16 MT rows, a 64-row band is a
// cluster of 4 / MT CTAs.  MT = 4 halves the x bytes each row of A pays
// for and needs no cluster, but its 16 NT accumulators per lane spill
// past three n-tiles with 4-bit A, and its ring with 8-bit A; both
// measured slower there.
template <int BA, int NT>
__host__ __device__ constexpr int mb_tiles() {
  return BA == 4 && NT <= 3 ? 4 : 2;
}

// Chunks of loads in flight per warp, by the registers one chunk takes.
template <int MT, int NT>
__host__ __device__ constexpr int mb_depth() {
  return MT == 4 || NT > 2 ? 2 : 3;
}

// CTA i holds rows 16 MT i ... (band i / C, cluster rank i % C for C = 4 /
// MT CTAs a band); warp g is lane group g: blocks g, g + G, ...; lane (r,
// t) = (lane / 4, lane % 4) reads rows 16 MT i + 8 h + r (h < 2 MT: m-tile
// h / 2, its rows r and r + 8) and vectors 8 j + r (j < NT).
template <int BA, int BX, int NT, bool F32>
__global__ void __launch_bounds__(BA == 4 ? 512 : 256, BA == 4 ? 1 : 2)
mvm_batched_kernel(const BatchedArgs p) {
  constexpr int G = mb_groups<BA>();
  constexpr int MT = mb_tiles<BA, NT>();
  constexpr int P = mb_depth<MT, NT>();
  constexpr int ROWS = 16 * MT, C = 64 / ROWS;  // rows a CTA, CTAs a band
  constexpr bool CLUSTER = C > 1 && !F32;
  constexpr int BO = (BA == 4 && BX == 4) ? 4 : 8;  // output bits
  constexpr float QA = BA == 4 ? 7.0f : 127.0f;
  constexpr float QX = BX == 4 ? 7.0f : 127.0f;
  constexpr float QO = BO == 4 ? 7.0f : 127.0f;
  constexpr int AW = BA == 4 ? 2 : 4;        // words of A per row and lane
  constexpr int XW = BX == 4 ? 2 : 4;        // words of x per vector and lane
  constexpr int A_BLOCK = 8 * BA, X_BLOCK = 8 * BX;  // bytes of a block
  constexpr int V = 8 * NT;                  // vector slots
  extern __shared__ float part[];            // [G][ROWS][V] group sums
  __shared__ float ys[F32 ? 1 : V][64];      // the band's sums (leader)
  if constexpr (CLUSTER)  // every CTA of the cluster has started before
                          // any writes the leader's ys
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int r = lane >> 2, t = lane & 3;
  const int64_t wa = p.n_pad * BA / 8, wx = p.n_pad * BX / 8;
  const int64_t nb = p.n_pad / 64, nch = (nb + G - 1) / G;
  const int64_t band = blockIdx.x / C;
  const int rank = (int)(blockIdx.x % C);
  const int64_t row0 = band * 64 + rank * ROWS;
  // this lane's bytes of block g: of A (row row0 + r), of x (vector r)
  const int8_t* ap = p.a + (row0 + r) * wa + g * A_BLOCK + t * 4 * AW;
  const int8_t* xp = p.x + r * wx + g * X_BLOCK + t * (BA == 4 ? 8 : 16);

  uint32_t ar[P][2 * MT][AW];  // A: rows r + 8h
  uint32_t xr[P][NT][XW];      // x: vectors 8j + r
  auto load = [&](int s, int64_t c) {
    const bool valid = c * G + g < nb;
#pragma unroll
    for (int h = 0; h < 2 * MT; ++h)
      ld_stream<AW>(ar[s][h], ap + 8 * h * wa + c * G * A_BLOCK, valid);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bool live = valid && 8 * j + r < p.batch;
      const int8_t* q = xp + 8 * j * wx + c * G * X_BLOCK;
      if constexpr (XW == 2) {
        const uint2 w = live ? __ldg(reinterpret_cast<const uint2*>(q))
                             : make_uint2(0u, 0u);
        xr[s][j][0] = w.x;
        xr[s][j][1] = w.y;
      } else if constexpr (BA == 4) {  // elements 8t ..., 32 + 8t ...
        const uint2 w = live ? __ldg(reinterpret_cast<const uint2*>(q))
                             : make_uint2(0u, 0u);
        const uint2 u = live ? __ldg(reinterpret_cast<const uint2*>(q + 32))
                             : make_uint2(0u, 0u);
        xr[s][j][0] = w.x;
        xr[s][j][1] = w.y;
        xr[s][j][2] = u.x;
        xr[s][j][3] = u.y;
      } else {
        const uint4 w = live ? __ldg(reinterpret_cast<const uint4*>(q))
                             : make_uint4(0u, 0u, 0u, 0u);
        xr[s][j][0] = w.x;
        xr[s][j][1] = w.y;
        xr[s][j][2] = w.z;
        xr[s][j][3] = w.w;
      }
    }
  };
  // The block scales over q, each divided once: lane l holds A's of chunk
  // ca + l (32 chunks a refresh), and vector l % BP's x scale of chunk cb
  // + l / BP (BP = B rounded up to a power of 2; 32 / BP chunks a
  // refresh); the raw scales of the next two refreshes are in flight.
  const int bp = p.batch <= 1 ? 1 : 1 << (32 - __clz(p.batch - 1));
  const int cps = 32 / bp;
  const int lv = lane & (bp - 1), lc = lane / bp;
  const float* sa_row = p.a_scales + band * nb + g;
  const float* sx_row = p.x_scales + lv * nb + g;
  auto a_scale = [&](int64_t c) {  // A's raw scale of chunk c + lane
    return ld_scale(sa_row + (c + lane) * G, (c + lane) * G + g < nb);
  };
  auto x_scale = [&](int64_t c) {  // lane's raw x scale of the cps from c
    return ld_scale(sx_row + (c + lc) * G,
                    (c + lc) * G + g < nb && lv < p.batch);
  };
  float sa1 = a_scale(0), sa2 = a_scale(32);
  float sx1 = x_scale(0), sx2 = x_scale(cps);
  float saq_all = 0.0f, sxq_all = 0.0f;

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
#pragma unroll
  for (int s = 0; s < P - 1; ++s) load(s, s);

  for (int64_t c0 = 0; c0 < nch; c0 += P) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int64_t c = c0 + s;
      load((s + P - 1) % P, c + P - 1);
      if (c < nch) {
        // (0 / qA) * (0 / qx) = +0 past the row's last block
        if ((c & 31) == 0) {
          saq_all = sa1 / QA;
          sa1 = sa2;
          sa2 = a_scale(c + 64);
        }
        const int k = (int)(c & (cps - 1)) * bp;  // lane of chunk c's x
        if (k == 0) {
          sxq_all = sx1 / QX;
          sx1 = sx2;
          sx2 = x_scale(c + 2 * cps);
        }
        const float saq = __shfl_sync(FULL_MASK, saq_all, (int)(c & 31));
        int bf[NT][2][2];  // n-tile, step: the B fragments
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t* xw = xr[s][j];
          if constexpr (BX == 4) {
            bf[j][0][0] = nibbles_lo(xw[0]);
            bf[j][0][1] = nibbles_lo(xw[1]);
            bf[j][1][0] = nibbles_hi(xw[0]);
            bf[j][1][1] = nibbles_hi(xw[1]);
          } else {
            bf[j][0][0] = (int)xw[0];
            bf[j][0][1] = (int)xw[1];
            bf[j][1][0] = (int)xw[2];
            bf[j][1][1] = (int)xw[3];
          }
        }
        // vectors 8j + 2t and 8j + 2t + 1 (a vector past B reads another
        // lane's quotient, and its sums are never stored)
        float cb[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          cb[j][0] = saq * __shfl_sync(FULL_MASK, sxq_all, k + 8 * j + 2 * t);
          cb[j][1] =
              saq * __shfl_sync(FULL_MASK, sxq_all, k + 8 * j + 2 * t + 1);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint32_t* lo = ar[s][2 * m];      // row r + 16m
          const uint32_t* hi = ar[s][2 * m + 1];  // row r + 16m + 8
          int af[2][4];                           // step: the A fragment
          if constexpr (BA == 4) {
            af[0][0] = nibbles_lo(lo[0]);
            af[0][1] = nibbles_lo(hi[0]);
            af[0][2] = nibbles_lo(lo[1]);
            af[0][3] = nibbles_lo(hi[1]);
            af[1][0] = nibbles_hi(lo[0]);
            af[1][1] = nibbles_hi(hi[0]);
            af[1][2] = nibbles_hi(lo[1]);
            af[1][3] = nibbles_hi(hi[1]);
          } else {
            af[0][0] = (int)lo[0];
            af[0][1] = (int)hi[0];
            af[0][2] = (int)lo[1];
            af[0][3] = (int)hi[1];
            af[1][0] = (int)lo[2];
            af[1][1] = (int)hi[2];
            af[1][2] = (int)lo[3];
            af[1][3] = (int)hi[3];
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            int d[4] = {MAGIC_BITS, MAGIC_BITS, MAGIC_BITS, MAGIC_BITS};
            mma_s8(d, af[0], bf[j][0]);
            mma_s8(d, af[1], bf[j][1]);
            float* a4 = acc[m][j];
            a4[0] = a4[0] + cb[j][0] * (__int_as_float(d[0]) - MAGIC);
            a4[1] = a4[1] + cb[j][1] * (__int_as_float(d[1]) - MAGIC);
            a4[2] = a4[2] + cb[j][0] * (__int_as_float(d[2]) - MAGIC);
            a4[3] = a4[3] + cb[j][1] * (__int_as_float(d[3]) - MAGIC);
          }
        }
      }
    }
  }

  // group g's sums of rows 16m + r (+ 8), vectors 8j + 2t (+ 1)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* row = part + (g * ROWS + 16 * m + r) * V + 8 * j + 2 * t;
      row[0] = acc[m][j][0];
      row[1] = acc[m][j][1];
      row[8 * V] = acc[m][j][2];
      row[8 * V + 1] = acc[m][j][3];
    }
  __syncthreads();
  float* lead = &ys[0][0];
  if constexpr (CLUSTER) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    lead = cgrp::this_cluster().map_shared_rank(lead, 0);
  }
  for (int i = threadIdx.x; i < ROWS * V; i += 32 * G) {
    const int row = i / V, vec = i % V;
    float v[G];
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = part[(k * ROWS + row) * V + vec];
#pragma unroll
    for (int h = G / 2; h; h >>= 1)
#pragma unroll
      for (int k = 0; k < h; ++k) v[k] = v[k] + v[k + h];
    if (vec < p.batch) {
      if constexpr (F32)
        p.out_f32[vec * p.m_pad + row0 + row] = v[0];
      else
        lead[vec * 64 + rank * ROWS + row] = v[0];
    }
  }
  if constexpr (F32) return;
  if constexpr (CLUSTER)
    cgrp::this_cluster().sync();
  else
    __syncthreads();
  if (rank != 0) return;

  // band requant of vectors g, g + G, ...: lane j holds band rows j and
  // j + 32 (the two nibbles of output byte j when the output is 4-bit)
  for (int vec = g; vec < p.batch; vec += G) {
    const uint32_t seed1 = p.seed + (uint32_t)vec;
    const int64_t i0 = band * 64 + lane, i1 = i0 + 32;
    const float y0 = ys[vec][lane], y1 = ys[vec][lane + 32];
    const float s1 = nonzero_scale(warp_max(fmaxf(fabsf(y0), fabsf(y1))));
    const float mult1 = QO / s1;
    const int q0 = sr_code(y0, mult1, QO, sr_noise(p.noise, seed1, i0, 0));
    const int q1 = sr_code(y1, mult1, QO, sr_noise(p.noise, seed1, i1, 0));
    int8_t* o = p.out + vec * (p.m_pad * BO / 8);
    if constexpr (BO == 4) {
      o[band * 32 + lane] = pack_byte(q0, q1);
    } else {
      o[i0] = (int8_t)q0;
      o[i1] = (int8_t)q1;
    }
    if (lane == 0) p.out_scales[vec * (p.m_pad / 64) + band] = s1;
  }
}

template <int BA, int BX, int NT, bool F32>
cudaError_t launch_tiles(const BatchedArgs& p, cudaStream_t s) {
  constexpr int G = mb_groups<BA>();
  constexpr int ROWS = 16 * mb_tiles<BA, NT>(), C = 64 / ROWS;
  constexpr int SMEM = G * ROWS * 8 * NT * (int)sizeof(float);
  auto* kernel = mvm_batched_kernel<BA, BX, NT, F32>;
  // the group sums may pass the 48 KB a launch gets unasked: ask once per
  // device
  static bool allowed[MB_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MB_MAX_DEVICES || !allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return e;
    if (dev < MB_MAX_DEVICES) allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.m_pad / ROWS));
  cfg.blockDim = dim3(32 * G);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = C > 1 && !F32 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

template <int BA, int BX, bool F32>
cudaError_t launch_batched(const BatchedArgs& p, cudaStream_t s) {
  switch ((p.batch + 7) / 8) {
    case 1:
      return launch_tiles<BA, BX, 1, F32>(p, s);
    case 2:
      return launch_tiles<BA, BX, 2, F32>(p, s);
    case 3:
      return launch_tiles<BA, BX, 3, F32>(p, s);
    default:
      return launch_tiles<BA, BX, 4, F32>(p, s);
  }
}

// Dispatch on the mode; F32 selects the f32-output mode.
template <bool F32>
int launch_mode(const BatchedArgs& p, int bits_a, int bits_x, void* stream) {
  if (p.batch < 1 || p.batch > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (bits_a == 4 && bits_x == 4)
    e = launch_batched<4, 4, F32>(p, s);
  else if (bits_a == 4 && bits_x == 8)
    e = launch_batched<4, 8, F32>(p, s);
  else if (bits_a == 8 && bits_x == 8)
    e = launch_batched<8, 8, F32>(p, s);
  else
    return (int)cudaErrorInvalidValue;
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace clover

extern "C" int clover_mvm_batched(const int8_t* a, const float* a_scales,
                                  const int8_t* x, const float* x_scales,
                                  int8_t* out, float* out_scales,
                                  int64_t m_pad, int64_t n_pad, int batch,
                                  int bits_a, int bits_x, int noise,
                                  uint32_t seed, void* stream) {
  const clover::BatchedArgs p = {a,     a_scales, x,     x_scales,
                                 out,   out_scales, nullptr, m_pad,
                                 n_pad, batch,    noise, seed};
  return clover::launch_mode<false>(p, bits_a, bits_x, stream);
}

extern "C" int clover_mvm_batched_f32(const int8_t* a, const float* a_scales,
                                      const int8_t* x, const float* x_scales,
                                      float* out, int64_t m_pad, int64_t n_pad,
                                      int batch, int bits_a, int bits_x,
                                      void* stream) {
  const clover::BatchedArgs p = {a,     a_scales, x,       x_scales,
                                 nullptr, nullptr, out,    m_pad,
                                 n_pad, batch,    0,       0u};
  return clover::launch_mode<true>(p, bits_a, bits_x, stream);
}
