// The whole IHT/GD iteration in one launch, and `chain` iterations with the
// hard threshold in one launch, for a 4-bit Phi with 4-bit (4x4) or 8-bit
// (4x8) vectors:
//
//   t2 = Q(y + (-1) * Q(Phi  @ x))     leg A: fused MVM+AXPY, seeds s0, s1
//   x' = Q(x +  mu  * Q(PhiT @ t2))    leg B: fused MVM+AXPY, seeds s2, s3
//   x' = top_k(x', K)                  phase C (chained kernel, IHT)
//
// Replaces clover_tpu/kernels/iteration.py iteration_pallas
// (_build_iter_call, _iter_kernel) and iteration_chain_pallas
// (_build_chain_call, _chain_kernel).
//
// Numbers: bit-identical to the unfused kernel sequence -- two mvm.cu
// launches, then one threshold.cu launch -- in deterministic and SR modes.
// Both kernels run each band through row_sums and band_epilogue
// (mvm_rows.cuh), mvm.cu's own body, which walk a row in the chunks,
// groups and order of mvm.cu's note, so a row's f32 sum is mvm_kernel's.
// Phase C runs the select of threshold_kernel (threshold.cuh), whose kept
// set is the unique golden one at any thread count.  The SR noise of an
// element is Philox(seed, element index, leg) as in mvm.cu, and iteration
// it of a chain takes the four per-op seeds of the unchained solver loop
// (clover_tpu_torch/models/solvers.py _op_seeds).
//
// Bound: device memory, or L2 while the pair fits there: per iteration
// both 4-bit matrices are read once, m_pad * n_pad bytes, 33.6 MB at
// 4096x8192 (10.0 us at 3.35 TB/s; the 50 MB L2 holds the pair up to
// that size, and Phi and PhiT are read through the read-only path, which
// leaves them there between launches).  Both kernels are one cooperative
// launch of clusters of CHAIN_CLUSTER = 2 CTAs, at most as many as fit on
// the card at once; a leg ends in a grid barrier.  What the design does
// about the bound:
//   - A band's 64 rows are split over the two CTAs of a cluster,
//     CHAIN_ROWS = 4 a warp, as mvm.cu splits them (never the reduction):
//     each CTA streams its rows through row_sums' ring of registers, the
//     row sums meet in the cluster leader's shared memory (DSMEM), and the
//     leader's warp 0 runs the band epilogue.  Clusters walk the bands
//     grid-stride; 132 clusters fit at 2 CTAs an SM, so leg B's 128 bands
//     at 4096x8192 take one round and leg A's 64 bands a half.  Clusters
//     of 4 (62 fit: leg A's 64 bands take two rounds) and of 8 measured
//     slower (PERF.md §6), and so did giving leg A's bands to every other
//     cluster, to spread them over the card.  ys is
//     double-buffered by band, so a peer's next sums never meet a leader
//     still reading.
//   - x lives in every CTA's shared memory: leg A reads it there and leg B
//     takes it as u there.
//   - Whole iteration: after the grid barrier, each CTA copies t2 (at most
//     8 KB, from L2 with ld_cg) into its shared memory when it is at least
//     STAGE_T2 bytes, and leg B reads it there; a shorter t2 is read from
//     L2 by every warp, as the chain does.  The copy costs one L2 round
//     trip before leg B starts; reading t2 from L2 costs each of leg B's
//     warps t2's bytes again, which held the 4x8 iteration at 4096x8192 to
//     half again the 4x4's time.  The copy measured faster from a t2 of 2
//     KB up (2048x4096 4x8, 4096x8192) and slower below (2048x4096 4x4,
//     512x1024).  An L2 evict_last policy on Phi and PhiT and a third chunk
//     in flight measured no better (PERF.md §6).
//   - Chain: phase C runs in every CTA: after the grid barrier that ends
//     leg B, each CTA reads the new x (at most 8 KB, from L2 with ld_cg)
//     and selects its top K into its own copy.  An iteration has two grid
//     barriers, and no CTA waits while one other selects.  CTA 0 writes
//     the thresholded codes out after the last iteration.  x ping-pongs
//     between two scratch slots (leg B of iteration it writes slot it & 1,
//     the thresholded codes go to xt and keep the slot's scales), and the
//     caller's x is never written.
#include <cooperative_groups.h>

#include "mvm.cuh"
#include "mvm_rows.cuh"
#include "threshold.cuh"

namespace cgrp = cooperative_groups;

namespace clover {

constexpr int MAX_CHAIN = 16;
constexpr int CHAIN_ROWS = 4;                        // rows a warp per band
constexpr int CHAIN_DEPTH = Depth<CHAIN_ROWS>::PA;   // chunks in flight
constexpr int CHAIN_CLUSTER = MV_ROWS / CHAIN_ROWS;  // CTAs sharing a band
constexpr int CHAIN_N = 8192;  // the longest x of the chain (eligible sides)
constexpr int CHAIN_SLOTS = CHAIN_N / (16 * MV_THREADS);  // select slots
constexpr int STAGE_T2 = 2048;  // t2's bytes from which leg B copies it

// The per-op SR seeds of each iteration (leg A mvm, axpy; leg B mvm, axpy)
// and the four SR flags, which every iteration of a chain shares.
struct IterSeeds {
  uint32_t seed[4 * MAX_CHAIN];
  int noise[4];
};

// Predicated loads of a chain leg (zeros when !valid): x in this CTA's
// shared memory, and t2, which other CTAs wrote, through ld.global.cg.
__device__ __forceinline__ uint4 ld_smem(const int8_t* p, bool valid) {
  uint4 v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %5, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  mov.b32 %1, 0;\n"
      "  mov.b32 %2, 0;\n"
      "  mov.b32 %3, 0;\n"
      "  @q ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      "}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"((int)valid));
  return v;
}
__device__ __forceinline__ float ld_smem(const float* p, bool valid) {
  float v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %2, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  @q ld.shared.f32 %0, [%1];\n"
      "}\n"
      : "=f"(v)
      : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"((int)valid));
  return v;
}
__device__ __forceinline__ uint4 ld_cg(const int8_t* p, bool valid) {
  uint4 v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %5, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  mov.b32 %1, 0;\n"
      "  mov.b32 %2, 0;\n"
      "  mov.b32 %3, 0;\n"
      "  @q ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      "}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"((int)valid)
      : "memory");
  return v;
}
__device__ __forceinline__ float ld_cg(const float* p, bool valid) {
  float v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %2, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  @q ld.global.cg.f32 %0, [%1];\n"
      "}\n"
      : "=f"(v)
      : "l"(p), "r"((int)valid)
      : "memory");
  return v;
}

// Leg A reads x from shared memory, leg B t2 from L2; Phi, PhiT and their
// scales are the launch's read-only inputs.
struct LegALoads {
  static __device__ __forceinline__ uint4 a(const int8_t* p, bool valid) {
    return ld_ro(p, valid);
  }
  static __device__ __forceinline__ uint4 x(const int8_t* p, bool valid) {
    return ld_smem(p, valid);
  }
  static __device__ __forceinline__ float sa(const float* p, bool valid) {
    return ld_ro(p, valid);
  }
  static __device__ __forceinline__ float sx(const float* p, bool valid) {
    return ld_smem(p, valid);
  }
};
struct LegBLoads {
  static __device__ __forceinline__ uint4 a(const int8_t* p, bool valid) {
    return ld_ro(p, valid);
  }
  static __device__ __forceinline__ uint4 x(const int8_t* p, bool valid) {
    return ld_cg(p, valid);
  }
  static __device__ __forceinline__ float sa(const float* p, bool valid) {
    return ld_ro(p, valid);
  }
  static __device__ __forceinline__ float sx(const float* p, bool valid) {
    return ld_cg(p, valid);
  }
};

// p.out = Q(p.u + p.alpha * Q(A v)) over A's rows / 64 bands: cluster c
// takes bands c, c + clusters, ...; CTA rank r of a cluster the band's rows
// 16 r ... 16 r + 15, warp w of it the CHAIN_ROWS from 16 r + 2 w.  ys: the
// leader's two buffers of band sums, ``parity`` the next one.
template <int BA, int BX, class L>
__device__ __forceinline__ void chain_leg(int64_t rows, const int8_t* a,
                                          const float* as, const int8_t* v,
                                          const float* vs, const MvmArgs& p,
                                          float (*ys)[64], int& parity) {
  constexpr int R = CHAIN_ROWS, C = CHAIN_CLUSTER;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = (int)cluster.block_rank();
  const int first = rank * (MV_WARPS * R) + warp * R;
  const int64_t wa = p.n_pad * BA / 8, nb = p.n_pad / 64;
  for (int64_t band = blockIdx.x / C; band < rows / 64;
       band += gridDim.x / C) {
    float sums[R];
    row_sums<BA, BX, R, L, CHAIN_DEPTH>(a + (band * 64 + first) * wa,
                                        as + band * nb, v, vs, p.n_pad, sums);
    float* lead = cluster.map_shared_rank(ys[parity], 0);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) lead[first + r] = sums[r];
    }
    cluster.sync();
    if (rank == 0 && warp == 0) band_epilogue<BA, BX>(band, ys[parity], p);
    parity ^= 1;
  }
}

// One iteration: x into this CTA's shared memory, leg A (t2 to the scratch
// buffer), a grid barrier, leg B (the new x to out).
template <int BA, int BX>
__global__ void __launch_bounds__(MV_THREADS, 2)
iteration_kernel(const int8_t* __restrict__ phi,
                 const float* __restrict__ phi_s,
                 const int8_t* __restrict__ phit,
                 const float* __restrict__ phit_s, const int8_t* y,
                 const float* y_s, const int8_t* x, const float* x_s,
                 int8_t* t2, float* t2_s, int8_t* out, float* out_s,
                 int64_t m_pad, int64_t n_pad, float mu, IterSeeds sd) {
  constexpr int BO = (BA == 4 && BX == 4) ? 4 : 8;
  __shared__ __align__(16) int8_t xc[CHAIN_N * BO / 8];  // this CTA's x
  __shared__ float xcs[CHAIN_N / 64];
  __shared__ __align__(16) int8_t tc[CHAIN_N * BO / 8];  // and its t2
  __shared__ float tcs[CHAIN_N / 64];
  __shared__ float ys[2][64];
  cgrp::grid_group grid = cgrp::this_grid();
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int tid = threadIdx.x;
  const int64_t xw = n_pad * BO / 8, nb = n_pad / 64;
  const int64_t tw = m_pad * BO / 8, tb = m_pad / 64;
  for (int64_t i = 16 * tid; i < xw; i += 16 * MV_THREADS)
    *reinterpret_cast<uint4*>(xc + i) =
        *reinterpret_cast<const uint4*>(x + i);
  for (int64_t i = tid; i < nb; i += MV_THREADS) xcs[i] = x_s[i];
  cluster.sync();  // x is in place, and every CTA of the cluster started
  int parity = 0;
  const MvmArgs pa = {phi,   phi_s,       xc,         xcs,         y,
                      y_s,   -1.0f,       t2,         t2_s,        nullptr,
                      n_pad, sd.noise[0], sd.seed[0], sd.noise[1], sd.seed[1]};
  chain_leg<BA, BX, LegALoads>(m_pad, phi, phi_s, xc, xcs, pa, ys, parity);
  grid.sync();
  const MvmArgs pb = {phit,  phit_s,      t2,         t2_s,        xc,
                      xcs,   mu,          out,        out_s,       nullptr,
                      m_pad, sd.noise[2], sd.seed[2], sd.noise[3], sd.seed[3]};
  if (tw >= STAGE_T2) {
    for (int64_t i = 16 * tid; i < tw; i += 16 * MV_THREADS)
      *reinterpret_cast<uint4*>(tc + i) =
          ld_cg(reinterpret_cast<const uint4*>(t2 + i));
    for (int64_t i = tid; i < tb; i += MV_THREADS) tcs[i] = ld_cg(t2_s + i);
    __syncthreads();
    // t2 now where leg A found x: LegALoads reads it from shared memory
    chain_leg<BA, BX, LegALoads>(n_pad, phit, phit_s, tc, tcs, pb, ys,
                                 parity);
  } else {
    chain_leg<BA, BX, LegBLoads>(n_pad, phit, phit_s, t2, t2_s, pb, ys,
                                 parity);
  }
}

// (xb0, xs0), (xb1, xs1): the two slots of n_pad elements; xt: the
// thresholded codes.  k < 0 is GD (no phase C).  The result is (xt, or the
// codes of slot (chain - 1) & 1, and that slot's scales).
template <int BA, int BX>
__global__ void __launch_bounds__(MV_THREADS, 2)
iteration_chain_kernel(const int8_t* __restrict__ phi,
                       const float* __restrict__ phi_s,
                       const int8_t* __restrict__ phit,
                       const float* __restrict__ phit_s, const int8_t* y,
                       const float* y_s, const int8_t* x, const float* x_s,
                       int8_t* t2, float* t2_s, int8_t* xb0, float* xs0,
                       int8_t* xb1, float* xs1, int8_t* xt, int64_t m_pad,
                       int64_t n_pad, float mu, int64_t k, int chain,
                       IterSeeds sd) {
  constexpr int BO = (BA == 4 && BX == 4) ? 4 : 8;
  __shared__ SelectSmem<MV_THREADS> sel;
  __shared__ __align__(16) int8_t xc[CHAIN_N * BO / 8];  // this CTA's x
  __shared__ float xcs[CHAIN_N / 64];
  __shared__ float ys[2][64];
  cgrp::grid_group grid = cgrp::this_grid();
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int tid = threadIdx.x;
  const int64_t xw = n_pad * BO / 8, nb = n_pad / 64;
  for (int64_t i = 16 * tid; i < xw; i += 16 * MV_THREADS)
    *reinterpret_cast<uint4*>(xc + i) =
        *reinterpret_cast<const uint4*>(x + i);
  for (int64_t i = tid; i < nb; i += MV_THREADS) xcs[i] = x_s[i];
  cluster.sync();  // x is in place, and every CTA of the cluster started
  int parity = 0;
  for (int it = 0; it < chain; ++it) {
    const uint32_t* s = sd.seed + 4 * it;
    const MvmArgs pa = {phi,  phi_s,       xc,    xcs,        y,
                        y_s,  -1.0f,       t2,    t2_s,       nullptr,
                        n_pad, sd.noise[0], s[0], sd.noise[1], s[1]};
    chain_leg<BA, BX, LegALoads>(m_pad, phi, phi_s, xc, xcs, pa, ys, parity);
    grid.sync();
    int8_t* oc = it & 1 ? xb1 : xb0;
    float* os = it & 1 ? xs1 : xs0;
    const MvmArgs pb = {phit,  phit_s,      t2,   t2_s,        xc,
                        xcs,   mu,          oc,   os,          nullptr,
                        m_pad, sd.noise[2], s[2], sd.noise[3], s[3]};
    chain_leg<BA, BX, LegBLoads>(n_pad, phit, phit_s, t2, t2_s, pb, ys,
                                 parity);
    grid.sync();
    // phase C, in every CTA: the new x into shared memory, its top K kept
    if (k >= 0) {
      select_resident<BO, MV_THREADS, CHAIN_SLOTS, true>(sel, oc, os, xc,
                                                         n_pad, k);
    } else {
      for (int64_t i = 16 * tid; i < xw; i += 16 * MV_THREADS)
        *reinterpret_cast<uint4*>(xc + i) =
            ld_cg(reinterpret_cast<const uint4*>(oc + i));
    }
    for (int64_t i = tid; i < nb; i += MV_THREADS) xcs[i] = ld_cg(os + i);
    __syncthreads();
  }
  if (k >= 0 && blockIdx.x == 0) {
    for (int64_t i = 16 * tid; i < xw; i += 16 * MV_THREADS)
      *reinterpret_cast<uint4*>(xt + i) =
          *reinterpret_cast<const uint4*>(xc + i);
  }
}

// CTAs of a kernel that fit on the card at once: its co-resident clusters
// times CHAIN_CLUSTER.
template <class Kernel>
cudaError_t resident_ctas(Kernel kernel, int* ctas) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CHAIN_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(CHAIN_CLUSTER * 64);
  cfg.blockDim = dim3(MV_THREADS);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  *ctas = clusters * CHAIN_CLUSTER;
  return e;
}

template <int BA, int BX>
cudaError_t co_resident(int chain, int* ctas) {
  return chain ? resident_ctas(iteration_chain_kernel<BA, BX>, ctas)
               : resident_ctas(iteration_kernel<BA, BX>, ctas);
}

// A cooperative launch of ``grid`` CTAs, in clusters of ``cluster``.
cudaLaunchConfig_t cooperative(int grid, int cluster, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(MV_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  return cfg;
}

bool fill_seeds(IterSeeds* sd, const uint32_t* seeds, const int* noise,
                int chain) {
  if (chain < 1 || chain > MAX_CHAIN) return false;
  for (int i = 0; i < 4 * MAX_CHAIN; ++i)
    sd->seed[i] = i < 4 * chain ? seeds[i] : 0u;
  for (int i = 0; i < 4; ++i) sd->noise[i] = noise[i];
  return true;
}

}  // namespace clover

// CTAs of one kernel that fit on the current device at once.
extern "C" int clover_iteration_occupancy(int bits_a, int bits_x, int chain,
                                          int* ctas) {
  if (bits_a == 4 && bits_x == 4)
    return (int)clover::co_resident<4, 4>(chain, ctas);
  if (bits_a == 4 && bits_x == 8)
    return (int)clover::co_resident<4, 8>(chain, ctas);
  return (int)cudaErrorInvalidValue;
}

// ``grid``: CTAs, a multiple of CHAIN_CLUSTER; n_pad at most CHAIN_N.
extern "C" int clover_iteration(
    const int8_t* phi, const float* phi_s, const int8_t* phit,
    const float* phit_s, const int8_t* y, const float* y_s, const int8_t* x,
    const float* x_s, int8_t* t2, float* t2_s, int8_t* out, float* out_s,
    int64_t m_pad, int64_t n_pad, float mu, int bits_a, int bits_x,
    const uint32_t* seeds, const int* noise, int grid, void* stream) {
  clover::IterSeeds sd;
  if (!clover::fill_seeds(&sd, seeds, noise, 1) ||
      n_pad > clover::CHAIN_N || grid % clover::CHAIN_CLUSTER != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = clover::cooperative(
      grid, clover::CHAIN_CLUSTER, (cudaStream_t)stream, attr);
  cudaError_t e;
  if (bits_a == 4 && bits_x == 4)
    e = cudaLaunchKernelEx(&cfg, clover::iteration_kernel<4, 4>, phi, phi_s,
                           phit, phit_s, y, y_s, x, x_s, t2, t2_s, out, out_s,
                           m_pad, n_pad, mu, sd);
  else if (bits_a == 4 && bits_x == 8)
    e = cudaLaunchKernelEx(&cfg, clover::iteration_kernel<4, 8>, phi, phi_s,
                           phit, phit_s, y, y_s, x, x_s, t2, t2_s, out, out_s,
                           m_pad, n_pad, mu, sd);
  else
    return (int)cudaErrorInvalidValue;
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// ``grid``: CTAs, a multiple of CHAIN_CLUSTER; n_pad at most CHAIN_N.
extern "C" int clover_iteration_chain(
    const int8_t* phi, const float* phi_s, const int8_t* phit,
    const float* phit_s, const int8_t* y, const float* y_s, const int8_t* x,
    const float* x_s, int8_t* t2, float* t2_s, int8_t* xb0, float* xs0,
    int8_t* xb1, float* xs1, int8_t* xt, int64_t m_pad, int64_t n_pad,
    float mu, int64_t k, int chain,
    int bits_a, int bits_x, const uint32_t* seeds, const int* noise, int grid,
    void* stream) {
  clover::IterSeeds sd;
  if (!clover::fill_seeds(&sd, seeds, noise, chain) ||
      n_pad > clover::CHAIN_N || grid % clover::CHAIN_CLUSTER != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = clover::cooperative(
      grid, clover::CHAIN_CLUSTER, (cudaStream_t)stream, attr);
  cudaError_t e;
  if (bits_a == 4 && bits_x == 4)
    e = cudaLaunchKernelEx(&cfg, clover::iteration_chain_kernel<4, 4>, phi,
                           phi_s, phit, phit_s, y, y_s, x, x_s, t2, t2_s, xb0,
                           xs0, xb1, xs1, xt, m_pad, n_pad, mu, k, chain, sd);
  else if (bits_a == 4 && bits_x == 8)
    e = cudaLaunchKernelEx(&cfg, clover::iteration_chain_kernel<4, 8>, phi,
                           phi_s, phit, phit_s, y, y_s, x, x_s, t2, t2_s, xb0,
                           xs0, xb1, xs1, xt, m_pad, n_pad, mu, k, chain, sd);
  else
    return (int)cudaErrorInvalidValue;
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
