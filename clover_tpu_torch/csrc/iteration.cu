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
// Each band runs mvm_band (mvm.cuh), whose row sums are mvm_kernel's (mvm.cu
// walks every row in the same chunks, groups and order); phase C runs
// threshold_select (threshold.cuh), the body of threshold_kernel, whose
// kept set is the unique golden one at any thread count; the SR noise of
// an element is Philox(seed, element index, leg) as in mvm.cu, and
// iteration it of a chain takes the four per-op seeds of the unchained
// solver loop (clover_tpu_torch/models/solvers.py _op_seeds).
//
// Design: one cooperative launch of MV_THREADS-thread CTAs, as many as fit
// on the card at once and no more than the larger leg's bands.  Leg A walks
// Phi's m_pad/64 bands in a grid-stride loop and writes t2's codes and
// scales to a device scratch buffer (a few KB: it stays in L2 and is never
// returned); a grid barrier; leg B walks PhiT's n_pad/64 bands against t2,
// with u = x, and writes the new x.  The chained kernel adds a barrier and
// phase C: CTA 0 selects the top K of the new x (at most 8192 elements, the
// eligible sizes) while the other CTAs wait at the next barrier.  x
// ping-pongs between two scratch slots (leg B of iteration it writes slot
// it & 1, the thresholded codes go to a third buffer and keep the slot's
// scales), so no leg reads a buffer that the same phase writes, and the
// caller's x is never written.  Data written by another CTA is read with
// ld.global.cg (common.cuh ld_cg).
//
// Bound: device memory.  Per iteration both 4-bit matrices are read once,
// m_pad * n_pad bytes, 33.6 MB at 4096x8192: 10.0 us at 3.35 TB/s, and the
// pair fits in the 50 MB L2.  What the design does about it: one launch
// per iteration (one per `chain` iterations) instead of three, so the
// host's per-call cost and the launch gaps stop bounding small solves.
// Known limits: leg A has m_pad/64 bands, 64 at 4096x8192, so half the CTAs
// idle in it; phase C is one CTA of 256 threads while the others wait.
#include <cooperative_groups.h>

#include "mvm.cuh"
#include "threshold.cuh"

namespace cgrp = cooperative_groups;

namespace clover {

constexpr int MAX_CHAIN = 16;

// The per-op SR seeds of each iteration (leg A mvm, axpy; leg B mvm, axpy)
// and the four SR flags, which every iteration of a chain shares.
struct IterSeeds {
  uint32_t seed[4 * MAX_CHAIN];
  int noise[4];
};

// out = Q(u + alpha * Q(A v)) over every 64-row band of A, grid-stride.
template <int BA, int BX>
__device__ __forceinline__ void leg(
    int64_t rows, const int8_t* __restrict__ a, const float* __restrict__ as,
    const int8_t* v, const float* vs, const int8_t* u, const float* us,
    float alpha, int8_t* out, float* os, int64_t inner, int noise1,
    uint32_t seed1, int noise2, uint32_t seed2) {
  for (int64_t band = blockIdx.x; band < rows / 64; band += gridDim.x) {
    __syncthreads();  // warp 0 is done with the last band's row sums
    mvm_band<BA, BX, true>(band, a, as, v, vs, u, us, alpha, out, os, inner,
                           noise1, seed1, noise2, seed2);
  }
}

template <int BA, int BX>
__global__ void __launch_bounds__(MV_THREADS)
iteration_kernel(const int8_t* __restrict__ phi,
                 const float* __restrict__ phi_s,
                 const int8_t* __restrict__ phit,
                 const float* __restrict__ phit_s, const int8_t* y,
                 const float* y_s, const int8_t* x, const float* x_s,
                 int8_t* t2, float* t2_s, int8_t* out, float* out_s,
                 int64_t m_pad, int64_t n_pad, float mu, IterSeeds sd) {
  cgrp::grid_group grid = cgrp::this_grid();
  leg<BA, BX>(m_pad, phi, phi_s, x, x_s, y, y_s, -1.0f, t2, t2_s, n_pad,
              sd.noise[0], sd.seed[0], sd.noise[1], sd.seed[1]);
  grid.sync();
  leg<BA, BX>(n_pad, phit, phit_s, t2, t2_s, x, x_s, mu, out, out_s, m_pad,
              sd.noise[2], sd.seed[2], sd.noise[3], sd.seed[3]);
}

// (xb0, xs0), (xb1, xs1): the two slots of n_pad elements; xt: the
// thresholded codes.  k < 0 is GD (no phase C).  The result is (xt, or the
// codes of slot (chain - 1) & 1, and that slot's scales).
template <int BA, int BX>
__global__ void __launch_bounds__(MV_THREADS)
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
  cgrp::grid_group grid = cgrp::this_grid();
  const int8_t* xc = x;
  const float* xs = x_s;
  for (int it = 0; it < chain; ++it) {
    const uint32_t* s = sd.seed + 4 * it;
    leg<BA, BX>(m_pad, phi, phi_s, xc, xs, y, y_s, -1.0f, t2, t2_s, n_pad,
                sd.noise[0], s[0], sd.noise[1], s[1]);
    grid.sync();
    int8_t* oc = it & 1 ? xb1 : xb0;
    float* os = it & 1 ? xs1 : xs0;
    leg<BA, BX>(n_pad, phit, phit_s, t2, t2_s, xc, xs, mu, oc, os, m_pad,
                sd.noise[2], s[2], sd.noise[3], s[3]);
    grid.sync();
    xc = oc;
    xs = os;
    if (k >= 0) {
      if (blockIdx.x == 0)
        threshold_select<BO, MV_THREADS, true>(oc, os, xt, n_pad, k);
      grid.sync();
      xc = xt;
    }
  }
}

template <int BA, int BX>
cudaError_t occupancy(int chain, int* blocks) {
  return chain ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     blocks, iteration_chain_kernel<BA, BX>, MV_THREADS, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     blocks, iteration_kernel<BA, BX>, MV_THREADS, 0);
}

cudaLaunchConfig_t cooperative(int grid, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(MV_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeCooperative;
  attr->val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
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

// CTAs of one kernel that fit on an SM at once (the current device).
extern "C" int clover_iteration_occupancy(int bits_a, int bits_x, int chain,
                                          int* blocks_per_sm) {
  if (bits_a == 4 && bits_x == 4)
    return (int)clover::occupancy<4, 4>(chain, blocks_per_sm);
  if (bits_a == 4 && bits_x == 8)
    return (int)clover::occupancy<4, 8>(chain, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

extern "C" int clover_iteration(
    const int8_t* phi, const float* phi_s, const int8_t* phit,
    const float* phit_s, const int8_t* y, const float* y_s, const int8_t* x,
    const float* x_s, int8_t* t2, float* t2_s, int8_t* out, float* out_s,
    int64_t m_pad, int64_t n_pad, float mu, int bits_a, int bits_x,
    const uint32_t* seeds, const int* noise, int grid, void* stream) {
  clover::IterSeeds sd;
  if (!clover::fill_seeds(&sd, seeds, noise, 1))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      clover::cooperative(grid, (cudaStream_t)stream, &attr);
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

extern "C" int clover_iteration_chain(
    const int8_t* phi, const float* phi_s, const int8_t* phit,
    const float* phit_s, const int8_t* y, const float* y_s, const int8_t* x,
    const float* x_s, int8_t* t2, float* t2_s, int8_t* xb0, float* xs0,
    int8_t* xb1, float* xs1, int8_t* xt, int64_t m_pad, int64_t n_pad,
    float mu, int64_t k, int chain,
    int bits_a, int bits_x, const uint32_t* seeds, const int* noise, int grid,
    void* stream) {
  clover::IterSeeds sd;
  if (!clover::fill_seeds(&sd, seeds, noise, chain))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      clover::cooperative(grid, (cudaStream_t)stream, &attr);
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
