// Fused requantizing MVM, with an optional scaleAndAdd epilogue, for a 4- or
// 8-bit matrix A times a 4- or 8-bit vector x: modes 4x4 (4-bit output),
// 4x8 and 8x8 (8-bit output); and its f32-output mode.
//
// Replaces clover_tpu/kernels/mvm.py mvm_pallas and mvm_axpy_pallas (bodies
// _kernel_4x4, _kernel_4x4_i4, _kernel_4x8 and _kernel_8x8, epilogues
// _requant_write and _requant_axpy_write), and mvm_pallas_f32 (the same
// bodies, _build_call with out_bits 32): mvm_f32_kernel writes the 64 f32
// sums y of a band and no codes, for the sharded path, which sums the
// shards' partials before the band requant (clover_tpu/parallel/ops.py
// mvm_psum):
//
//   y   = A x                       exact int32 dot per (row, 64-block),
//                                   times (sA/qA)*(sx/qx) in f32, summed
//   q1  = band-requant(y)           absmax, SR, per 64-row band, qmax qO
//   out = q1                                          (mvm)
//   out = band-requant(u*(us/qO) + alpha*(q1*(s1/qO)))  (mvm_axpy)
//
// with qA, qx, qO = 7 for 4 bits and 127 for 8 bits.  The intermediate q1 is
// always formed, never skipped.  The scale combine is (sA/qA)*(sx/qx), the
// order of the XLA path (clover_tpu/ops/mvm.py); the TPU kernels'
// sA*sx*(1/(qA*qx)) rounds differently, within the 1-LSB contract.
//
// Summation order, mirrored op for op by the plain version
// (clover_tpu_torch/kernels/mvm.py blocked_sum): a row of A is walked by one
// warp in 512-byte chunks; per chunk a group of lanes owns one 64-element
// block, each lane 16 bytes (a lane pair for a 32-byte packed 4-bit block,
// a lane quad for a 64-byte 8-bit block), so G = 16 groups (4-bit A) or 8.
// Group g adds the products of blocks g, g + G, g + 2G, ... in that order,
// starting from 0; then the G group sums reduce as (g, g ^ G/2),
// (g, g ^ G/4), ..., (g, g ^ 1).  The iteration kernels (iteration.cu,
// through mvm_rows.cuh) and the batched kernel (mvm_batched.cu) keep the
// same order, so every kernel gives a row the same f32 sum.
//
// Bound: device memory.  Each matrix byte is read once; x (at most 512 KB)
// and the scales are re-read from L1/L2.  The design keeps enough bytes of
// A in flight on every SM at every m:
//   - Rows, not the reduction, are split across CTAs.  A 64-row band is
//     shared by a thread-block cluster of C = 8 / R CTAs, each of 8 warps x
//     R rows (R = 2, 4 or 8; kernels/mvm.py rows_per_warp takes the most
//     rows per warp that still gives every SM a CTA, the fastest geometry
//     at every shape kernel_ab.py --rows times: R = 2 at m = 2048, 128
//     CTAs where the parent had 32; R = 4 at m = 8192, 256 CTAs).  Each
//     CTA stores its 8R row sums into the cluster leader's ys[64] through
//     distributed shared memory, then a cluster barrier; the leader's warp
//     0 runs the band requant and the AXPY epilogue (band_epilogue).  The
//     f32 mode needs no cluster: each warp stores its own sums.
//   - Split-K (a row's chunks over several CTAs) was not taken: it changes
//     the order in which a row's blocks are added, and with it the bits of
//     y, which the plain versions, the batched kernel and the
//     whole-iteration kernels all share.  A row split keeps each row's
//     order as it is.
//   - Each warp streams its R rows through a ring of registers PA chunks
//     deep (PA = 4 for R = 2, else 2): the loads of chunk c + PA - 1 are
//     issued before chunk c is consumed, so (PA - 1) * R * 512 bytes of A
//     per warp stay in flight while the warp computes, 24-32 KB per SM; x
//     and the scales run as far ahead.  A is read with ld.global.cs
//     (streamed: it is touched once), x through the read-only path, each
//     load a volatile asm so that no prefetch is moved towards its use.
//   - The block dot needs no unpacking of A: for 4-bit A,
//       sum lo*xl + hi*xh = dp4a_us(w & 0x0F0F0F0F, xl) - 8 sum xl
//                           + dp4a(w & 0xF0F0F0F0, xh) / 16
//     since a low nibble is its code + 8 and a masked high nibble is 16
//     times its signed code; the integers are the codes themselves, so
//     every block dot is exact, whatever the kernel.  x is unpacked once
//     per chunk per warp and shared by the warp's R rows.
// Hopper has no int4 tensor-core path and a GEMV has nothing to reuse, so
// no tensor core is used.
#include <cooperative_groups.h>

#include "mvm_rows.cuh"

namespace cgrp = cooperative_groups;

namespace clover {

// CTA i owns rows 8R i ... 8R i + 8R - 1, warp w the R from 8R i + R w; a
// cluster of MV_ROWS / R CTAs holds one band.
template <int BA, int BX, int R>
__global__ void __launch_bounds__(MV_THREADS, 2) mvm_kernel(const MvmArgs p) {
  constexpr int C = MV_ROWS / R;  // CTAs per band
  __shared__ float ys[64];
  cgrp::cluster_group cluster = cgrp::this_cluster();
  // every CTA of the cluster has started before any writes the leader's ys
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t band = blockIdx.x / C;
  const int first = (int)(blockIdx.x % C) * (MV_WARPS * R) + warp * R;
  const int64_t wa = p.n_pad * BA / 8, nb = p.n_pad / 64;
  float v[R];
  row_sums<BA, BX, R>(p.a + (band * 64 + first) * wa, p.a_scales + band * nb,
                      p.x, p.x_scales, p.n_pad, v);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  float* lead = cluster.map_shared_rank(ys, 0);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) lead[first + r] = v[r];
  }
  cluster.sync();
  if (cluster.block_rank() != 0 || warp != 0) return;
  band_epilogue<BA, BX>(band, ys, p);
}

// f32-output mode: each warp writes its R sums y[row] (the sums the
// requant would read); no Philox, no AXPY, no cluster.  n_pad and m_pad
// need only be multiples of 64 (a shard's side).
template <int BA, int BX, int R>
__global__ void __launch_bounds__(MV_THREADS, 2)
mvm_f32_kernel(const MvmArgs p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * (MV_WARPS * R) + warp * R;
  const int64_t wa = p.n_pad * BA / 8, nb = p.n_pad / 64;
  float v[R];
  row_sums<BA, BX, R>(p.a + row * wa, p.a_scales + (row / 64) * nb, p.x,
                      p.x_scales, p.n_pad, v);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) p.out_f32[row + r] = v[r];
  }
}

template <int BA, int BX, int R, bool F32>
cudaError_t launch_rows(const MvmArgs& p, int64_t m_pad, cudaStream_t s) {
  constexpr int C = MV_ROWS / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(m_pad / 64 * C));
  cfg.blockDim = dim3(MV_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = F32 ? 0 : 1;
  if constexpr (F32)
    return cudaLaunchKernelEx(&cfg, mvm_f32_kernel<BA, BX, R>, p);
  else
    return cudaLaunchKernelEx(&cfg, mvm_kernel<BA, BX, R>, p);
}

template <int BA, int BX, bool F32>
cudaError_t launch_mode(const MvmArgs& p, int64_t m_pad, int rows_per_warp,
                        cudaStream_t s) {
  switch (rows_per_warp) {
    case 2:
      return launch_rows<BA, BX, 2, F32>(p, m_pad, s);
    case 4:
      return launch_rows<BA, BX, 4, F32>(p, m_pad, s);
    case 8:
      return launch_rows<BA, BX, 8, F32>(p, m_pad, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool F32>
int launch(const MvmArgs& p, int64_t m_pad, int bits_a, int bits_x,
           int rows_per_warp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (bits_a == 4 && bits_x == 4)
    e = launch_mode<4, 4, F32>(p, m_pad, rows_per_warp, s);
  else if (bits_a == 4 && bits_x == 8)
    e = launch_mode<4, 8, F32>(p, m_pad, rows_per_warp, s);
  else if (bits_a == 8 && bits_x == 8)
    e = launch_mode<8, 8, F32>(p, m_pad, rows_per_warp, s);
  else
    return (int)cudaErrorInvalidValue;
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace clover

extern "C" int clover_mvm(const int8_t* a, const float* a_scales,
                          const int8_t* x, const float* x_scales,
                          const int8_t* u, const float* u_scales, float alpha,
                          int8_t* out, float* out_scales, int64_t m_pad,
                          int64_t n_pad, int bits_a, int bits_x, int noise1,
                          uint32_t seed1, int noise2, uint32_t seed2,
                          int rows_per_warp, void* stream) {
  const clover::MvmArgs p = {a,     a_scales, x,     x_scales, u,
                             u_scales, alpha, out, out_scales, nullptr,
                             n_pad, noise1,   seed1, noise2,   seed2};
  return clover::launch<false>(p, m_pad, bits_a, bits_x, rows_per_warp,
                               stream);
}

extern "C" int clover_mvm_f32(const int8_t* a, const float* a_scales,
                              const int8_t* x, const float* x_scales,
                              float* out, int64_t m_pad, int64_t n_pad,
                              int bits_a, int bits_x, int rows_per_warp,
                              void* stream) {
  const clover::MvmArgs p = {a,       a_scales, x,  x_scales, nullptr,
                             nullptr, 0.0f,     nullptr, nullptr, out,
                             n_pad,   0,        0u, 0,        0u};
  return clover::launch<true>(p, m_pad, bits_a, bits_x, rows_per_warp,
                              stream);
}
