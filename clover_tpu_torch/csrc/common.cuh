// Helpers shared by the kernels.  Every source is built with -fmad=false and
// IEEE division (no --use_fast_math), so each product, sum and quotient
// below rounds once, exactly as the plain torch versions do.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace clover {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// Stochastic rounding of one value, in the op order of
// clover_tpu/ops/_core.py sr_codes: mult = qm / s (by the caller), then
// floor(|x| * mult + u), clamped to qm, sign reapplied.  The clamp binds:
// |x| * mult can round to just above qm and u can reach 1 - 2^-24.
__device__ __forceinline__ int sr_code(float x, float mult, float qm, float u) {
  const float mag = fabsf(x) * mult + u;
  const int q = (int)fminf(floorf(mag), qm);
  return x < 0.0f ? -q : q;
}

// Zero block scale -> 1.0 (clover_tpu/ops/_core.py block_scales).
__device__ __forceinline__ float nonzero_scale(float s) {
  return s == 0.0f ? 1.0f : s;
}

// Packed 4-bit byte: low nibble lo + 8, high nibble hi (formats.py).
__device__ __forceinline__ int8_t pack_byte(int lo, int hi) {
  return (int8_t)(16 * hi + lo + 8);
}

__device__ __forceinline__ int low_code(int byte) { return (byte & 15) - 8; }
__device__ __forceinline__ int high_code(int byte) { return byte >> 4; }

// A 16-byte copy from device to shared memory that bypasses L1
// (cp.async.cg); it lands after cp.async.wait_group / wait_all.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Loads of data that another CTA of the same cooperative launch wrote
// before a grid barrier (iteration.cu): ld.global.cg reads L2, so no SM
// sees a stale L1 line of an earlier iteration, and the volatile asm with
// a memory clobber keeps the compiler from caching or hoisting the load
// across the barrier.
__device__ __forceinline__ uint4 ld_cg(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int8_t ld_cg(const int8_t* p) {
  int v;
  asm volatile("ld.global.cg.s8 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return (int8_t)v;
}

// A plain load, or ld_cg when CG.
template <bool CG, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (CG)
    return ld_cg(p);
  else
    return *p;
}

}  // namespace clover
