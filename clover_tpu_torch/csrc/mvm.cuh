// Geometry and nibble unpacking shared by the single (mvm.cu) and batched
// (mvm_batched.cu) MVM kernels.  Both walk a row of A in the same chunks,
// groups and lanes, so a batched vector's block sums are the single
// kernel's, op for op.
#pragma once
#include "common.cuh"

namespace clover {

constexpr int MV_WARPS = 8;
constexpr int MV_ROWS = 64 / MV_WARPS;  // rows per warp
constexpr int MV_CHUNK = 512;           // bytes of a row per warp step

// Packed word of 4 bytes -> (low codes, high codes) as signed int8x4.
__device__ __forceinline__ void unpack_word(uint32_t w, int& lo, int& hi) {
  lo = (int)__vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
  hi = (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

}  // namespace clover
