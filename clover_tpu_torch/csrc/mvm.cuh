// The geometry of the MVM kernels: a CTA of MV_WARPS warps, a 64-row band,
// rows walked in chunks of MV_CHUNK bytes.  The single (mvm.cu) and batched
// (mvm_batched.cu) kernels and both iteration kernels (iteration.cu, through
// mvm_rows.cuh) walk a row of A in the same chunks, groups and lanes, so
// their block sums and row sums are equal, op for op.
#pragma once
#include "common.cuh"

namespace clover {

constexpr int MV_WARPS = 8;
constexpr int MV_THREADS = 32 * MV_WARPS;
constexpr int MV_ROWS = 64 / MV_WARPS;  // rows per warp
constexpr int MV_CHUNK = 512;           // bytes of a row per warp step

}  // namespace clover
