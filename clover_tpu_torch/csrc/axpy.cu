// Standalone scaleAndAdd of two 4- or 8-bit block-scaled vectors:
//
//   r = band-requant(u*(us/q) + alpha*(v*(vs/q)))   absmax, SR, per 64-block
//
// with q = 7 (4-bit) or 127 (8-bit), r at the operands' precision.
//
// Replaces clover_tpu/kernels/quantize.py axpy_pallas (_axpy_kernel).  The
// TPU kernel works on whole planes of packed nibbles to feed its vector
// unit; here the layout and op order are those of the AXPY epilogue of
// csrc/mvm.cu, so a two-kernel mvm -> scale_and_add equals the fused
// mvm_axpy bit for bit: one warp per 64-element block, lane j holding
// elements j and j + 32 (the two nibbles of packed byte j), the restore
// multipliers divided first (IEEE), u*um + alpha*(v*vm), a warp absmax and
// sr_code with Philox leg 1 (LEG_AXPY), counter = element index.
//
// The operands are flat: any number of elements that is a multiple of 128,
// so a stacked (B, n_pad) batch is one launch over B*n_pad elements whose
// noise counters run over the flat index.
//
// Bound: launch latency at the solvers' sizes (a 16384-element 4-bit vector
// is 8 KB of codes); in bulk, device memory, each byte read once.
#include "common.cuh"

namespace clover {

constexpr int AX_WARPS = 8;  // 64-element blocks per CTA

template <int BITS>
__global__ void __launch_bounds__(AX_WARPS * 32)
axpy_kernel(const int8_t* __restrict__ u, const float* __restrict__ u_scales,
            const int8_t* __restrict__ v, const float* __restrict__ v_scales,
            float alpha, int8_t* __restrict__ out,
            float* __restrict__ out_scales, int64_t nb, int noise,
            uint32_t seed) {
  constexpr float QM = BITS == 4 ? 7.0f : 127.0f;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * AX_WARPS + (threadIdx.x >> 5);
  if (b >= nb) return;  // whole warps only: nb is per warp
  const int64_t i0 = b * 64 + lane, i1 = i0 + 32;
  int u0, u1, v0, v1;
  if constexpr (BITS == 4) {
    const int pu = u[b * 32 + lane], pv = v[b * 32 + lane];
    u0 = low_code(pu);
    u1 = high_code(pu);
    v0 = low_code(pv);
    v1 = high_code(pv);
  } else {
    u0 = u[i0];
    u1 = u[i1];
    v0 = v[i0];
    v1 = v[i1];
  }
  const float um = u_scales[b] / QM;
  const float vm = v_scales[b] / QM;
  const float x0 = (float)u0 * um + alpha * ((float)v0 * vm);
  const float x1 = (float)u1 * um + alpha * ((float)v1 * vm);
  const float s = nonzero_scale(warp_max(fmaxf(fabsf(x0), fabsf(x1))));
  const float mult = QM / s;
  const int q0 = sr_code(x0, mult, QM, sr_noise(noise, seed, i0, 1));
  const int q1 = sr_code(x1, mult, QM, sr_noise(noise, seed, i1, 1));
  if constexpr (BITS == 4) {
    out[b * 32 + lane] = pack_byte(q0, q1);
  } else {
    out[i0] = (int8_t)q0;
    out[i1] = (int8_t)q1;
  }
  if (lane == 0) out_scales[b] = s;
}

}  // namespace clover

extern "C" int clover_axpy(const int8_t* u, const float* u_scales,
                           const int8_t* v, const float* v_scales,
                           float alpha, int8_t* out, float* out_scales,
                           int64_t n_elems, int bits, int noise,
                           uint32_t seed, void* stream) {
  const int64_t nb = n_elems / 64;
  const unsigned grid =
      (unsigned)((nb + clover::AX_WARPS - 1) / clover::AX_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 4)
    clover::axpy_kernel<4><<<grid, clover::AX_WARPS * 32, 0, s>>>(
        u, u_scales, v, v_scales, alpha, out, out_scales, nb, noise, seed);
  else if (bits == 8)
    clover::axpy_kernel<8><<<grid, clover::AX_WARPS * 32, 0, s>>>(
        u, u_scales, v, v_scales, alpha, out, out_scales, nb, noise, seed);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
