// Exact hard threshold of a 4- or 8-bit vector: keep the K largest
// |code * s/qmax|, zero the rest.
//
// Replaces clover_tpu/kernels/threshold.py _kernel4 (threshold4_pallas) and
// _kernel8 (threshold8_pallas).
//
// Order is the golden one (clover_tpu/golden.py threshold): |value|
// descending, then index ascending.  |value| is compared as the bit pattern
// of the f32 product |code| * (s/qmax), the expression of both TPU kernels
// (s/qmax divided first, IEEE), whose non-negative patterns order like the
// values.  m = s/qmax is divided once per slot of 16 elements, which gives
// the same bits as once per element.  Scales are never touched.
//
// Design (threshold.cuh): one CTA of 1024 threads per vector; a stacked
// batch of B vectors (rows of n_pad elements, contiguous) launches B CTAs,
// blockIdx.x picking the row, as clover_tpu vmaps the threshold over a
// batch (models/batch.py).  Each thread takes slots of 16 elements and
// forms their patterns once, without an integer conversion (threshold.cuh
// mag_bits).  A radix select over the patterns finds the exact K-th
// largest pattern tau and how many ties at tau to keep; neither leaves the
// device.  Three passes, digits of 12, 10 and 10 bits, each a shared
// histogram; from the second pass on a pass also takes the least and
// greatest pattern it counted, and when those are equal that pattern is
// tau and the last pass is skipped (tie storms, and most dense data).  A
// last pass ranks each thread's ties in index order (a block-wide
// exclusive scan, carried across chunks of 1024 slots) and writes the kept
// codes, 16 bytes a thread.
//
// Two paths, by resident_path: up to n_pad = 16384, the solver's n, every
// thread holds its slot in registers, so codes and scales are read once;
// above it the passes stream the slots from memory (L2 at the large-n
// sizes) and form the patterns again in every pass.
//
// Bound: at the solver's n = 16384 the 8 or 16 KB of codes are one L2
// round trip; the time is the launch, that round trip, and the passes'
// barriers and 16384 shared atomics on one SM.  The TPU kernels'
// bisection, indicator matmuls and triangular-matmul prefix sums were
// workarounds for Mosaic's lack of sort, scatter and scan; a 4-bit
// (pattern, count) compression like theirs was measured and dropped (no
// faster at 16384, slower at 2^15 and 2^19: counting the magnitudes costs
// more than the atomics it saves).
#include "threshold.cuh"

namespace clover {

constexpr int TH_THREADS = 1024;
constexpr int TH_SLOTS = 1;  // slots a thread holds on the resident path

// The resident path takes n_pad <= 16 * TH_SLOTS * TH_THREADS = 16384
// (the solver's n and every -v size); the streaming path the rest (-p's
// 2^16 and 2^20, the radix 2^19 and 2^23 checks of chip_smoke.py).
inline bool resident_path(int64_t n_pad) {
  return n_pad <= 16 * TH_SLOTS * TH_THREADS;
}

// One CTA per row of a stacked batch.
template <int BITS, bool RESIDENT>
__global__ void __launch_bounds__(TH_THREADS)
threshold_kernel(const int8_t* __restrict__ codes,
                 const float* __restrict__ scales, int8_t* __restrict__ out,
                 int64_t n_pad, int64_t k) {
  __shared__ SelectSmem<TH_THREADS> sm;
  const int64_t nb = n_pad / 64, nbytes = nb * 8 * BITS;
  codes += blockIdx.x * nbytes;
  scales += blockIdx.x * nb;
  out += blockIdx.x * nbytes;
  if constexpr (RESIDENT)
    select_resident<BITS, TH_THREADS, TH_SLOTS, false>(sm, codes, scales, out,
                                                       n_pad, k);
  else
    select_stream<BITS, TH_THREADS>(sm, codes, scales, out, n_pad, k);
}

template <int BITS>
void launch_threshold(const int8_t* codes, const float* scales,
                      int8_t* out, int64_t n_pad, int64_t k, unsigned grid,
                      cudaStream_t s) {
  if (resident_path(n_pad))
    threshold_kernel<BITS, true><<<grid, TH_THREADS, 0, s>>>(codes, scales,
                                                             out, n_pad, k);
  else
    threshold_kernel<BITS, false><<<grid, TH_THREADS, 0, s>>>(codes, scales,
                                                              out, n_pad, k);
}

}  // namespace clover

extern "C" int clover_threshold(const int8_t* codes, const float* scales,
                                int8_t* out, int64_t n_pad, int64_t k,
                                int bits, int64_t batch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 4)
    clover::launch_threshold<4>(codes, scales, out, n_pad, k,
                                (unsigned)batch, s);
  else
    clover::launch_threshold<8>(codes, scales, out, n_pad, k,
                                (unsigned)batch, s);
  return (int)cudaGetLastError();
}
