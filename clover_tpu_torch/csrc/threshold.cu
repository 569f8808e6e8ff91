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
// values.  Scales are never touched.
//
// Design: one CTA of 1024 threads per vector; a stacked batch of B vectors
// (rows of n_pad elements, contiguous) launches B CTAs, blockIdx.x picking
// the row, as clover_tpu vmaps the threshold over a batch
// (models/batch.py).  A radix select over the 32-bit patterns,
// four passes of 8 bits with a shared 256-bin histogram, finds the exact
// K-th largest pattern tau and how many ties at tau to keep; neither leaves
// the device.  A last pass gives each thread one 64-element block, counts
// its ties in index order, takes a block-wide exclusive scan of the counts
// (carried across chunks of 1024 blocks), and writes the kept codes (packed
// again for 4 bits).  Bound: at the solver's n = 16384 the 8 or 16 KB of
// codes sit in L1/L2, so the time is the passes' latency on one SM, not
// bandwidth: the known limit of a single-CTA select.  The TPU kernels'
// bisection, indicator matmuls and triangular-matmul prefix sums were
// workarounds for Mosaic's lack of sort, scatter and scan.
#include "threshold.cuh"

namespace clover {

constexpr int TH_THREADS = 1024;

// One CTA per row of a stacked batch; the select is threshold_select
// (threshold.cuh), which the chained iteration kernel runs too.
template <int BITS>
__global__ void __launch_bounds__(TH_THREADS)
threshold_kernel(const int8_t* __restrict__ codes,
                 const float* __restrict__ scales, int8_t* __restrict__ out,
                 int64_t n_pad, int64_t k) {
  const int64_t nb = n_pad / 64, nbytes = nb * 8 * BITS;
  threshold_select<BITS, TH_THREADS, false>(
      codes + blockIdx.x * nbytes, scales + blockIdx.x * nb,
      out + blockIdx.x * nbytes, n_pad, k);
}

}  // namespace clover

extern "C" int clover_threshold(const int8_t* codes, const float* scales,
                                int8_t* out, int64_t n_pad, int64_t k,
                                int bits, int64_t batch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)batch;
  if (bits == 4)
    clover::threshold_kernel<4><<<grid, clover::TH_THREADS, 0, s>>>(
        codes, scales, out, n_pad, k);
  else
    clover::threshold_kernel<8><<<grid, clover::TH_THREADS, 0, s>>>(
        codes, scales, out, n_pad, k);
  return (int)cudaGetLastError();
}
