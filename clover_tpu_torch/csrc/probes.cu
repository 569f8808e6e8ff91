// Measurement probes: the streaming floor of the one-CTA-per-band geometry.
//
// Replaces clover_tpu/kernels/probes.py _build_probe (dma_probe_call) and
// _build_salted_probe (dma_probe_stream, launch_probe).  Both stream a
// packed 4- or 8-bit matrix of `rows` rows of `wa` bytes through the CTA
// layout of mvm.cuh mvm_band (the whole-iteration kernels', and the fused
// MVM's before mvm.cu split a band over a cluster): one CTA per 64-row
// band, MV_THREADS threads, 8 warps x 8 rows, per 512-byte chunk of a row
// one 16-byte load per lane, so each lane keeps 8 loads in flight.  The
// time is the floor for exactly that geometry, with its limit of rows/64
// CTAs; mvm.cu's geometry can beat it.
//
// What they compute departs from the TPU kernels.  There a tile's DMA moved
// the whole tile whatever the 8x128 touch read; here a load whose value
// feeds no output is deleted by the compiler.  So every byte is summed:
// out[band] = salt + (float)(int32 sum of every code byte of the band), one
// __dp4a against 0x01010101 per 4 bytes.  The int32 sum wraps mod 2^32 in
// any order alike and the conversion and the add round once, so the plain
// versions (kernels/probes.py) agree bit for bit.  The dma probe has no
// salt (0).
//
// Bound: device memory, rows * wa bytes read once; one integer add per 4
// bytes keeps it far below the compute rate.
#include "mvm.cuh"

namespace clover {

template <bool SALTED>
__global__ void __launch_bounds__(MV_THREADS)
probe_kernel(const int8_t* __restrict__ a, const float* __restrict__ salt,
             float* __restrict__ out, int64_t wa) {
  __shared__ int warp_sum[MV_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* rows = a + ((int64_t)blockIdx.x * 64 + warp * MV_ROWS) * wa;
  int acc = 0;
  for (int64_t off = lane * 16; off < wa; off += MV_CHUNK) {
    uint4 w[MV_ROWS];
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r)
      w[r] = *reinterpret_cast<const uint4*>(rows + r * wa + off);
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) {
      acc = __dp4a((int)w[r].x, 0x01010101, acc);
      acc = __dp4a((int)w[r].y, 0x01010101, acc);
      acc = __dp4a((int)w[r].z, 0x01010101, acc);
      acc = __dp4a((int)w[r].w, 0x01010101, acc);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, o);
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < MV_WARPS; ++w) s += warp_sum[w];
    const float base = SALTED ? salt[0] : 0.0f;
    out[blockIdx.x] = base + (float)s;
  }
}

}  // namespace clover

// rows a multiple of 64, wa a multiple of 16 (kernels/probes.py checks both)
extern "C" int clover_dma_probe(const int8_t* a, float* out, int64_t rows,
                                int64_t wa, void* stream) {
  clover::probe_kernel<false>
      <<<(unsigned)(rows / 64), clover::MV_THREADS, 0, (cudaStream_t)stream>>>(
          a, nullptr, out, wa);
  return (int)cudaGetLastError();
}

extern "C" int clover_salted_probe(const int8_t* a, const float* salt,
                                   float* out, int64_t rows, int64_t wa,
                                   void* stream) {
  clover::probe_kernel<true>
      <<<(unsigned)(rows / 64), clover::MV_THREADS, 0, (cudaStream_t)stream>>>(
          a, salt, out, wa);
  return (int)cudaGetLastError();
}
