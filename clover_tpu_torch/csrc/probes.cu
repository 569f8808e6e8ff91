// Measurement probes: the streaming floors of the fused MVM's geometry and
// of the one-CTA-per-band geometry.
//
// Replaces clover_tpu/kernels/probes.py _build_probe (dma_probe_call) and
// _build_salted_probe (dma_probe_stream, launch_probe).  Each streams a
// packed 4- or 8-bit matrix of `rows` rows of `wa` bytes:
//   - probe_cluster_kernel (dma_probe_cluster) through the launch geometry
//     of mvm.cu's mvm_kernel, as the reference's probe streams through the
//     fused MVM's grid: a 64-row band over a cluster of C = 8 / R CTAs of 8
//     warps x R rows (R from kernels/mvm.py rows_per_warp), each warp's R
//     rows through a ring of Depth<R>::PA chunks of 512 bytes, A read with
//     ld.global.cs, a lane's 16 bytes of a chunk where row_sums reads them.
//     Its time is the floor of the MVM's own geometry, which -p reports
//     the MVM rows against;
//   - probe_kernel (dma_probe, salted_probe) one CTA per 64-row band,
//     MV_THREADS threads, 8 warps x 8 rows, per 512-byte chunk of a
//     row one 16-byte load per lane, so each lane keeps 8 loads in flight.
//     Its time is the floor for exactly that geometry, with its limit of
//     rows/64 CTAs.
//
// What they compute departs from the TPU kernels.  There a tile's DMA moved
// the whole tile whatever the 8x128 touch read; here a load whose value
// feeds no output is deleted by the compiler.  So every byte is summed:
// out[band] = salt + (float)(int32 sum of every code byte of the band), one
// __dp4a against 0x01010101 per 4 bytes.  The int32 sum wraps mod 2^32 in
// any order alike and the conversion and the add round once, so the plain
// versions (kernels/probes.py) agree bit for bit.  The dma probes have no
// salt (0).
//
// Bound: device memory, rows * wa bytes read once; one integer add per 4
// bytes keeps it far below the compute rate.
#include <cooperative_groups.h>

#include "mvm_rows.cuh"

namespace cgrp = cooperative_groups;

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

// CTA i owns rows 8R i ... 8R i + 8R - 1 (mvm.cu's mvm_kernel), warp w the
// R from 8R i + R w; the band's warps meet in the cluster leader's sums.
template <int R>
__global__ void __launch_bounds__(MV_THREADS, 2)
probe_cluster_kernel(const int8_t* __restrict__ a, float* __restrict__ out,
                     int64_t wa) {
  constexpr int C = MV_ROWS / R, PA = Depth<R>::PA;
  __shared__ int sums[C * MV_WARPS];
  cgrp::cluster_group cluster = cgrp::this_cluster();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t band = blockIdx.x / C;
  const int rank = (int)(blockIdx.x % C);
  const int first = rank * (MV_WARPS * R) + warp * R;
  const int8_t* rows = a + (band * 64 + first) * wa + lane * 16;
  const int64_t nch = (wa + MV_CHUNK - 1) / MV_CHUNK;
  uint4 w[PA][R];
  auto load = [&](uint4(&dst)[R], int64_t c) {
    const bool valid = c * MV_CHUNK + lane * 16 < wa;
#pragma unroll
    for (int r = 0; r < R; ++r)
      dst[r] = ld_stream(rows + r * wa + c * MV_CHUNK, valid);
  };
  int acc = 0;
#pragma unroll
  for (int s = 0; s < PA - 1; ++s) load(w[s], s);
  for (int64_t c0 = 0; c0 < nch; c0 += PA) {
#pragma unroll
    for (int s = 0; s < PA; ++s) {
      load(w[(s + PA - 1) % PA], c0 + s + PA - 1);
      if (c0 + s < nch) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc = __dp4a((int)w[s][r].x, 0x01010101, acc);
          acc = __dp4a((int)w[s][r].y, 0x01010101, acc);
          acc = __dp4a((int)w[s][r].z, 0x01010101, acc);
          acc = __dp4a((int)w[s][r].w, 0x01010101, acc);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, o);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (lane == 0) cluster.map_shared_rank(sums, 0)[rank * MV_WARPS + warp] = acc;
  cluster.sync();
  if (rank != 0 || threadIdx.x != 0) return;
  int s = 0;
#pragma unroll
  for (int i = 0; i < C * MV_WARPS; ++i) s += sums[i];
  out[band] = (float)s;
}

template <int R>
cudaError_t launch_cluster_probe(const int8_t* a, float* out, int64_t rows,
                                 int64_t wa, cudaStream_t s) {
  constexpr int C = MV_ROWS / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows / 64 * C));
  cfg.blockDim = dim3(MV_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, probe_cluster_kernel<R>, a, out, wa);
}

}  // namespace clover

// rows a multiple of 64, wa a multiple of 16 (kernels/probes.py checks
// both), rows_per_warp R = 2, 4 or 8 (kernels/mvm.py rows_per_warp)
extern "C" int clover_dma_probe_cluster(const int8_t* a, float* out,
                                        int64_t rows, int64_t wa,
                                        int rows_per_warp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (rows_per_warp) {
    case 2:
      e = clover::launch_cluster_probe<2>(a, out, rows, wa, s);
      break;
    case 4:
      e = clover::launch_cluster_probe<4>(a, out, rows, wa, s);
      break;
    case 8:
      e = clover::launch_cluster_probe<8>(a, out, rows, wa, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

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
