// Segment-sequential augmented Gram G[b] = sum_s TNa[b,s]^T Ta[b,s].
//
// Replaces pulsar_timing_gibbsspec_tpu/ops/kernels/pallas_tpu.py::
// gram_accumulate_pallas.  Operands are (batch, nseg, m, B1) float32 with
// Ta = [T | y] and TNa = Ta / N; G[:, :B, :B] is T^T N^-1 T and
// G[:, :B, B] is d = T^T N^-1 y.  Ta may carry fewer batch rows than TNa
// (one per pulsar, shared by every chain): row b of TNa pairs with row
// b % batch_ta of Ta.
//
// What bounds it on Hopper: at the main path's shape (2880 x 720 x 38) the
// kernel reads ~320 MB (TNa once, Ta from L2) against ~6 GFLOP, which
// puts the float32 forms near the HBM bound and the float64 form near
// the FP64 bound.  One CTA owns one batch row's whole 38 x 38 output
// tile; a 16 x 16 thread grid holds a ceil(B1/16)-square register tile
// of outputs per thread (3 x 3 at B1 = 38).  The TOA segments are
// streamed through shared memory strictly in order, so the segment
// reduce is the sequential left-to-right reduce of the reference: inside
// a segment each output is a fused multiply-add chain over the TOAs in
// index order, then the segment's partial is added to the running sum.
// Float32 products are IEEE float32 FMAs (no TF32); the widening form
// converts each float32 operand to float64, so every product is exact.
#include "kernels.h"

namespace {

constexpr int kThreads = 16;  // 16 x 16 thread grid

__device__ __forceinline__ float dfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double dfma(double a, double b, double c) {
  return fma(a, b, c);
}

// DotT: in-segment accumulation type; AccT: segment-reduce / output type;
// kRegTile: outputs per thread along each axis, ceil(B1 / 16)
template <typename DotT, typename AccT, int kRegTile>
__global__ void gram_kernel(const float* __restrict__ TNa,
                            const float* __restrict__ Ta,
                            AccT* __restrict__ G, int batch_ta, int nseg,
                            int m, int B1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sA = reinterpret_cast<float*>(smem_raw);  // TNa segment (m x B1)
  float* sB = sA + m * B1;                          // Ta segment  (m x B1)
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int nthr = kThreads * kThreads;
  const int b = blockIdx.x;
  const size_t seg = static_cast<size_t>(m) * B1;
  const float* a_base = TNa + static_cast<size_t>(b) * nseg * seg;
  const float* b_base = Ta + static_cast<size_t>(b % batch_ta) * nseg * seg;

  AccT acc[kRegTile][kRegTile];
#pragma unroll
  for (int r = 0; r < kRegTile; ++r)
#pragma unroll
    for (int c = 0; c < kRegTile; ++c) acc[r][c] = AccT(0);

  for (int s = 0; s < nseg; ++s) {
    __syncthreads();  // previous segment's tiles fully consumed
    for (size_t e = tid; e < seg; e += nthr) {
      sA[e] = a_base[s * seg + e];
      sB[e] = b_base[s * seg + e];
    }
    __syncthreads();
    DotT part[kRegTile][kRegTile];
#pragma unroll
    for (int r = 0; r < kRegTile; ++r)
#pragma unroll
      for (int c = 0; c < kRegTile; ++c) part[r][c] = DotT(0);
    for (int n = 0; n < m; ++n) {
      DotT av[kRegTile], bv[kRegTile];
#pragma unroll
      for (int r = 0; r < kRegTile; ++r) {
        const int i = ty + r * kThreads;
        av[r] = i < B1 ? static_cast<DotT>(sA[n * B1 + i]) : DotT(0);
        const int j = tx + r * kThreads;
        bv[r] = j < B1 ? static_cast<DotT>(sB[n * B1 + j]) : DotT(0);
      }
#pragma unroll
      for (int r = 0; r < kRegTile; ++r)
#pragma unroll
        for (int c = 0; c < kRegTile; ++c)
          part[r][c] = dfma(av[r], bv[c], part[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kRegTile; ++r)
#pragma unroll
      for (int c = 0; c < kRegTile; ++c)
        acc[r][c] = acc[r][c] + static_cast<AccT>(part[r][c]);
  }

  AccT* g = G + static_cast<size_t>(b) * B1 * B1;
#pragma unroll
  for (int r = 0; r < kRegTile; ++r) {
    const int i = ty + r * kThreads;
#pragma unroll
    for (int c = 0; c < kRegTile; ++c) {
      const int j = tx + c * kThreads;
      if (i < B1 && j < B1) g[i * B1 + j] = acc[r][c];
    }
  }
}

template <typename DotT, typename AccT, int R>
cudaError_t launch_tile(const float* TNa, const float* Ta, AccT* G, int batch,
                        int batch_ta, int nseg, int m, int B1,
                        cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(m) * B1 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_kernel<DotT, AccT, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gram_kernel<DotT, AccT, R>
      <<<batch, dim3(kThreads, kThreads), smem, stream>>>(
          TNa, Ta, G, batch_ta, nseg, m, B1);
  return cudaGetLastError();
}

template <typename DotT, typename AccT>
cudaError_t launch(const float* TNa, const float* Ta, AccT* G, int batch,
                   int batch_ta, int nseg, int m, int B1,
                   cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  switch ((B1 + kThreads - 1) / kThreads) {
    case 1:
      return launch_tile<DotT, AccT, 1>(TNa, Ta, G, batch, batch_ta, nseg, m,
                                        B1, stream);
    case 2:
      return launch_tile<DotT, AccT, 2>(TNa, Ta, G, batch, batch_ta, nseg, m,
                                        B1, stream);
    case 3:
      return launch_tile<DotT, AccT, 3>(TNa, Ta, G, batch, batch_ta, nseg, m,
                                        B1, stream);
    case 4:
      return launch_tile<DotT, AccT, 4>(TNa, Ta, G, batch, batch_ta, nseg, m,
                                        B1, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t ptg_launch_gram_accumulate(const float* TNa, const float* Ta,
                                       void* G, int batch, int batch_ta,
                                       int nseg, int m, int B1, int form,
                                       cudaStream_t stream) {
  switch (form) {
    case 0:
      return launch<float, float>(TNa, Ta, static_cast<float*>(G), batch,
                                  batch_ta, nseg, m, B1, stream);
    case 1:
      return launch<float, double>(TNa, Ta, static_cast<double*>(G), batch,
                                   batch_ta, nseg, m, B1, stream);
    case 2:
      return launch<double, double>(TNa, Ta, static_cast<double*>(G), batch,
                                    batch_ta, nseg, m, B1, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
