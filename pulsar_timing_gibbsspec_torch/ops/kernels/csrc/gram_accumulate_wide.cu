// Wide form of the segment-sequential augmented Gram
// G[b] = sum_s TNa[b,s]^T Ta[b % P,s], TNa = Ta / N formed on chip, for
// augmented widths too large for one CTA's registers (kGramMaxB1 < B1 <=
// kGramWideMaxB1).
//
// Replaces pulsar_timing_gibbsspec_tpu/ops/kernels/pallas_tpu.py::
// gram_accumulate_pallas at the single-pulsar path's shape (Ta (1, 8, 90,
// 674), N (8, 720): one pulsar with basis ECORR, 8 chains), with the
// narrow form's operands, forms and summation order (csrc/
// gram_accumulate.cu): within a segment each output is a float32 FMA
// chain (float64 products on the tensor cores for the widening form) over
// the TOA rows in index order, and segment partials are added to the
// running sum in segment order (float32, or float64 for the refresh
// form), as the plain version reduces.  Every output is computed, the
// upper triangle too: (Ta_i / N) Ta_j and (Ta_j / N) Ta_i round
// differently, and the plain version computes both.
//
// What bounds it on Hopper: 2 * 720 * 674^2 * 8 = 5.2 GFLOP against 16.5
// MB of G (float32) plus 2 MB of Ta and N: ~0.078 ms by operations at 67
// TFLOP/s, ~0.006 ms by bytes, so the operations bound it.  The narrow
// form holds one chain's whole B1 x B1 output in one CTA's registers,
// which 674^2 outputs cannot fit; here the output is tiled across CTAs:
// one CTA per (64-row tile, 64-column tile, batch row), 11 x 11 x 8 = 968
// CTAs at this shape.  Each CTA streams its pulsar's TOA rows in stages
// of 32 through shared memory, forms its 64 columns of TNa = Ta / N there
// (the narrow form's IEEE quotient), and multiplies:
//   - float32 forms: 256 threads, each a 4 x 4 register block of the
//     tile, two float4 shared-memory reads per row;
//   - widening form: 8 warps on DMMA (mma.sync m8n8k4 f64), each warp 8
//     rows of the tile and its 8 column blocks, TNa and Ta widened to
//     float64 as the stage is formed (products of float32 values are
//     exact in float64).
// The rows a pulsar can contribute come from the narrow form's extent
// scan (ptg_launch_gram_extent): past them every product is an exact
// zero, so the stages stop there.  Thread 0 of the first CTA adds one to
// the form's device counter as it finishes.
#include "kernels.h"

namespace {

constexpr int kRows = 32;     // TOA rows per stage
constexpr int kTileW = 64;    // output tile width and height
constexpr int kLd = kTileW + 4;
constexpr int kThreads = 256;

__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// t / n, bit for bit the IEEE quotient (the narrow form's rule): a zero
// numerator over a nonzero, non-NaN n gives the signed zero directly.
__device__ __forceinline__ float quotient(float t, float n) {
  return (t == 0.f && n == n && n != 0.f) ? t * copysignf(1.f, n) : t / n;
}

struct WideGeom {
  int P, nseg, m, B1, Nmax;
};

// 1 + the last row of pulsar p that can contribute (the extent scan's
// slices reduced)
__device__ int row_extent(const int* __restrict__ extent, int p) {
  int end = 0;
#pragma unroll
  for (int s = 0; s < kGramExtentSlices; ++s)
    end = max(end, extent[p * kGramExtentSlices + s]);
  return end;
}

// Stage rows r0 .. r0 + len - 1 of pulsar p into sA (TNa columns i0 ..)
// and sB (Ta columns j0 ..), Conv-converted; rows len .. fill - 1 are
// zero.
template <typename S>
__device__ void load_stage(const WideGeom& g, const float* __restrict__ Ta,
                           const float* __restrict__ Nb, int p, int r0,
                           int len, int fill, int i0, int j0, S* sA, S* sB) {
  const float* T0 = Ta + (static_cast<size_t>(p) * g.nseg * g.m + r0) * g.B1;
  for (int e = threadIdx.x; e < fill * kTileW; e += blockDim.x) {
    const int k = e / kTileW, col = e % kTileW;
    float a = 0.f, b = 0.f;
    if (k < len) {
      const int r = r0 + k;
      if (i0 + col < g.B1 && r < g.Nmax)
        a = quotient(T0[static_cast<size_t>(k) * g.B1 + i0 + col], Nb[r]);
      if (j0 + col < g.B1) b = T0[static_cast<size_t>(k) * g.B1 + j0 + col];
    }
    sA[k * kLd + col] = static_cast<S>(a);
    sB[k * kLd + col] = static_cast<S>(b);
  }
}

// Float32 products; AccT is the segment-reduce and output type.  Thread
// (ty, tx) of 16 x 16 owns rows i0 + 4 ty .., columns j0 + 4 tx .. .
template <typename AccT>
__global__ void __launch_bounds__(kThreads)
wide_gram_f32_kernel(const float* __restrict__ Ta,
                     const float* __restrict__ N,
                     const int* __restrict__ extent, AccT* __restrict__ G,
                     WideGeom g, unsigned long long* __restrict__ count) {
  __shared__ __align__(16) float sA[kRows * kLd];
  __shared__ __align__(16) float sB[kRows * kLd];
  const int b = blockIdx.z, p = b % g.P;
  const int i0 = blockIdx.y * kTileW, j0 = blockIdx.x * kTileW;
  const float* Nb = N + static_cast<size_t>(b) * g.Nmax;
  const int end = row_extent(extent, p);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float part[4][4];
  AccT acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      part[u][v] = 0.f;
      acc[u][v] = AccT(0);
    }
  for (int s = 0; s < g.nseg && s * g.m < end; ++s) {
    for (int k0 = 0; k0 < g.m && s * g.m + k0 < end; k0 += kRows) {
      const int r0 = s * g.m + k0;
      const int len = min(min(kRows, g.m - k0), end - r0);
      __syncthreads();  // the previous stage's reads are done
      load_stage(g, Ta, Nb, p, r0, len, len, i0, j0, sA, sB);
      __syncthreads();
      for (int k = 0; k < len; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(sA + k * kLd +
                                                          4 * ty);
        const float4 bb = *reinterpret_cast<const float4*>(sB + k * kLd +
                                                           4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            part[u][v] = fmaf(av[u], bv[v], part[u][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[u][v] = acc[u][v] + static_cast<AccT>(part[u][v]);
        part[u][v] = 0.f;
      }
  }
  AccT* Gb = G + static_cast<size_t>(b) * g.B1 * g.B1;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + 4 * ty + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + 4 * tx + v;
      if (i < g.B1 && j < g.B1) Gb[static_cast<size_t>(i) * g.B1 + j] =
          acc[u][v];
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0)
    atomicAdd(count, 1ull);
}

// Widening float64 form on DMMA: warp w owns rows i0 + 8 w .. + 7 and the
// tile's 8 column blocks of 8.  A[i][k] = TNa[k][i] (lane: row lane / 4,
// k lane % 4), B[k][j] = Ta[k][j] (lane: k lane % 4, column lane / 4),
// C: row lane / 4, columns 2 (lane % 4) + {0, 1}.  The row stride kLd =
// 68 puts the four k-rows of a fragment on disjoint banks.
__global__ void __launch_bounds__(kThreads)
wide_gram_dmma_kernel(const float* __restrict__ Ta,
                      const float* __restrict__ N,
                      const int* __restrict__ extent, double* __restrict__ G,
                      WideGeom g, unsigned long long* __restrict__ count) {
  __shared__ double sA[kRows * kLd];
  __shared__ double sB[kRows * kLd];
  const int b = blockIdx.z, p = b % g.P;
  const int i0 = blockIdx.y * kTileW, j0 = blockIdx.x * kTileW;
  const float* Nb = N + static_cast<size_t>(b) * g.Nmax;
  const int end = row_extent(extent, p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double part[8][2], acc[8][2];
#pragma unroll
  for (int ct = 0; ct < 8; ++ct)
    part[ct][0] = part[ct][1] = acc[ct][0] = acc[ct][1] = 0.0;
  const double* pa = sA + (lane & 3) * kLd + 8 * warp + (lane >> 2);
  const double* pb = sB + (lane & 3) * kLd + (lane >> 2);
  for (int s = 0; s < g.nseg && s * g.m < end; ++s) {
    for (int k0 = 0; k0 < g.m && s * g.m + k0 < end; k0 += kRows) {
      const int r0 = s * g.m + k0;
      const int len = min(min(kRows, g.m - k0), end - r0);
      const int rows4 = (len + 3) & ~3;  // the MMA depth, zero-filled
      __syncthreads();
      load_stage(g, Ta, Nb, p, r0, len, rows4, i0, j0, sA, sB);
      __syncthreads();
      for (int k = 0; k < rows4; k += 4) {
        const double a = pa[k * kLd];
#pragma unroll
        for (int ct = 0; ct < 8; ++ct) dmma(part[ct], a, pb[k * kLd + 8 * ct]);
      }
    }
#pragma unroll
    for (int ct = 0; ct < 8; ++ct) {
      acc[ct][0] = acc[ct][0] + part[ct][0];
      acc[ct][1] = acc[ct][1] + part[ct][1];
      part[ct][0] = part[ct][1] = 0.0;
    }
  }
  double* Gb = G + static_cast<size_t>(b) * g.B1 * g.B1;
  const int i = i0 + 8 * warp + (lane >> 2);
#pragma unroll
  for (int ct = 0; ct < 8; ++ct) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + 8 * ct + 2 * (lane & 3) + e;
      if (i < g.B1 && j < g.B1) Gb[static_cast<size_t>(i) * g.B1 + j] =
          acc[ct][e];
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0)
    atomicAdd(count, 1ull);
}

}  // namespace

cudaError_t ptg_launch_gram_accumulate_wide(
    const float* Ta, const float* N, void* G, int* extent, int batch, int P,
    int nseg, int m, int B1, int Nmax, int form, unsigned long long* count,
    cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  cudaError_t err = ptg_launch_gram_extent(Ta, N, extent, batch, P, nseg, m,
                                           B1, Nmax, stream);
  if (err != cudaSuccess) return err;
  const WideGeom g{P, nseg, m, B1, Nmax};
  const int tiles = (B1 + kTileW - 1) / kTileW;
  const dim3 grid(tiles, tiles, batch);
  switch (form) {
    case 0:
      wide_gram_f32_kernel<float><<<grid, kThreads, 0, stream>>>(
          Ta, N, extent, static_cast<float*>(G), g, count);
      break;
    case 1:
      wide_gram_f32_kernel<double><<<grid, kThreads, 0, stream>>>(
          Ta, N, extent, static_cast<double*>(G), g, count);
      break;
    case 2:
      wide_gram_dmma_kernel<<<grid, kThreads, 0, stream>>>(
          Ta, N, extent, static_cast<double*>(G), g, count);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
