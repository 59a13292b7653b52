// Segment-sequential augmented Gram G[b] = sum_s TNa[b,s]^T Ta[b % P,s],
// with TNa = Ta / N formed on chip.
//
// Replaces pulsar_timing_gibbsspec_tpu/ops/kernels/pallas_tpu.py::
// gram_accumulate_pallas.  Ta = [T | y] is (P, nseg, m, B1) float32, one
// per pulsar (TOA rows at or beyond Nmax are pad: zero); N is (batch,
// Nmax) float32 with batch row b pairing with pulsar b % P.  TNa[b, s, k]
// is Ta[b % P, s, k] / N[b, s*m + k] (IEEE float32 division: the very
// tensor the plain version forms) on rows s*m + k < Nmax and zero beyond;
// G[:, :B, :B] is T^T N^-1 T and G[:, :B, B] is d = T^T N^-1 y.
//
// What bounds it on Hopper: at the main path's shape (2880 systems, 720
// TOAs, B1 = 38) the inputs are Ta (4.9 MB) and N (8.3 MB) and the output
// G (16.6 MB in float32), against 6.0 GFLOP of products over the whole
// grid (2.4 GFLOP on the rows that hold a TOA), so the bound is the
// operations: ~0.09 ms at 67 TFLOP/s (~0.035 ms).  Forming TNa in device
// memory first, as a 315 MB tensor written and read back, set a byte
// bound of its own above that and is gone.  The design:
//   - a first small kernel finds the rows of each pulsar that can
//     contribute: past the last row whose Ta is nonzero (or whose N is zero
//     or NaN for some chain, which makes 0 / N a NaN) every product is an
//     exact zero, so the Gram kernel stops there.  The pulsars of the main
//     path hold 71-720 TOAs on a 720-row grid, and much of it is pad;
//   - one CTA per (pulsar, group of chains): the pulsar's Ta is loaded once
//     per CTA and serves every chain of the group;
//   - the TOA axis is streamed in stages of kStageRows rows through a ring
//     of kRing = 2 buffers in shared memory (double buffering), filled with
//     cp.async: the next stage's Ta rows and N values are in flight while
//     the CTA divides and multiplies the current one (a deeper ring, tried
//     at 4 and 6, measured slower on the main path);
//   - each stage first forms the group's TNa tiles in shared memory (one
//     IEEE division per element, shared by all B1 outputs that use it;
//     pad columns are never divided, and a zero numerator, which takes the
//     division's slow path, is answered directly with the same signed
//     zero), then multiplies;
//   - float32 forms: B1 is padded to a multiple of 4 (38 -> 40: 90% of the
//     FMAs land on real outputs) and each thread owns a 4 x 4 register tile
//     of one chain's output, fed by two float4 reads of shared memory per
//     TOA (2 FMAs per word read).  Products are IEEE float32 FMAs (no
//     TF32), each output an FMA chain over the TOAs of a segment in index
//     order; the segment's partial is then added to the running sum in
//     segment order (float32, or float64 for the refresh form), as the
//     plain version reduces.  Skipped rows and segments would add exact
//     zeros, so the sums are unchanged;
//   - the widening float64 form runs on the float64 tensor cores
//     (mma.sync m8n8k4 f64, DMMA): TNa and Ta are converted to float64 once
//     per element as the stage is formed (products of float32 values are
//     exact in float64), each warp owns 8 rows of one chain's output and all
//     of its 8-wide column tiles, and segments are reduced in order;
//   - the float64 form (float64 storage: Ta and N float64) is the widening
//     kernel over float64 operands: the raw ring holds 8-byte rows (cp.async
//     of 8 bytes), TNa is the IEEE float64 quotient (__ddiv_rn, no
//     reciprocal: bit for bit the plain version's operand), products and
//     in-segment sums are float64 DMMAs and segments are reduced in order.
//     At B1 = 64 (one chain per CTA) it takes 32 768 B of raw ring, 512 B
//     of N and 34 816 B of float64 tiles: 68 096 B of shared memory.  Its
//     float64 products round (float32 products did not), so it agrees with
//     the plain version to a few ULPs of the Jacobi scale, not bitwise.
#include "kernels.h"

namespace {

constexpr int kStageRows = 32;  // TOA rows per pipeline stage
constexpr int kRing = 2;        // stages of rows in the shared-memory ring
constexpr int kMaxChainsPerCta = 4;
constexpr int kMaxThreads = 512;
// threads per CTA the chain groups aim at: float32 products reduced in
// float32 / in float64 (more registers), widening form
constexpr int kF32Threads = 512, kF64AccThreads = 256, kWidenThreads = 384;
constexpr int kExtentThreads = 256;

// One element of type T (4 or 8 bytes) copied asynchronously into shared
// memory.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// t / n, bit for bit the IEEE quotient.  A zero numerator over a nonzero,
// non-NaN n gives the signed zero t * sign(n) without a division.
__device__ __forceinline__ float quotient(float t, float n) {
  return (t == 0.f && n == n && n != 0.f) ? t * copysignf(1.f, n) : t / n;
}
__device__ __forceinline__ double quotient(double t, double n) {
  return (t == 0.0 && n == n && n != 0.0) ? t * copysign(1.0, n)
                                          : __ddiv_rn(t, n);
}

struct Geom {
  int P;       // Ta rows (pulsars); batch row b pairs with Ta row b % P
  int chains;  // batch / P
  int nseg, m, B1, Nmax;
  int cg;              // chains per CTA
  int spseg;           // pipeline stages per segment
  int rows_per_slice;  // rows of one extent slice
};

// extent[p * kGramExtentSlices + s]: 1 + the last row r of slice s of
// pulsar p (r < Nmax) whose Ta row has a nonzero (or NaN) entry, or whose
// N is zero or NaN for some chain of p; 0 if there is none.
template <typename T>
__global__ void __launch_bounds__(kExtentThreads)
gram_extent_kernel(const T* __restrict__ Ta, const T* __restrict__ N,
                   int* __restrict__ extent, Geom g) {
  __shared__ int s_end;
  const int p = blockIdx.x, sl = blockIdx.y;
  const int r0 = sl * g.rows_per_slice;
  const int rows = max(0, min(g.rows_per_slice, g.Nmax - r0));
  if (threadIdx.x == 0) s_end = 0;
  __syncthreads();
  int end = 0;
  const T* Tp = Ta + (static_cast<size_t>(p) * g.nseg * g.m + r0) * g.B1;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * g.B1; e += blockDim.x)
    if (Tp[e] != T(0)) end = max(end, r0 + e / g.B1 + 1);
#pragma unroll 4
  for (int e = threadIdx.x; e < g.chains * rows; e += blockDim.x) {
    const int c = e / rows, r = r0 + e - c * rows;
    const T nv = N[(static_cast<size_t>(c) * g.P + p) * g.Nmax + r];
    if (nv == T(0) || nv != nv) end = max(end, r + 1);
  }
  if (end > 0) atomicMax(&s_end, end);
  __syncthreads();
  if (threadIdx.x == 0) extent[p * kGramExtentSlices + sl] = s_end;
}

__device__ int pulsar_extent(const int* __restrict__ extent, int p) {
  int end = 0;
#pragma unroll
  for (int s = 0; s < kGramExtentSlices; ++s)
    end = max(end, extent[p * kGramExtentSlices + s]);
  return end;
}

// Stage t covers rows k0 .. k0 + len - 1 of segment s (grid rows r0 ..)
struct Stage {
  int s, k0, len, r0;
  __device__ Stage(const Geom& g, int t) {
    s = t / g.spseg;
    k0 = (t - s * g.spseg) * kStageRows;
    len = min(kStageRows, g.m - k0);
    r0 = s * g.m + k0;
  }
};

// One commit group of copies for stage t into ring slot t % kRing: the
// pulsar's Ta rows below `end` (contiguous in device memory) into sT, and
// for each chain c of the group the N values of those rows below Nmax into
// sN[c][k].  A stage past the last one commits an empty group, which keeps
// the count of groups in flight uniform.
template <typename T>
__device__ void enqueue_stage(const Geom& g, const T* __restrict__ Ta,
                              const T* __restrict__ N, int p, int c0, int nc,
                              int t, int end, T* sT, T* sN) {
  if (t < g.nseg * g.spseg) {
    const Stage st(g, t);
    const int len = min(st.len, end - st.r0);
    T* dT = sT + (t % kRing) * kStageRows * g.B1;
    T* dN = sN + (t % kRing) * g.cg * kStageRows;
    const T* src =
        Ta + ((static_cast<size_t>(p) * g.nseg + st.s) * g.m + st.k0) * g.B1;
    for (int e = threadIdx.x; e < len * g.B1; e += blockDim.x)
      cp_async(dT + e, src + e);
    for (int e = threadIdx.x; e < nc * kStageRows; e += blockDim.x) {
      const int c = e / kStageRows, k = e % kStageRows;
      if (k < len && st.r0 + k < g.Nmax)
        cp_async(dN + e, N + (static_cast<size_t>(c0 + c) * g.P + p) *
                                 g.Nmax +
                             st.r0 + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The stage loop both kernels share: the stages up to the pulsar's
// extent, each waited for, formed into tiles (form(st, len, Tk, N0): Tk
// the stage's Ta rows, N0 its N values with chain c at N0 + c *
// kStageRows) and multiplied (compute(len)); segment_end() after the last
// stage of each segment and after the last stage overall.
template <typename T, typename Form, typename Compute, typename SegmentEnd>
__device__ void stream_stages(const Geom& g, const T* __restrict__ Ta,
                              const T* __restrict__ N, int p, int c0, int nc,
                              int end, T* sT, T* sN, Form form,
                              Compute compute, SegmentEnd segment_end) {
  const int nstage = g.nseg * g.spseg;
  enqueue_stage(g, Ta, N, p, c0, nc, 0, end, sT, sN);
  for (int t = 0; t < nstage; ++t) {
    const Stage st(g, t);
    if (st.r0 >= end) break;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // stage t has landed for every thread, and every thread is done with
    // stage t - 1 (its ring slot and the tiles)
    __syncthreads();
    enqueue_stage(g, Ta, N, p, c0, nc, t + 1, end, sT, sN);
    const int len = min(st.len, end - st.r0);
    form(st, len, sT + (t % kRing) * kStageRows * g.B1,
         sN + (t % kRing) * g.cg * kStageRows);
    __syncthreads();
    compute(len);
    if (st.k0 + st.len == g.m || t + 1 == nstage ||
        Stage(g, t + 1).r0 >= end)
      segment_end();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Both Gram kernels add one to `count` as they finish (thread 0 of the
// first CTA).  The counter is a parameter of its own and the add comes
// last: a field in Geom, or the add at the start, changed ptxas's register
// allocation of gram_f32_kernel<float> (64 -> 73 registers) and cost it a
// fifth of its time on the main path.
//
// Float32 products; AccT is the segment-reduce and output type.  The CTA
// holds cg chains x TB^2 threads, TB = ceil(B1 / 4); thread (c, tr, tc)
// owns the 4 x 4 output tile (4 tr.., 4 tc..) of chain c.
template <typename AccT>
__global__ void __launch_bounds__(kMaxThreads)
gram_f32_kernel(const float* __restrict__ Ta, const float* __restrict__ N,
                const int* __restrict__ extent, AccT* __restrict__ G,
                Geom g, unsigned long long* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TB = (g.B1 + 3) / 4, B1P = 4 * TB;
  const int p = blockIdx.x, c0 = blockIdx.y * g.cg;
  const int nc = min(g.cg, g.chains - c0);
  float* sT = reinterpret_cast<float*>(smem_raw);  // [kRing][kStageRows*B1]
  float* sN = sT + kRing * kStageRows * g.B1;       // [kRing][cg][kStageRows]
  float* sB = sN + kRing * g.cg * kStageRows;       // [kStageRows][B1P]
  float* sA = sB + kStageRows * B1P;                // [cg][kStageRows][B1P]
  const int per = TB * TB;
  const int c = threadIdx.x / per, q = threadIdx.x - c * per;
  const int tr = q / TB, tc = q - tr * TB;
  const bool active = c < nc;

  float part[4][4];
  AccT acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      part[u][v] = 0.f;
      acc[u][v] = AccT(0);
    }

  // sA[c][k] = Ta[k] / N[c][k] (zero at rows >= Nmax and pad columns),
  // and (chain slot 0) sB[k] = Ta[k]; thread (c, tr, tc) forms columns
  // 4 tc.. of rows tr + TB u
  auto form = [&](const Stage& st, int len, const float* Tk,
                  const float* N0) {
    if (!active) return;
    const float* Nc = N0 + c * kStageRows;
    for (int k = tr; k < len; k += TB) {
      const bool live = st.r0 + k < g.Nmax;
      const float nk = live ? Nc[k] : 1.f;
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = 4 * tc + u;
        const bool in = col < g.B1;
        bv[u] = in ? Tk[k * g.B1 + col] : 0.f;
        av[u] = in && live ? quotient(bv[u], nk) : 0.f;
      }
      *reinterpret_cast<float4*>(sA + (c * kStageRows + k) * B1P + 4 * tc) =
          make_float4(av[0], av[1], av[2], av[3]);
      if (c == 0)
        *reinterpret_cast<float4*>(sB + k * B1P + 4 * tc) =
            make_float4(bv[0], bv[1], bv[2], bv[3]);
    }
  };
  auto compute = [&](int len) {
    if (!active) return;
    const float* pa = sA + c * kStageRows * B1P + 4 * tr;
    const float* pb = sB + 4 * tc;
    for (int k = 0; k < len; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(pa + k * B1P);
      const float4 b = *reinterpret_cast<const float4*>(pb + k * B1P);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          part[u][v] = fmaf(av[u], bv[v], part[u][v]);
    }
  };
  auto segment_end = [&]() {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[u][v] = acc[u][v] + static_cast<AccT>(part[u][v]);
        part[u][v] = 0.f;
      }
  };
  stream_stages(g, Ta, N, p, c0, nc, pulsar_extent(extent, p), sT, sN, form,
                compute, segment_end);

  if (!active) return;
  AccT* Gb = G + (static_cast<size_t>(c0 + c) * g.P + p) * g.B1 * g.B1;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = 4 * tr + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = 4 * tc + v;
      if (i < g.B1 && j < g.B1) Gb[i * g.B1 + j] = acc[u][v];
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
}

// Float64 products on DMMA of operands of type T: float32 (the widening
// form) or float64 (the float64 form).  The CTA holds cg chains x RT
// warps, RT = ceil(B1 / 8); warp (c, rt) owns output rows 8 rt .. 8 rt + 7
// of chain c and its RT 8-wide column tiles.  The float64 tiles have row
// stride 8 RT + 4, which puts the four k-rows of an m8n8k4 fragment on
// disjoint banks.
template <int RT, typename T>
__global__ void __launch_bounds__(kMaxThreads)
gram_widen_kernel(const T* __restrict__ Ta, const T* __restrict__ N,
                  const int* __restrict__ extent, double* __restrict__ G,
                  Geom g, unsigned long long* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int B8 = 8 * RT, ld = B8 + 4;
  const int p = blockIdx.x, c0 = blockIdx.y * g.cg;
  const int nc = min(g.cg, g.chains - c0);
  T* sT = reinterpret_cast<T*>(smem_raw);  // [kRing][kStageRows*B1]
  T* sN = sT + kRing * kStageRows * g.B1;  // [kRing][cg][kStageRows]
  double* sB = reinterpret_cast<double*>(sN + kRing * g.cg * kStageRows);
  double* sA = sB + kStageRows * ld;  // [cg][kStageRows][ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = warp / RT, rt = warp - c * RT;
  const bool active = c < nc;  // warp-uniform
  // forming the tiles: a fixed column per thread (blockDim.x = cg * 4 * B8)
  const int fcol = threadIdx.x % B8, frow = threadIdx.x / B8;
  const int fstep = blockDim.x / B8;

  double part[RT][2], acc[RT][2];
#pragma unroll
  for (int ct = 0; ct < RT; ++ct)
    part[ct][0] = part[ct][1] = acc[ct][0] = acc[ct][1] = 0.0;

  // rows up to the stage's length rounded up to 4 (the MMA depth), zero
  // past its end
  auto form = [&](const Stage& st, int len, const T* Tk, const T* N0) {
    const int rows4 = (len + 3) & ~3;
    for (int k = frow; k < rows4; k += fstep) {
      const bool in = k < len && fcol < g.B1;
      const T tv = in ? Tk[k * g.B1 + fcol] : T(0);
      sB[k * ld + fcol] = static_cast<double>(tv);
      const bool live = in && st.r0 + k < g.Nmax;
      for (int cc = 0; cc < nc; ++cc)
        sA[(cc * kStageRows + k) * ld + fcol] =
            live ? static_cast<double>(quotient(tv, N0[cc * kStageRows + k]))
                 : 0.0;
    }
  };
  // A[i][k] = TNa[k][i]: lane holds row lane / 4, column lane % 4;
  // B[k][j] = Ta[k][j]: lane holds row lane % 4, column lane / 4
  auto compute = [&](int len) {
    if (!active) return;
    const int rows4 = (len + 3) & ~3;
    const double* pa =
        sA + (c * kStageRows + (lane & 3)) * ld + 8 * rt + (lane >> 2);
    const double* pb = sB + (lane & 3) * ld + (lane >> 2);
    for (int k = 0; k < rows4; k += 4) {
      const double a = pa[k * ld];
#pragma unroll
      for (int ct = 0; ct < RT; ++ct) dmma(part[ct], a, pb[k * ld + 8 * ct]);
    }
  };
  auto segment_end = [&]() {
#pragma unroll
    for (int ct = 0; ct < RT; ++ct) {
      acc[ct][0] = acc[ct][0] + part[ct][0];
      acc[ct][1] = acc[ct][1] + part[ct][1];
      part[ct][0] = part[ct][1] = 0.0;
    }
  };
  stream_stages(g, Ta, N, p, c0, nc, pulsar_extent(extent, p), sT, sN, form,
                compute, segment_end);

  if (!active) return;
  double* Gb = G + (static_cast<size_t>(c0 + c) * g.P + p) * g.B1 * g.B1;
  const int i = 8 * rt + (lane >> 2);
#pragma unroll
  for (int ct = 0; ct < RT; ++ct) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * ct + 2 * (lane & 3) + e;
      if (i < g.B1 && j < g.B1) Gb[i * g.B1 + j] = acc[ct][e];
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
}

int chains_per_cta(int target_threads, int per_chain) {
  const int fit = target_threads / per_chain;
  return fit < 1 ? 1 : (fit > kMaxChainsPerCta ? kMaxChainsPerCta : fit);
}

template <typename InT, typename OutT>
cudaError_t launch(void (*kernel)(const InT*, const InT*, const int*, OutT*,
                                  Geom, unsigned long long*),
                   const Geom& g, int threads, size_t smem, const InT* Ta,
                   const InT* N, const int* extent, void* G,
                   unsigned long long* count, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(g.P, (g.chains + g.cg - 1) / g.cg);
  kernel<<<grid, threads, smem, stream>>>(Ta, N, extent,
                                          static_cast<OutT*>(G), g, count);
  return cudaGetLastError();
}

// The DMMA kernels (widening form: T float; float64 form: T double).
template <typename T>
cudaError_t launch_dmma(const Geom& g0, const T* Ta, const T* N,
                        const int* extent, void* G,
                        unsigned long long* count, cudaStream_t stream) {
  Geom g = g0;
  const int RT = (g.B1 + 7) / 8;
  g.cg = chains_per_cta(kWidenThreads, 32 * RT);
  const int threads = 32 * RT * g.cg;
  const size_t smem =
      static_cast<size_t>(kRing) * kStageRows * g.B1 * sizeof(T) +
      static_cast<size_t>(kRing) * g.cg * kStageRows * sizeof(T) +
      (1 + g.cg) * static_cast<size_t>(kStageRows) * (8 * RT + 4) *
          sizeof(double);
  const auto run = [&](auto kernel) {
    return launch(kernel, g, threads, smem, Ta, N, extent, G, count, stream);
  };
  switch (RT) {
    case 1:
      return run(gram_widen_kernel<1, T>);
    case 2:
      return run(gram_widen_kernel<2, T>);
    case 3:
      return run(gram_widen_kernel<3, T>);
    case 4:
      return run(gram_widen_kernel<4, T>);
    case 5:
      return run(gram_widen_kernel<5, T>);
    case 6:
      return run(gram_widen_kernel<6, T>);
    case 7:
      return run(gram_widen_kernel<7, T>);
    case 8:
      return run(gram_widen_kernel<8, T>);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t ptg_launch_gram_accumulate(const void* Ta_, const void* N_,
                                       void* G, int* extent, int batch,
                                       int P, int nseg, int m, int B1,
                                       int Nmax, int form,
                                       unsigned long long* count,
                                       cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  Geom g;
  g.P = P;
  g.chains = batch / P;
  g.nseg = nseg;
  g.m = m;
  g.B1 = B1;
  g.Nmax = Nmax;
  g.spseg = (m + kStageRows - 1) / kStageRows;
  g.rows_per_slice = (Nmax + kGramExtentSlices - 1) / kGramExtentSlices;
  g.cg = 1;
  const dim3 egrid(P, kGramExtentSlices);
  if (form == 3) {
    const auto* Ta = static_cast<const double*>(Ta_);
    const auto* N = static_cast<const double*>(N_);
    gram_extent_kernel<double><<<egrid, kExtentThreads, 0, stream>>>(
        Ta, N, extent, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_dmma(g, Ta, N, extent, G, count, stream);
  }
  const auto* Ta = static_cast<const float*>(Ta_);
  const auto* N = static_cast<const float*>(N_);
  gram_extent_kernel<float><<<egrid, kExtentThreads, 0, stream>>>(Ta, N,
                                                                  extent, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (form == 2) return launch_dmma(g, Ta, N, extent, G, count, stream);

  const size_t ring = static_cast<size_t>(kRing) * kStageRows * B1 *
                      sizeof(float);
  const int TB = (B1 + 3) / 4;
  g.cg = chains_per_cta(form == 0 ? kF32Threads : kF64AccThreads, TB * TB);
  const int threads = TB * TB * g.cg;
  const size_t smem =
      ring + static_cast<size_t>(kRing) * g.cg * kStageRows * sizeof(float) +
      (1 + g.cg) * static_cast<size_t>(kStageRows) * 4 * TB * sizeof(float);
  switch (form) {
    case 0:
      return launch(gram_f32_kernel<float>, g, threads, smem, Ta, N, extent,
                    G, count, stream);
    case 1:
      return launch(gram_f32_kernel<double>, g, threads, smem, Ta, N, extent,
                    G, count, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
