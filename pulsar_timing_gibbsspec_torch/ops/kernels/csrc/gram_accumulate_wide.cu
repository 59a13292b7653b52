// Wide form of the segment-sequential augmented Gram
// G[b] = sum_s TNa[b,s]^T Ta[b % P,s], TNa = Ta / N formed on chip, for
// augmented widths too large for one CTA's registers (kGramMaxB1 < B1 <=
// kGramWideMaxB1).
//
// Replaces pulsar_timing_gibbsspec_tpu/ops/kernels/pallas_tpu.py::
// gram_accumulate_pallas at the single-pulsar path's shape (Ta (1, 8, 90,
// 674), N (8, 720): one pulsar with basis ECORR, 8 chains), with the
// narrow form's operands, forms and summation order (csrc/
// gram_accumulate.cu): within a segment each output is one float32 FMA
// chain over the TOA rows in index order (float64 products on the tensor
// cores, in k-groups of 4 from the segment's start, for the widening
// form), and segment partials are added to the running sum in segment
// order (float32, or float64 for the refresh form), as the plain version
// reduces.  Every output is computed, the upper triangle too: (Ta_i / N)
// Ta_j and (Ta_j / N) Ta_i round differently, and the plain version
// computes both.  Tiling the outputs differently changes no output's
// chain, so the kernel stays bitwise equal to the plain version.
//
// What bounds it on Hopper: 2 * 720 * 674^2 * 8 = 5.2 GFLOP against 16.5
// MB of G (float32) plus 2 MB of Ta and N: ~0.078 ms by operations at 67
// TFLOP/s, ~0.006 ms by bytes, so the operations bound it, and what
// decides the time is how many FMA pipes are busy.  The design:
//   - large output tiles chosen against 674's quantization, one CTA per
//     (row tile, column tile, batch row): 176 x 176 for the float32 form
//     (4 x 4 tiles of a 674-wide output, 4% of a dimension idle; 128 CTAs
//     at 8 chains, one wave on 132 SMs), 136 x 136 for the float64-reduce
//     form (5 x 5, 1% idle), whose float64 running sums need twice the
//     room, and 128 x 128 for the widening form;
//   - float32 forms: each thread owns an 8 x 8 block of the tile (two
//     4 x 4 quadrants, half a tile apart), fed per TOA row by four float4
//     shared-memory reads: 4 FMAs per word read, where the first wide form
//     did 2.  The segment's partial stays in registers; the running sum
//     across segments lives in shared memory (one slot per thread and
//     output, lane-consecutive), touched only at segment ends;
//   - widening form: 16 warps on DMMA (mma.sync m8n8k4 f64), each a 32 x
//     32 block of the tile (4 x 4 MMA tiles), so each A and B fragment
//     feeds 4 MMAs;
//   - the TOA rows stream in stages of kStage = 16 through rings of
//     buffers filled with cp.async (4-byte copies: a row of Ta is 674
//     floats, 2696 B, so rows are 8- but not 16-byte aligned).  One CTA
//     barrier per stage: after it, stage t+2's raw Ta rows and N values
//     are put in flight, stage t+1's operands are formed and stage t is
//     multiplied, each warp going from one to the next;
//   - each stage forms its quotients once, for the CTA's row tile, in
//     shared memory with the narrow form's IEEE quotient(); the float32
//     forms multiply the column tile's Ta rows straight from their ring.
//   - the float64 form (float64 storage: Ta and N float64) is a DMMA
//     kernel of its own: 8-byte raw rows would not fit beside the widening
//     form's 128 x 128 tile (231 552 B of the 232 448 B a CTA can have).
//     Its running sums stay in shared memory as the widening form's do,
//     its stages hold 8 rows, the column tile's Ta rows are multiplied
//     straight from their ring (no conversion), and only the row tile's
//     quotients (IEEE float64, __ddiv_rn) are formed.  The tile follows
//     the grid: 128 x 128 (16 warps, 189 824 B) where that grid holds at
//     least one CTA per SM (8 chains at B1 = 674: 288 CTAs), else 64 x 64
//     (4 warps, 62 848 B, several CTAs per SM; one chain at B1 = 674:
//     121 CTAs on 132 SMs).  Its float64 products round, so it agrees with
//     the plain version to a few ULPs of the Jacobi scale, not bitwise.
// Every TOA row of the grid is multiplied, pad rows too, as the plain
// version multiplies them: a skipped zero product could turn a -0 partial
// into +0 and back, and on the single pulsar every row holds a TOA.  One
// launch per call; thread 0 of the first CTA adds one to the form's
// device counter as it finishes.  Every form takes more than 48 KB of
// dynamic shared memory, set on its first launch on a device (which
// precedes any CUDA graph capture).
#include "kernels.h"

namespace {

constexpr int kStage = 16;  // TOA rows per stage: a multiple of the DMMA depth
constexpr int kStage64 = 8;  // the float64 form's stage
constexpr int kMaxDevices = 64;
// output tile: 8 * TD square for the float32 forms (TD x TD threads)
constexpr int kF32TD = 22, kF64AccTD = 17;
// widening form: tile, row stride of its float64 stage tiles, threads
constexpr int kDmmaTile = 128, kDmmaLd = kDmmaTile + 4, kDmmaThreads = 512;

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

// t / n, bit for bit the IEEE quotient (the narrow form's rule): a zero
// numerator over a nonzero, non-NaN n gives the signed zero directly.
__device__ __forceinline__ float quotient(float t, float n) {
  return (t == 0.f && n == n && n != 0.f) ? t * copysignf(1.f, n) : t / n;
}
__device__ __forceinline__ double quotient(double t, double n) {
  return (t == 0.0 && n == n && n != 0.0) ? t * copysign(1.0, n)
                                          : __ddiv_rn(t, n);
}

struct WideGeom {
  int P, nseg, m, B1, Nmax;
  int spseg;  // stages per segment
};

// Stage t of KS rows: `len` rows of segment t / spseg from grid row r0
template <int KS>
struct StageT {
  int len, r0;
  __device__ StageT(const WideGeom& g, int t) {
    const int s = t / g.spseg, k0 = (t - s * g.spseg) * KS;
    len = min(KS, g.m - k0);
    r0 = s * g.m + k0;
  }
};
using Stage = StageT<kStage>;

// One commit group of copies for stage t: the pulsar's Ta rows of the
// stage (KS rows), columns i0 .. i0 + BT - 1 into ring slot t % 2 of rA
// (row stride BT) and j0 .. into slot t % RB of rB (row stride LDB;
// columns at or beyond B1 are not copied and hold stale values, which
// reach only outputs that are never stored), and N of those rows below
// Nmax into slot t % 2 of rN.  A stage past the last commits an empty
// group.
template <typename T, int KS, int BT, int NT, int RB, int LDB>
__device__ void enqueue(const WideGeom& g, const T* __restrict__ Ta,
                        const T* __restrict__ Nb, int p, int t, int nstage,
                        int i0, int j0, T* rA, T* rB, T* rN) {
  if (t < nstage) {
    const StageT<KS> st(g, t);
    T* dA = rA + (t & 1) * KS * BT;
    T* dB = rB + (t % RB) * KS * LDB;
    T* dN = rN + (t & 1) * KS;
    const T* src =
        Ta + (static_cast<size_t>(p) * g.nseg * g.m + st.r0) * g.B1;
    const int wa = min(BT, g.B1 - i0), wb = min(BT, g.B1 - j0);
    int k = threadIdx.x / BT, c = threadIdx.x - k * BT;
    while (k < st.len) {
      const T* row = src + static_cast<size_t>(k) * g.B1;
      if (c < wa) cp_async(dA + k * BT + c, row + i0 + c);
      if (c < wb) cp_async(dB + k * LDB + c, row + j0 + c);
      c += NT % BT;
      k += NT / BT;
      if (c >= BT) {
        c -= BT;
        ++k;
      }
    }
    for (k = threadIdx.x; k < st.len; k += NT)
      if (st.r0 + k < g.Nmax) cp_async(dN + k, Nb + st.r0 + k);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The stage loop every kernel shares, one CTA barrier per stage: with
// stage t + 1's copies landed, every warp puts stage t + 2's in flight,
// forms stage t + 1 (form(t + 1), from raw slot (t + 1) % 2 into formed
// slot (t + 1) % 2) and multiplies stage t (compute(t)); segment_end()
// after the last stage of each segment.  The barrier orders each buffer's
// last read before its next write: raw A and N of stage t were read by
// form(t) in the previous step, raw B of stage t - 1 (ring of RB = 3
// when compute reads it) and formed slot (t - 1) % 2 by compute(t - 1).
template <typename T, int KS, int BT, int NT, int RB, int LDB, typename Form,
          typename Compute, typename SegmentEnd>
__device__ void stream_stages(const WideGeom& g, const T* __restrict__ Ta,
                              const T* __restrict__ Nb, int p, int i0,
                              int j0, T* rA, T* rB, T* rN, Form form,
                              Compute compute, SegmentEnd segment_end) {
  const int nstage = g.nseg * g.spseg;
  enqueue<T, KS, BT, NT, RB, LDB>(g, Ta, Nb, p, 0, nstage, i0, j0, rA, rB,
                                  rN);
  enqueue<T, KS, BT, NT, RB, LDB>(g, Ta, Nb, p, 1, nstage, i0, j0, rA, rB,
                                  rN);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  form(0);
  for (int t = 0; t < nstage; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    enqueue<T, KS, BT, NT, RB, LDB>(g, Ta, Nb, p, t + 2, nstage, i0, j0, rA,
                                    rB, rN);
    if (t + 1 < nstage) form(t + 1);
    compute(t);
    if ((t + 1) % g.spseg == 0 || t + 1 == nstage) segment_end();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Float32 products; AccT is the segment-reduce and output type.  Tile
// BT = 8 TD; thread (ty, tx) of TD x TD owns rows i0 + 4 ty + {0..3, H..
// H + 3} and columns j0 + 4 tx + {0..3, H..H + 3}, H = BT / 2.  Shared
// memory: the running sums [64][TD^2] (AccT), the raw rows of the row
// tile [2][kStage][BT] and of the column tile [3][kStage][BT], N
// [2][kStage], the quotients [2][kStage][BT].
template <typename AccT, int TD>
__global__ void __launch_bounds__(TD * TD, 1)
wide_gram_f32_kernel(const float* __restrict__ Ta,
                     const float* __restrict__ N, AccT* __restrict__ G,
                     WideGeom g, unsigned long long* __restrict__ count) {
  constexpr int BT = 8 * TD, H = 4 * TD, NT = TD * TD, SZ = kStage * BT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccT* sAcc = reinterpret_cast<AccT*>(smem_raw);
  float* rA = reinterpret_cast<float*>(sAcc + 64 * NT);
  float* rB = rA + 2 * SZ;
  float* rN = rB + 3 * SZ;
  float* sA = rN + 2 * kStage;
  const int b = blockIdx.z, p = b % g.P;
  const int i0 = blockIdx.y * BT, j0 = blockIdx.x * BT;
  const float* Nb = N + static_cast<size_t>(b) * g.Nmax;
  const int tid = threadIdx.x;
  const int ty = tid / TD, tx = tid - ty * TD;
#pragma unroll
  for (int e = 0; e < 64; ++e) sAcc[e * NT + tid] = AccT(0);
  float part[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) part[u][v] = 0.f;

  auto form = [&](int t) {
    const Stage st(g, t);
    const float* cA = rA + (t & 1) * SZ;
    const float* cN = rN + (t & 1) * kStage;
    float* dA = sA + (t & 1) * SZ;
    for (int e = tid; e < st.len * BT; e += NT) {
      const int k = e / BT;
      dA[e] = st.r0 + k < g.Nmax ? quotient(cA[e], cN[k]) : 0.f;
    }
  };
  auto compute = [&](int t) {
    const int len = Stage(g, t).len;
    const float* pa = sA + (t & 1) * SZ + 4 * ty;
    const float* pb = rB + (t % 3) * SZ + 4 * tx;
    for (int k = 0; k < len; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(pa + k * BT);
      const float4 a1 = *reinterpret_cast<const float4*>(pa + k * BT + H);
      const float4 b0 = *reinterpret_cast<const float4*>(pb + k * BT);
      const float4 b1 = *reinterpret_cast<const float4*>(pb + k * BT + H);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v)
          part[u][v] = fmaf(av[u], bv[v], part[u][v]);
    }
  };
  auto segment_end = [&]() {
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        AccT& a = sAcc[(8 * u + v) * NT + tid];
        a = a + static_cast<AccT>(part[u][v]);
        part[u][v] = 0.f;
      }
  };
  stream_stages<float, kStage, BT, NT, 3, BT>(g, Ta, Nb, p, i0, j0, rA, rB,
                                              rN, form, compute, segment_end);

  AccT* Gb = G + static_cast<size_t>(b) * g.B1 * g.B1;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = i0 + 4 * ty + (u & 3) + (u >> 2) * H;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int j = j0 + 4 * tx + (v & 3) + (v >> 2) * H;
      if (i < g.B1 && j < g.B1)
        Gb[static_cast<size_t>(i) * g.B1 + j] = sAcc[(8 * u + v) * NT + tid];
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
    atomicAdd(count, 1ull);
}

// Widening float64 form on DMMA: tile 128 x 128, warp (wr, wc) of 4 x 4
// owns rows i0 + 32 wr .. + 31 and columns j0 + 32 wc .. + 31 as 4 x 4
// MMA tiles.  A[i][k] = TNa[k][i] (lane: row lane / 4, k lane % 4),
// B[k][j] = Ta[k][j] (lane: k lane % 4, column lane / 4), C: row lane /
// 4, columns 2 (lane % 4) + {0, 1}.  A stage's rows are formed as float64
// (products of float32 values are exact in float64) up to its length
// rounded up to 4, zero past it; the row stride kDmmaLd = 132 spreads a
// fragment's four k-rows evenly over the banks.  Shared memory: the
// running sums [32][512], the formed tiles [2][kStage][132] each, the raw
// rows [2][kStage][128] of each tile, N [2][kStage].
__global__ void __launch_bounds__(kDmmaThreads, 1)
wide_gram_dmma_kernel(const float* __restrict__ Ta,
                      const float* __restrict__ N, double* __restrict__ G,
                      WideGeom g, unsigned long long* __restrict__ count) {
  constexpr int BT = kDmmaTile, LD = kDmmaLd, NT = kDmmaThreads;
  constexpr int SZ = kStage * BT, SD = kStage * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sAcc = reinterpret_cast<double*>(smem_raw);
  double* sA = sAcc + 32 * NT;
  double* sB = sA + 2 * SD;
  float* rA = reinterpret_cast<float*>(sB + 2 * SD);
  float* rB = rA + 2 * SZ;
  float* rN = rB + 2 * SZ;
  const int b = blockIdx.z, p = b % g.P;
  const int i0 = blockIdx.y * BT, j0 = blockIdx.x * BT;
  const float* Nb = N + static_cast<size_t>(b) * g.Nmax;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int e = 0; e < 32; ++e) sAcc[e * NT + tid] = 0.0;
  double part[4][4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) part[u][v][0] = part[u][v][1] = 0.0;

  auto form = [&](int t) {
    const Stage st(g, t);
    const int rows4 = (st.len + 3) & ~3;
    const float* cA = rA + (t & 1) * SZ;
    const float* cB = rB + (t & 1) * SZ;
    const float* cN = rN + (t & 1) * kStage;
    double* dA = sA + (t & 1) * SD;
    double* dB = sB + (t & 1) * SD;
    for (int e = tid; e < rows4 * BT; e += NT) {
      const int k = e / BT, c = e - k * BT;
      float a = 0.f, bb = 0.f;
      if (k < st.len) {
        bb = cB[e];
        if (st.r0 + k < g.Nmax) a = quotient(cA[e], cN[k]);
      }
      dA[k * LD + c] = static_cast<double>(a);
      dB[k * LD + c] = static_cast<double>(bb);
    }
  };
  auto compute = [&](int t) {
    const int rows4 = (Stage(g, t).len + 3) & ~3;
    const double* pa =
        sA + (t & 1) * SD + (lane & 3) * LD + 32 * wr + (lane >> 2);
    const double* pb =
        sB + (t & 1) * SD + (lane & 3) * LD + 32 * wc + (lane >> 2);
    for (int k = 0; k < rows4; k += 4) {
      double a[4], bq[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = pa[k * LD + 8 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bq[v] = pb[k * LD + 8 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) dmma(part[u][v], a[u], bq[v]);
    }
  };
  auto segment_end = [&]() {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          double& a = sAcc[((4 * u + v) * 2 + e) * NT + tid];
          a = a + part[u][v][e];
          part[u][v][e] = 0.0;
        }
  };
  stream_stages<float, kStage, BT, NT, 2, BT>(g, Ta, Nb, p, i0, j0, rA, rB,
                                              rN, form, compute, segment_end);

  double* Gb = G + static_cast<size_t>(b) * g.B1 * g.B1;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + 32 * wr + 8 * u + (lane >> 2);
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 32 * wc + 8 * v + 2 * (lane & 3) + e;
        if (i < g.B1 && j < g.B1)
          Gb[static_cast<size_t>(i) * g.B1 + j] =
              sAcc[((4 * u + v) * 2 + e) * NT + tid];
      }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
    atomicAdd(count, 1ull);
}

// Float64 form on DMMA over float64 Ta and N: tile BT = 32 W, warp (wr,
// wc) of W x W owns rows i0 + 32 wr .. + 31 and columns j0 + 32 wc .. + 31
// as 4 x 4 MMA tiles, with the widening form's fragment layout.  Stages of
// kStage64 rows; the column tile's raw rows (ring of 3, row stride LD =
// BT + 4) are the B operand as they land, and form(t) zeroes their rows
// from the stage's length up to the next multiple of 4 (never copied,
// they would otherwise hold stale values, NaN among them).  Shared
// memory: the running sums [32][NT], the quotients [2][kStage64][LD], the
// column tile's rows [3][kStage64][LD], the row tile's raw rows
// [2][kStage64][BT], N [2][kStage64].
template <int W>
__global__ void __launch_bounds__(32 * W * W, 1)
wide_gram_f64_kernel(const double* __restrict__ Ta,
                     const double* __restrict__ N, double* __restrict__ G,
                     WideGeom g, unsigned long long* __restrict__ count) {
  constexpr int BT = 32 * W, LD = BT + 4, NT = 32 * W * W, KS = kStage64;
  constexpr int SR = KS * BT, SD = KS * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sAcc = reinterpret_cast<double*>(smem_raw);
  double* sA = sAcc + 32 * NT;
  double* rB = sA + 2 * SD;
  double* rA = rB + 3 * SD;
  double* rN = rA + 2 * SR;
  const int b = blockIdx.z, p = b % g.P;
  const int i0 = blockIdx.y * BT, j0 = blockIdx.x * BT;
  const int wa = min(BT, g.B1 - i0);
  const double* Nb = N + static_cast<size_t>(b) * g.Nmax;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp / W, wc = warp - wr * W;
#pragma unroll
  for (int e = 0; e < 32; ++e) sAcc[e * NT + tid] = 0.0;
  double part[4][4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) part[u][v][0] = part[u][v][1] = 0.0;

  auto form = [&](int t) {
    const StageT<KS> st(g, t);
    const int rows4 = (st.len + 3) & ~3;
    const double* cA = rA + (t & 1) * SR;
    const double* cN = rN + (t & 1) * KS;
    double* dA = sA + (t & 1) * SD;
    double* dB = rB + (t % 3) * SD;
    for (int e = tid; e < rows4 * BT; e += NT) {
      const int k = e / BT, c = e - k * BT;
      if (k < st.len) {
        dA[k * LD + c] = c < wa && st.r0 + k < g.Nmax
                             ? quotient(cA[e], cN[k])
                             : 0.0;
      } else {
        dA[k * LD + c] = 0.0;
        dB[k * LD + c] = 0.0;
      }
    }
  };
  auto compute = [&](int t) {
    const int rows4 = (StageT<KS>(g, t).len + 3) & ~3;
    const double* pa =
        sA + (t & 1) * SD + (lane & 3) * LD + 32 * wr + (lane >> 2);
    const double* pb =
        rB + (t % 3) * SD + (lane & 3) * LD + 32 * wc + (lane >> 2);
    for (int k = 0; k < rows4; k += 4) {
      double a[4], bq[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = pa[k * LD + 8 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bq[v] = pb[k * LD + 8 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) dmma(part[u][v], a[u], bq[v]);
    }
  };
  auto segment_end = [&]() {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          double& a = sAcc[((4 * u + v) * 2 + e) * NT + tid];
          a = a + part[u][v][e];
          part[u][v][e] = 0.0;
        }
  };
  stream_stages<double, KS, BT, NT, 3, LD>(g, Ta, Nb, p, i0, j0, rA, rB, rN,
                                           form, compute, segment_end);

  double* Gb = G + static_cast<size_t>(b) * g.B1 * g.B1;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + 32 * wr + 8 * u + (lane >> 2);
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 32 * wc + 8 * v + 2 * (lane & 3) + e;
        if (i < g.B1 && j < g.B1)
          Gb[static_cast<size_t>(i) * g.B1 + j] =
              sAcc[((4 * u + v) * 2 + e) * NT + tid];
      }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
    atomicAdd(count, 1ull);
}

constexpr size_t f32_smem(int td, size_t acc_bytes) {
  return 64 * static_cast<size_t>(td) * td * acc_bytes +
         (7 * kStage * 8 * static_cast<size_t>(td) + 2 * kStage) *
             sizeof(float);
}
constexpr size_t kDmmaSmem =
    (32 * static_cast<size_t>(kDmmaThreads) + 4 * kStage * kDmmaLd) *
        sizeof(double) +
    (4 * kStage * kDmmaTile + 2 * kStage) * sizeof(float);
// the float64 form at W x W warps
constexpr size_t f64_smem(int w) {
  return (32 * 32 * static_cast<size_t>(w) * w +
          5 * kStage64 * (32 * static_cast<size_t>(w) + 4) +
          2 * kStage64 * 32 * static_cast<size_t>(w) + 2 * kStage64) *
         sizeof(double);
}

// Launch `kernel` (tile bt, threads per CTA, dynamic shared memory smem),
// raising its shared-memory limit on the current device at the first
// launch there (`done` is the kernel's own record).
template <typename InT, typename OutT>
cudaError_t launch(void (*kernel)(const InT*, const InT*, OutT*, WideGeom,
                                  unsigned long long*),
                   int* done, int bt, int threads, size_t smem,
                   const WideGeom& g, int batch, const void* Ta,
                   const void* N, void* G, unsigned long long* count,
                   cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) done[dev] = 1;
  }
  const int tiles = (g.B1 + bt - 1) / bt;
  kernel<<<dim3(tiles, tiles, batch), threads, smem, stream>>>(
      static_cast<const InT*>(Ta), static_cast<const InT*>(N),
      static_cast<OutT*>(G), g, count);
  return cudaGetLastError();
}

int done_f32[kMaxDevices], done_f64acc[kMaxDevices], done_dmma[kMaxDevices],
    done_f64w2[kMaxDevices], done_f64w4[kMaxDevices];

}  // namespace

int ptg_gram_wide_config(int form, int batch, int B1, int* tile,
                         int* threads, size_t* smem) {
  switch (form) {
    case 0:
      *tile = 8 * kF32TD;
      *threads = kF32TD * kF32TD;
      *smem = f32_smem(kF32TD, sizeof(float));
      return 0;
    case 1:
      *tile = 8 * kF64AccTD;
      *threads = kF64AccTD * kF64AccTD;
      *smem = f32_smem(kF64AccTD, sizeof(double));
      return 0;
    case 2:
      *tile = kDmmaTile;
      *threads = kDmmaThreads;
      *smem = kDmmaSmem;
      return 0;
    case 3: {
      // 128 x 128 where that grid holds a CTA per SM, else 64 x 64
      int dev = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      const long t128 = (B1 + 127) / 128;
      const int w = t128 * t128 * batch >= sms ? 4 : 2;
      *tile = 32 * w;
      *threads = 32 * w * w;
      *smem = f64_smem(w);
      return 0;
    }
    default:
      return -1;
  }
}

cudaError_t ptg_launch_gram_accumulate_wide(
    const void* Ta, const void* N, void* G, int* extent, int batch, int P,
    int nseg, int m, int B1, int Nmax, int form, unsigned long long* count,
    cudaStream_t stream) {
  (void)extent;  // every row is multiplied: no extent scan
  if (batch == 0) return cudaSuccess;
  int tile = 0, threads = 0;
  size_t smem = 0;
  const int code = ptg_gram_wide_config(form, batch, B1, &tile, &threads,
                                        &smem);
  if (code != 0)
    return code < 0 ? cudaErrorInvalidValue : static_cast<cudaError_t>(code);
  const int ks = form == 3 ? kStage64 : kStage;
  const WideGeom g{P, nseg, m, B1, Nmax, (m + ks - 1) / ks};
  switch (form) {
    case 0:
      return launch(wide_gram_f32_kernel<float, kF32TD>, done_f32, tile,
                    threads, smem, g, batch, Ta, N, G, count, stream);
    case 1:
      return launch(wide_gram_f32_kernel<double, kF64AccTD>, done_f64acc,
                    tile, threads, smem, g, batch, Ta, N, G, count, stream);
    case 2:
      return launch(wide_gram_dmma_kernel, done_dmma, tile, threads, smem, g,
                    batch, Ta, N, G, count, stream);
    default:
      return tile == 128
                 ? launch(wide_gram_f64_kernel<4>, done_f64w4, tile, threads,
                          smem, g, batch, Ta, N, G, count, stream)
                 : launch(wide_gram_f64_kernel<2>, done_f64w2, tile, threads,
                          smem, g, batch, Ta, N, G, count, stream);
  }
}
