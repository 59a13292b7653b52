// Fused Jacobi-preconditioned Cholesky -> explicit inverse -> mean and
// sample solves of the steady b-draw proposal: one warp per system,
// several systems per CTA.
//
// Replaces pulsar_timing_gibbsspec_tpu/ops/kernels/pallas_tpu.py::
// chol_solve_sample_pallas (the five outputs of
// ops/linalg.jacobi_factor_mean_prop): for each (chain, pulsar) system
//
//   dj = 1/sqrt(diag Sig),  A = D Sig D + ridge I,
//   (L, Li) = chol(A), inv(chol(A)),
//   mean = dj * Li^T (Li (dj * d)),  bp = mean + dj * Li^T z.
//
// What bounds it on Hopper: at the main path's shape (C*P = 2880 systems
// of order 37) the bytes (Sig in, L and Li out: ~35 MB) bound it at
// ~0.015 ms, against ~0.2 GFLOP; but each system is a chain of small
// dependent steps, so a CTA-wide design is latency-bound (one CTA of 128
// threads per system spent ~90 barriers per matrix, with single-thread
// leaves and products of a few entries each), and a warp-wide one is bound
// by the instructions and shared-memory reads of its dot products.
//
// The design: one warp owns one system, and nothing but __syncwarp and
// shuffles orders its steps (no __syncthreads anywhere, so a ragged last
// CTA simply retires its missing warps).  The factorization is unblocked:
//   - left-looking Cholesky, one column at a time: the lanes own the
//     rows i >= j of column j and take the dot products of row i and row
//     j of L together; the pivot comes from lane 0 by shuffle;
//   - L^-1 row by row (forward substitution): the lanes own the columns;
//   - w = Li (dj * d) with the lanes owning the rows, then the two-column
//     product Li^T [w | z] with the lanes owning the rows again; the
//     vectors stay in registers and reach the other lanes by shuffle.
// Each system lives in one n x ld buffer of shared memory: L in the lower
// triangle, L^-1 transposed in the upper part shifted by W columns
// (Li[i][c] at M[c][i + W], W = 16 bytes / element size).  Every dot
// product walks rows in 16-byte vectors, and ld (>= n + W, an odd multiple
// of W) puts the eight rows read by a quarter-warp on disjoint banks.  At
// n = 37 in float32 that is 6.5 KB per system, so the whole batch is
// resident in about one wave.  The lower triangle of Sig is copied into
// the buffer with cp.async (every row in flight at once), d and z are read
// once, and all five outputs are written once, row by row with consecutive
// lanes on consecutive addresses.  Any n up to kCholMaxN = 96 is taken: a
// lane owns up to R = ceil(n / 32) rows or columns.
#include "kernels.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// systems per CTA, lowered for large systems so a CTA stays within
// kCholSmemBudget bytes of shared memory
constexpr int kSystemsPerCta = 4;
constexpr int kCholSmemBudget = 96 * 1024;

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double dfma(double a, double b, double c) {
  return fma(a, b, c);
}

// v[idx] for a register array indexed by a warp-uniform runtime value
template <int R, typename T>
__device__ __forceinline__ T pick(const T (&v)[R], int idx) {
  T out = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (idx == r) out = v[r];
  return out;
}

// 16-byte vectors of the element type
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int W = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int W = 2;
};

// out = p[0 .. W - 1], one 16-byte shared-memory read (p 16-byte aligned)
template <typename T>
__device__ __forceinline__ void ldv(const T* p, T (&out)[Vec<T>::W]) {
  const auto v = *reinterpret_cast<const typename Vec<T>::type*>(p);
  if constexpr (Vec<T>::W == 4) {
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    out[0] = v.x;
    out[1] = v.y;
  }
}

// Asynchronous copy of one element from device to shared memory
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(T))
               : "memory");
}

// Value of row/column j, held by lane j % 32 in slot j / 32, on every lane
template <int R, typename T>
__device__ __forceinline__ T bcast(const T (&v)[R], int j) {
  return __shfl_sync(kFull, pick<R>(v, j >> 5), j & 31);
}

template <typename T, int R>
__global__ void __launch_bounds__(32 * kSystemsPerCta)
chol_solve_sample_kernel(const T* __restrict__ Sig, const T* __restrict__ d,
                         const T* __restrict__ z, T* __restrict__ Lout,
                         T* __restrict__ Liout, T* __restrict__ djout,
                         T* __restrict__ mout, T* __restrict__ bpout,
                         int batch, int n, int ld, T ridge,
                         unsigned long long* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(count, 1ull);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sys = blockIdx.x * (blockDim.x >> 5) + warp;
  if (sys >= batch) return;  // ragged last CTA: no CTA barrier follows
  constexpr int W = Vec<T>::W;
  T* M = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * n * ld;
  const size_t mo = static_cast<size_t>(sys) * n * n;
  const size_t vo = static_cast<size_t>(sys) * n;

  // ---- load: the lower triangle of Sig, row by row, straight into M with
  // cp.async (all rows in flight at once); d and z for the lane's rows
  for (int i = 0; i < n; ++i)
    for (int j = lane; j <= i; j += 32)
      cp_async(M + i * ld + j, Sig + mo + static_cast<size_t>(i) * n + j);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  T dj[R], v[R], zr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    v[r] = i < n ? d[vo + i] : T(0);
    zr[r] = i < n ? z[vo + i] : T(0);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  // dj = 1/sqrt(diag Sig), v = dj * d for the lane's rows i = lane + 32 r
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    dj[r] = i < n ? T(1) / dsqrt(M[i * ld + i]) : T(0);
    v[r] = dj[r] * v[r];
  }
  __syncwarp();
  // A = (Sig * dj_i) * dj_j (+ ridge on the diagonal), in place
  for (int i = 0; i < n; ++i) {
    const T dji = bcast<R>(dj, i);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = lane + 32 * r;
      if (j <= i) {
        T a = M[i * ld + j] * dji * dj[r];
        if (j == i) a = a + ridge;
        M[i * ld + j] = a;
      }
    }
  }
  __syncwarp();

  // ---- left-looking Cholesky: column j from rows j.. of A and L[:, :j]
  for (int j = 0; j < n; ++j) {
    T s[R];
    const T* Mj = M + j * ld;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = T(0);
      if (j + 32 * r < n) {  // warp-uniform
        const int i = j + lane + 32 * r;
        if (i < n) {
          const T* Mi = M + i * ld;
          T acc = T(0);
          int k = 0;
          for (; k + W <= j; k += W) {
            T a[W], b[W];
            ldv(Mi + k, a);
            ldv(Mj + k, b);
#pragma unroll
            for (int e = 0; e < W; ++e) acc = dfma(a[e], b[e], acc);
          }
          for (; k < j; ++k) acc = dfma(Mi[k], Mj[k], acc);
          s[r] = Mi[j] - acc;
        }
      }
    }
    const T piv = dsqrt(__shfl_sync(kFull, s[0], 0));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = j + lane + 32 * r;
      if (i < n) M[i * ld + j] = (i == j) ? piv : s[r] / piv;
    }
    __syncwarp();
  }

  // ---- Li = L^-1 by rows; lane owns columns c = lane + 32 r, and
  // Li[k][c] is Mc[k] = M[c][k + W].  Each lane reads only L and the
  // entries of its own columns, so no barrier is needed inside the loop.
  for (int i = 0; i < n; ++i) {
    const T* Mi = M + i * ld;
    const T lii = Mi[i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      if (32 * r <= i) {  // warp-uniform: some column of the slot is <= i
        T* Mc = M + min(c, n - 1) * ld + W;
        T acc = T(0);
        int k = 32 * r;
        for (; k + W <= i; k += W) {
          T a[W], b[W];
          ldv(Mi + k, a);
          ldv(Mc + k, b);
#pragma unroll
          for (int e = 0; e < W; ++e)
            if (k + e >= c) acc = dfma(a[e], b[e], acc);
        }
        for (; k < i; ++k)
          if (k >= c) acc = dfma(Mi[k], Mc[k], acc);
        if (c == i)
          Mc[i] = T(1) / lii;
        else if (c < i)
          Mc[i] = -acc / lii;
      }
    }
  }
  __syncwarp();

  // ---- w = Li v (lane owns rows i; Li[i][j] = M[j][i + W])
  T w[R];
#pragma unroll
  for (int r = 0; r < R; ++r) w[r] = T(0);
#pragma unroll
  for (int jb = 0; jb < R; ++jb) {
    const int jend = min(32, n - 32 * jb);
    for (int jj = 0; jj < jend; ++jj) {
      const int j = 32 * jb + jj;
      const T vj = __shfl_sync(kFull, v[jb], jj);
      const T* Mj = M + j * ld + W;
#pragma unroll
      for (int r = jb; r < R; ++r) {
        const int i = lane + 32 * r;
        if (i >= j && i < n) w[r] = dfma(Mj[i], vj, w[r]);
      }
    }
  }
  // ---- [mean | sample] = dj * Li^T [w | z] (Li[j][i] = M[i][j + W]),
  // lane i walking its row of M in vectors
  T a0[R], a1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a0[r] = a1[r] = T(0);
#pragma unroll
  for (int jb = 0; jb < R; ++jb) {
    const int jend = min(32, n - 32 * jb);
    for (int jj = 0; jj < jend; jj += W) {
      const int j = 32 * jb + jj;
      T wj[W], zj[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        wj[e] = __shfl_sync(kFull, w[jb], (jj + e) & 31);
        zj[e] = __shfl_sync(kFull, zr[jb], (jj + e) & 31);
      }
#pragma unroll
      for (int r = 0; r <= jb; ++r) {
        const int i = lane + 32 * r;
        T l[W];
        ldv(M + min(i, n - 1) * ld + j + W, l);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          if (i <= j + e && j + e < n) {
            a0[r] = dfma(l[e], wj[e], a0[r]);
            a1[r] = dfma(l[e], zj[e], a1[r]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < n) {
      const T mean = dj[r] * a0[r];
      mout[vo + i] = mean;
      bpout[vo + i] = mean + dj[r] * a1[r];
      djout[vo + i] = dj[r];
    }
  }

  // ---- L and Li out, row by row (zeros above the diagonal)
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = lane + 32 * r;
      if (j < n) {
        const size_t o = mo + static_cast<size_t>(i) * n + j;
        Lout[o] = j <= i ? M[i * ld + j] : T(0);
        Liout[o] = j <= i ? M[j * ld + i + W] : T(0);
      }
    }
  }
}

template <typename T, int R>
cudaError_t launch_r(const T* Sig, const T* d, const T* z, T* L, T* Li,
                     T* dj, T* mean, T* bp, int batch, int n, T ridge,
                     unsigned long long* count, cudaStream_t stream) {
  // row stride: at least n + W, an odd multiple of W
  constexpr int W = Vec<T>::W;
  const int ld = ((n + W + W - 1) / W | 1) * W;
  const size_t per_sys = static_cast<size_t>(n) * ld * sizeof(T);
  int spc = static_cast<int>(kCholSmemBudget / per_sys);
  spc = spc < 1 ? 1 : (spc > kSystemsPerCta ? kSystemsPerCta : spc);
  const size_t smem = spc * per_sys;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_sample_kernel<T, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (batch + spc - 1) / spc;
  chol_solve_sample_kernel<T, R><<<grid, 32 * spc, smem, stream>>>(
      Sig, d, z, L, Li, dj, mean, bp, batch, n, ld, ridge, count);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* Sig, const T* d, const T* z, T* L, T* Li, T* dj,
                   T* mean, T* bp, int batch, int n, T ridge,
                   unsigned long long* count, cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  switch ((n + 31) / 32) {
    case 1:
      return launch_r<T, 1>(Sig, d, z, L, Li, dj, mean, bp, batch, n, ridge,
                            count, stream);
    case 2:
      return launch_r<T, 2>(Sig, d, z, L, Li, dj, mean, bp, batch, n, ridge,
                            count, stream);
    case 3:
      return launch_r<T, 3>(Sig, d, z, L, Li, dj, mean, bp, batch, n, ridge,
                            count, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t ptg_launch_chol_solve_sample_f32(
    const float* Sig, const float* d, const float* z, float* L, float* Li,
    float* dj, float* mean, float* bp, int batch, int n, float ridge,
    unsigned long long* count, cudaStream_t stream) {
  return launch<float>(Sig, d, z, L, Li, dj, mean, bp, batch, n, ridge, count,
                       stream);
}

cudaError_t ptg_launch_chol_solve_sample_f64(
    const double* Sig, const double* d, const double* z, double* L,
    double* Li, double* dj, double* mean, double* bp, int batch, int n,
    double ridge, unsigned long long* count, cudaStream_t stream) {
  return launch<double>(Sig, d, z, L, Li, dj, mean, bp, batch, n, ridge,
                        count, stream);
}
