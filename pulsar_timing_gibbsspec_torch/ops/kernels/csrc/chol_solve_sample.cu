// Fused Jacobi-preconditioned Cholesky -> explicit inverse -> mean and
// sample solves of the steady b-draw proposal, one CTA per matrix.
//
// Replaces pulsar_timing_gibbsspec_tpu/ops/kernels/pallas_tpu.py::
// chol_solve_sample_pallas (the five outputs of
// ops/linalg.jacobi_factor_mean_prop): for each (chain, pulsar) system
//
//   dj = 1/sqrt(diag Sig),  A = D Sig D + ridge I,
//   (L, Li) = blocked_chol_inv(A),
//   mean = dj * Li^T (Li (dj * d)),  bp = mean + dj * Li^T z.
//
// What bounds it on Hopper: at the main path's shape (C*P = 2880 systems of
// order 37) the bytes are ~35 MB (Sig in, L and Li out) against ~0.2
// GFLOP, so the bound is memory; the work per matrix is a chain of small
// dependent products, so the kernel is latency-bound in practice.  The
// design keeps the whole system (A, L, Li and one scratch tile, 4*n*n
// elements: 22 KB at n=37 in float32) in shared memory so every
// intermediate of the chain stays on chip and each input and output
// crosses device memory exactly once.  The factorization follows the
// blocked recursion of ops/linalg._cholinv_rec (halve, closed-form 1x1 /
// 2x2 leaves, products for the off-diagonal blocks and the Schur
// complement), each product summed in index order with fused
// multiply-adds; the threads of the CTA share each product's entries.
#include "kernels.h"

namespace {

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double dfma(double a, double b, double c) {
  return fma(a, b, c);
}

// (L, Li) of the diagonal block A[off:off+n, off:off+n] (row stride ld),
// written into the same block of L and Li.  Every thread of the CTA calls
// it with the same (off, n), so the recursion and its barriers are
// uniform.  The Schur complement overwrites the lower triangle of A22,
// which no later step reads; W is a scratch tile used between the two
// recursive calls of one level only.
template <typename T>
__device__ void cholinv(T* A, T* L, T* Li, T* W, int ld, int off, int n) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (n <= 2) {
    if (tid == 0) {
      const int o = off * ld + off;
      if (n == 1) {
        const T l = dsqrt(A[o]);
        L[o] = l;
        Li[o] = T(1) / l;
      } else {
        const T a = dsqrt(A[o]);
        const T b = A[o + ld] / a;
        const T c = dsqrt(A[o + ld + 1] - b * b);
        const T ia = T(1) / a;
        const T ic = T(1) / c;
        L[o] = a;
        L[o + ld] = b;
        L[o + ld + 1] = c;
        Li[o] = ia;
        Li[o + ld] = -b * ia * ic;
        Li[o + ld + 1] = ic;
      }
    }
    __syncthreads();
    return;
  }
  const int h = n / 2;
  const int m = n - h;
  const int r0 = off + h;  // first row of the lower blocks
  cholinv(A, L, Li, W, ld, off, h);
  // L21 = A21 I11^T  (m x h); I11 is lower, so k runs to j
  for (int e = tid; e < m * h; e += nt) {
    const int i = e / h, j = e % h;
    T acc = T(0);
    for (int k = 0; k <= j; ++k)
      acc = dfma(A[(r0 + i) * ld + off + k], Li[(off + j) * ld + off + k],
                 acc);
    L[(r0 + i) * ld + off + j] = acc;
  }
  __syncthreads();
  // S = A22 - L21 L21^T, lower triangle, in place
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e % m;
    if (j > i) continue;
    T acc = T(0);
    for (int k = 0; k < h; ++k)
      acc = dfma(L[(r0 + i) * ld + off + k], L[(r0 + j) * ld + off + k],
                 acc);
    A[(r0 + i) * ld + r0 + j] = A[(r0 + i) * ld + r0 + j] - acc;
  }
  __syncthreads();
  cholinv(A, L, Li, W, ld, r0, m);
  // W = L21 I11  (m x h); I11[k][j] is zero for k < j
  for (int e = tid; e < m * h; e += nt) {
    const int i = e / h, j = e % h;
    T acc = T(0);
    for (int k = j; k < h; ++k)
      acc = dfma(L[(r0 + i) * ld + off + k], Li[(off + k) * ld + off + j],
                 acc);
    W[i * ld + j] = acc;
  }
  __syncthreads();
  // I21 = -(I22 W); I22[i][k] is zero for k > i
  for (int e = tid; e < m * h; e += nt) {
    const int i = e / h, j = e % h;
    T acc = T(0);
    for (int k = 0; k <= i; ++k)
      acc = dfma(Li[(r0 + i) * ld + r0 + k], W[k * ld + j], acc);
    Li[(r0 + i) * ld + off + j] = -acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void chol_solve_sample_kernel(
    const T* __restrict__ Sig, const T* __restrict__ d,
    const T* __restrict__ z, T* __restrict__ Lout, T* __restrict__ Liout,
    T* __restrict__ djout, T* __restrict__ mout, T* __restrict__ bpout,
    int n, T ridge) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  T* L = A + n * n;
  T* Li = L + n * n;
  T* W = Li + n * n;
  T* dj = W + n * n;
  T* v = dj + n;
  T* w = v + n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t mo = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t vo = static_cast<size_t>(blockIdx.x) * n;

  for (int i = tid; i < n; i += nt) dj[i] = T(1) / dsqrt(Sig[mo + i * n + i]);
  __syncthreads();
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e % n;
    T a = Sig[mo + e] * dj[i] * dj[j];
    if (i == j) a = a + ridge;
    A[e] = a;
    L[e] = T(0);
    Li[e] = T(0);
  }
  for (int i = tid; i < n; i += nt) v[i] = dj[i] * d[vo + i];
  __syncthreads();

  cholinv(A, L, Li, W, n, 0, n);

  // w = Li (dj * d)
  for (int i = tid; i < n; i += nt) {
    T acc = T(0);
    for (int j = 0; j <= i; ++j) acc = dfma(Li[i * n + j], v[j], acc);
    w[i] = acc;
  }
  __syncthreads();
  // [mean | sample] = dj * Li^T [w | z]
  for (int i = tid; i < n; i += nt) {
    T a0 = T(0), a1 = T(0);
    for (int j = i; j < n; ++j) {
      const T lji = Li[j * n + i];
      a0 = dfma(lji, w[j], a0);
      a1 = dfma(lji, z[vo + j], a1);
    }
    const T mean = dj[i] * a0;
    mout[vo + i] = mean;
    bpout[vo + i] = mean + dj[i] * a1;
    djout[vo + i] = dj[i];
  }
  for (int e = tid; e < n * n; e += nt) {
    Lout[mo + e] = L[e];
    Liout[mo + e] = Li[e];
  }
}

template <typename T>
cudaError_t launch(const T* Sig, const T* d, const T* z, T* L, T* Li, T* dj,
                   T* mean, T* bp, int batch, int n, T ridge,
                   cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  const size_t smem = (4 * static_cast<size_t>(n) * n + 3 * n) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_sample_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chol_solve_sample_kernel<T><<<batch, 128, smem, stream>>>(
      Sig, d, z, L, Li, dj, mean, bp, n, ridge);
  return cudaGetLastError();
}

}  // namespace

cudaError_t ptg_launch_chol_solve_sample_f32(
    const float* Sig, const float* d, const float* z, float* L, float* Li,
    float* dj, float* mean, float* bp, int batch, int n, float ridge,
    cudaStream_t stream) {
  return launch<float>(Sig, d, z, L, Li, dj, mean, bp, batch, n, ridge,
                       stream);
}

cudaError_t ptg_launch_chol_solve_sample_f64(
    const double* Sig, const double* d, const double* z, double* L,
    double* Li, double* dj, double* mean, double* bp, int batch, int n,
    double ridge, cudaStream_t stream) {
  return launch<double>(Sig, d, z, L, Li, dj, mean, bp, batch, n, ridge,
                        stream);
}
