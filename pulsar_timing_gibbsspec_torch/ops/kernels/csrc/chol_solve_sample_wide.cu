// Wide form of the fused Jacobi-preconditioned Cholesky -> explicit
// inverse -> mean and sample solves, for systems too large for one
// warp's shared memory (kCholMaxN < n <= kCholWideMaxN).
//
// Replaces pulsar_timing_gibbsspec_tpu/ops/kernels/pallas_tpu.py::
// chol_solve_sample_pallas at the single-pulsar path's shape (8 systems
// of order 673 with basis ECORR): the same five outputs as the narrow
// form and ops/linalg.jacobi_factor_mean_prop,
//
//   dj = 1/sqrt(diag Sig),  A = D Sig D + ridge I,
//   (L, Li) = chol(A), inv(chol(A)),
//   mean = dj * Li^T (Li (dj * d)),  bp = mean + dj * Li^T z.
//
// What bounds it on Hopper: at n = 673 a system is 1.8 MB in float32,
// eight times a CTA's shared memory, so it cannot stay on chip as the
// narrow form's does (or as the Pallas kernel's stays in a TPU core's
// VMEM).  Per system the work is ~n^3/3 multiply-adds of the factor plus
// ~n^3/6 of the inverse (0.2 GFLOP at n = 673), against 5.4 MB of Sig in
// and L, Li out: at 8 systems ~0.024 ms by operations and ~0.013 ms by
// bytes.  The chain of dependent steps, not either rate, is what a simple
// design pays for.
//
// The design: the matrix lives in device memory (the L output is the
// working matrix; 8 systems are 14.5 MB, which the 50 MB L2 holds), and
// every step is a launch on the caller's stream (a CUDA graph captures
// them all), each spreading one system's work over many CTAs:
//   1. prep: dj and the lower triangle of A (zeros above the diagonal);
//   2. per panel of kPanel = 32 columns, right-looking:
//      a. the panel's diagonal block factored in shared memory, one CTA
//         per system (L11);
//      b. the rows below it solved against L11, 32 rows per CTA (L21 =
//         A21 L11^-T);
//      c. trailing update A22 -= L21 L21^T of the lower triangle, in 64 x
//         64 tiles, one CTA per tile and system;
//   3. inverse: Li = L^-1 by blocked forward substitution, one CTA per
//      (32-column block, system); a column block's finished row blocks
//      stay in the Li output (read back from L2), each new row block is
//      a product over them followed by a 32 x 32 triangular solve;
//   4. w = Li (dj d), a warp per row; then mean and bp from Li^T [w | z],
//      a thread per column (coalesced rows of Li).
// Every CTA uses at most 34 KB of static shared memory.  n = 673 takes 68
// launches; the last adds one to the form's device counter.
#include "kernels.h"

namespace {

constexpr int kPanel = 32;    // panel width and row/column block
constexpr int kTile = 64;     // trailing-update tile
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// dj = 1/sqrt(diag Sig) and L = lower triangle of (Sig dj_i) dj_j (+ ridge
// on the diagonal), zeros above it.  Grid (row blocks of 32, systems).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_chol_prep_kernel(const T* __restrict__ Sig, T* __restrict__ L,
                      T* __restrict__ djout, int n, T ridge) {
  __shared__ T sdj[kCholWideMaxN];
  const size_t mo = static_cast<size_t>(blockIdx.y) * n * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    sdj[j] = T(1) / dsqrt(Sig[mo + static_cast<size_t>(j) * n + j]);
  __syncthreads();
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      djout[static_cast<size_t>(blockIdx.y) * n + j] = sdj[j];
  const int i0 = blockIdx.x * kPanel;
  const int rows = min(kPanel, n - i0);
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int i = i0 + e / n, j = e % n;
    const size_t o = mo + static_cast<size_t>(i) * n + j;
    T a = T(0);
    if (j <= i) {
      a = Sig[o] * sdj[i] * sdj[j];
      if (j == i) a = a + ridge;
    }
    L[o] = a;
  }
}

// Panel k0, diagonal block: factor A[k0:k0+nb, k0:k0+nb] in shared
// memory (unblocked, right-looking) and write L11 in its place.  Grid (1,
// systems).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_chol_diag_kernel(T* __restrict__ L, int n, int k0) {
  __shared__ T sD[kPanel][kPanel + 1];
  const int nb = min(kPanel, n - k0);
  T* M = L + static_cast<size_t>(blockIdx.y) * n * n;
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    sD[r][c] = c <= r ? M[static_cast<size_t>(k0 + r) * n + k0 + c] : T(0);
  }
  __syncthreads();
  // unblocked right-looking Cholesky of the block
  for (int j = 0; j < nb; ++j) {
    if (threadIdx.x == 0) sD[j][j] = dsqrt(sD[j][j]);
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < nb; i += blockDim.x)
      sD[i][j] = sD[i][j] / sD[j][j];
    __syncthreads();
    const int m = nb - j - 1;
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int i = j + 1 + e / m, c = j + 1 + e % m;
      if (c <= i) sD[i][c] = sD[i][c] - sD[i][j] * sD[c][j];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    if (c <= r) M[static_cast<size_t>(k0 + r) * n + k0 + c] = sD[r][c];
  }
}

// Panel k0, rows below the diagonal block: CTA x solves rows k0 + 32 (x +
// 1) .. against L11 (written by the diagonal launch), L21 = A21 L11^-T.
// Grid (row blocks below, systems).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_chol_panel_kernel(T* __restrict__ L, int n, int k0) {
  __shared__ T sD[kPanel][kPanel + 1];
  __shared__ T sR[kPanel][kPanel + 1];
  const int nb = kPanel;  // rows below exist only under a full block
  T* M = L + static_cast<size_t>(blockIdx.y) * n * n;
  const int i0 = k0 + (blockIdx.x + 1) * kPanel;
  const int rows = min(kPanel, n - i0);
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    sD[r][c] = c <= r ? M[static_cast<size_t>(k0 + r) * n + k0 + c] : T(0);
  }
  for (int e = threadIdx.x; e < rows * nb; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    sR[r][c] = M[static_cast<size_t>(i0 + r) * n + k0 + c];
  }
  __syncthreads();
  // row r: x_c = (a_c - sum_{c' < c} x_c' L11[c][c']) / L11[c][c]
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    for (int c = 0; c < nb; ++c) {
      T s = sR[r][c];
      for (int cc = 0; cc < c; ++cc) s = s - sR[r][cc] * sD[c][cc];
      sR[r][c] = s / sD[c][c];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * nb; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    M[static_cast<size_t>(i0 + r) * n + k0 + c] = sR[r][c];
  }
}

// Trailing update after panel k0 (width nb): A[i][j] -= sum_c L[i][k0+c]
// L[j][k0+c] for s0 <= j <= i < n, s0 = k0 + nb, in 64 x 64 tiles of the
// lower triangle; thread (ty, tx) of 16 x 16 owns a 4 x 4 block.  Grid
// (tiles, systems).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_chol_trailing_kernel(T* __restrict__ L, int n, int k0, int nb) {
  __shared__ T sI[kTile][kPanel + 1];
  __shared__ T sJ[kTile][kPanel + 1];
  const int s0 = k0 + nb;
  // tile t -> (ti, tj), tj <= ti, row-major over the lower triangle
  int ti = static_cast<int>((sqrtf(8.f * blockIdx.x + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ti;
  while (ti * (ti + 1) / 2 > static_cast<int>(blockIdx.x)) --ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int i0 = s0 + ti * kTile, j0 = s0 + tj * kTile;
  T* M = L + static_cast<size_t>(blockIdx.y) * n * n;
  for (int e = threadIdx.x; e < kTile * nb; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    sI[r][c] = i0 + r < n ? M[static_cast<size_t>(i0 + r) * n + k0 + c]
                          : T(0);
    sJ[r][c] = j0 + r < n ? M[static_cast<size_t>(j0 + r) * n + k0 + c]
                          : T(0);
  }
  __syncthreads();
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  T acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
  for (int c = 0; c < nb; ++c) {
    T a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = sI[4 * ty + u][c];
      b[u] = sJ[4 * tx + u][c];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = acc[u][v] + a[u] * b[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + 4 * ty + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + 4 * tx + v;
      if (i < n && j <= i) {
        const size_t o = static_cast<size_t>(i) * n + j;
        M[o] = M[o] - acc[u][v];
      }
    }
  }
}

// Li = L^-1, column block J (columns j0 .. j0 + nj - 1) per CTA: rows
// above j0 are zero; each row block I >= J is B = [I == J] - sum_{J <= K
// < I} L_IK X_KJ (X_KJ: this CTA's earlier row blocks, read back from
// Li), then X_IJ = L_II^-1 B by forward substitution.  Thread e owns row
// e / 8 and columns 4 (e % 8) .. of the product.  Grid (column blocks,
// systems).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_chol_inverse_kernel(const T* __restrict__ L, T* __restrict__ Li,
                         int n) {
  __shared__ T sL[kPanel][kPanel + 1];
  __shared__ T sX[kPanel][kPanel + 1];
  __shared__ T sB[kPanel][kPanel + 1];
  const size_t mo = static_cast<size_t>(blockIdx.y) * n * n;
  const T* Lm = L + mo;
  T* X = Li + mo;
  const int j0 = blockIdx.x * kPanel;
  const int nj = min(kPanel, n - j0);
  for (int e = threadIdx.x; e < j0 * nj; e += blockDim.x)
    X[static_cast<size_t>(e / nj) * n + j0 + e % nj] = T(0);
  const int nblk = (n + kPanel - 1) / kPanel;
  const int r = threadIdx.x / 8, c4 = 4 * (threadIdx.x % 8);
  for (int I = blockIdx.x; I < nblk; ++I) {
    const int i0 = I * kPanel;
    const int ni = min(kPanel, n - i0);
    T acc[4];
#pragma unroll
    for (int v = 0; v < 4; ++v)
      acc[v] = (I == static_cast<int>(blockIdx.x) && r == c4 + v) ? T(1)
                                                                  : T(0);
    for (int K = blockIdx.x; K < I; ++K) {
      const int k0 = K * kPanel;  // a full block: K < I
      __syncthreads();
      for (int e = threadIdx.x; e < kPanel * kPanel; e += blockDim.x) {
        const int a = e / kPanel, b = e % kPanel;
        sL[a][b] = a < ni ? Lm[static_cast<size_t>(i0 + a) * n + k0 + b]
                          : T(0);
        sX[a][b] = b < nj ? X[static_cast<size_t>(k0 + a) * n + j0 + b]
                          : T(0);
      }
      __syncthreads();
      for (int kk = 0; kk < kPanel; ++kk) {
        const T a = sL[r][kk];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] = acc[v] - a * sX[kk][c4 + v];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kPanel * kPanel; e += blockDim.x) {
      const int a = e / kPanel, b = e % kPanel;
      sL[a][b] = (a < ni && b <= a)
                     ? Lm[static_cast<size_t>(i0 + a) * n + i0 + b]
                     : T(0);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) sB[r][c4 + v] = acc[v];
    __syncthreads();
    // forward substitution L_II Y = B, one thread per column
    if (threadIdx.x < nj) {
      const int c = threadIdx.x;
      for (int a = 0; a < ni; ++a) {
        T s = sB[a][c];
        for (int b = 0; b < a; ++b) s = s - sL[a][b] * sB[b][c];
        sB[a][c] = s / sL[a][a];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ni * nj; e += blockDim.x) {
      const int a = e / nj, b = e % nj;
      X[static_cast<size_t>(i0 + a) * n + j0 + b] = sB[a][b];
    }
    // the row block's writes are read back by this CTA's next products:
    // the __syncthreads at the top of the next product orders them
  }
}

// w = Li (dj * d), one warp per row (lanes stride the row).  Grid (rows /
// 8, systems).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_chol_w_kernel(const T* __restrict__ Li, const T* __restrict__ dj,
                   const T* __restrict__ d, T* __restrict__ w, int n) {
  const int i = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const size_t vo = static_cast<size_t>(blockIdx.y) * n;
  const T* row = Li + (vo + i) * n;
  T s = T(0);
  for (int j = lane; j <= i; j += 32)
    s = s + row[j] * (dj[vo + j] * d[vo + j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = s + __shfl_xor_sync(kFull, s, off);
  if (lane == 0) w[vo + i] = s;
}

// [mean | bp]: a0 = (Li^T w)_j, a1 = (Li^T z)_j, one thread per column j;
// mean = dj a0, bp = mean + dj a1.  Thread 0 of the first CTA counts the
// form's run.  Grid (columns / 256, systems).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_chol_out_kernel(const T* __restrict__ Li, const T* __restrict__ dj,
                     const T* __restrict__ w, const T* __restrict__ z,
                     T* __restrict__ mout, T* __restrict__ bpout, int n,
                     unsigned long long* __restrict__ count) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const size_t vo = static_cast<size_t>(blockIdx.y) * n;
  if (j < n) {
    const T* M = Li + vo * n;
    T a0 = T(0), a1 = T(0);
    for (int i = j; i < n; ++i) {
      const T l = M[static_cast<size_t>(i) * n + j];
      a0 = a0 + l * w[vo + i];
      a1 = a1 + l * z[vo + i];
    }
    const T mean = dj[vo + j] * a0;
    mout[vo + j] = mean;
    bpout[vo + j] = mean + dj[vo + j] * a1;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
}

template <typename T>
cudaError_t launch(const T* Sig, const T* d, const T* z, T* L, T* Li, T* dj,
                   T* mean, T* bp, T* w, int batch, int n, T ridge,
                   unsigned long long* count, cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  const int nblk = (n + kPanel - 1) / kPanel;
  cudaError_t err;
  wide_chol_prep_kernel<T><<<dim3(nblk, batch), kThreads, 0, stream>>>(
      Sig, L, dj, n, ridge);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int nb = n - k0 < kPanel ? n - k0 : kPanel;
    wide_chol_diag_kernel<T><<<dim3(1, batch), kThreads, 0, stream>>>(L, n,
                                                                       k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int rest = n - k0 - nb;
    if (rest > 0) {
      wide_chol_panel_kernel<T><<<dim3((rest + kPanel - 1) / kPanel, batch),
                                  kThreads, 0, stream>>>(L, n, k0);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      const int nt = (rest + kTile - 1) / kTile;
      wide_chol_trailing_kernel<T><<<dim3(nt * (nt + 1) / 2, batch),
                                     kThreads, 0, stream>>>(L, n, k0, nb);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  wide_chol_inverse_kernel<T><<<dim3(nblk, batch), kThreads, 0, stream>>>(
      L, Li, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_chol_w_kernel<T><<<dim3((n + kThreads / 32 - 1) / (kThreads / 32),
                               batch),
                          kThreads, 0, stream>>>(Li, dj, d, w, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_chol_out_kernel<T><<<dim3((n + kThreads - 1) / kThreads, batch),
                            kThreads, 0, stream>>>(Li, dj, w, z, mean, bp, n,
                                                   count);
  return cudaGetLastError();
}

}  // namespace

cudaError_t ptg_launch_chol_solve_sample_wide_f32(
    const float* Sig, const float* d, const float* z, float* L, float* Li,
    float* dj, float* mean, float* bp, float* w, int batch, int n,
    float ridge, unsigned long long* count, cudaStream_t stream) {
  return launch<float>(Sig, d, z, L, Li, dj, mean, bp, w, batch, n, ridge,
                       count, stream);
}

cudaError_t ptg_launch_chol_solve_sample_wide_f64(
    const double* Sig, const double* d, const double* z, double* L,
    double* Li, double* dj, double* mean, double* bp, double* w, int batch,
    int n, double ridge, unsigned long long* count, cudaStream_t stream) {
  return launch<double>(Sig, d, z, L, Li, dj, mean, bp, w, batch, n, ridge,
                        count, stream);
}
