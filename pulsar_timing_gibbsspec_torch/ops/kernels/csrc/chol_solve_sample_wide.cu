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
// What bounds it on Hopper: per system ~n^3/3 multiply-adds of the
// factor plus ~n^3/6 of the inverse (0.2 GFLOP at n = 673), against 5.4
// MB of Sig in and L, Li out: at 8 systems ~0.024 ms by operations and
// ~0.013 ms by bytes.  Neither rate is what a design of this shape pays
// for: it is the chain of dependent steps (22 panels of 32 columns at n =
// 673, each a diagonal factor, a panel solve and a trailing update) and
// the trailing updates' traffic through L2.  The first wide form ran the
// steps as 68 dependent launches, and its inverse as a column-block
// chain whose first block did most of the work.
//
// The design: one launch per call, one thread-block cluster per system
// (the most CTAs, up to 16, at which the card runs every system's
// cluster at once), its CTAs synchronised by cluster barriers where the
// first form ended a launch.  The working matrices are the L and Li
// outputs in device memory (8 systems of L and Li are 29 MB in float32,
// inside the 50 MB L2); every access to them goes to L2 (ld/st.cg), so a
// barrier's release/acquire orders what one CTA wrote before another
// reads it.  (A and the inverse's right-hand side together are 1.8 MB
// per system in float32, twice what the cluster's shared memory holds;
// each warp stages the 32 x 32 blocks it multiplies.)  Per panel k of kB
// = 32 columns, right-looking, with the inverse formed in the same sweep
// (Li = L^-1 row block by row block, R the right-hand side, held
// transposed so every operand row is contiguous):
//   1. diagonal block: the 8 warps of the CTA that owns the panel stage
//      A_kk and apply its last update; one warp then factors it right-
//      looking in registers (a lane per row, no block barrier) and
//      inverts it in registers (a lane per column) into D_k = L_kk^-1,
//      written as Li's diagonal block;
//   2. panel (all warps of the cluster): every 32-vector v of the panel
//      becomes D_k v: the rows below, L_ik = A_ik D_k^T; the columns of
//      R's row block k, Li_k = D_k R_k; and w_k = D_k t_k, the forward
//      substitution w = L^-1 (dj * d) carried as one more vector;
//   3. trailing update (all warps, 32 x 32 blocks in contiguous runs per
//      warp): A_IJ -= L_Ik L_Jk^T (k < J <= I), R_IJ -= L_Ik Li_kJ (J <=
//      k), t_I -= L_Ik w_k.  Lookahead: the CTA that owns panel k + 1
//      does its step 1 meanwhile (its warp 0 instead of trailing blocks).
// Then [mean | bp] = dj * Li^T [w | z], a warp per row of R^T (Li's
// column), which also moves Li into place and zeros its upper triangle.
// Two cluster barriers per panel; 46 at n = 673.  Where the time goes
// (tools/torch_wide_factor_timeline.py on the H100): the one-warp
// diagonal factor and inverse, alone and beside the trailing warps, and
// the trailing updates, bound by their L2 traffic (each 32 x 32 block
// reads and writes its outputs there on every panel); keeping each CTA's
// row blocks in shared memory is the next step.
// Thread 0 of the first CTA adds one to the form's device counter as it
// finishes.  Dynamic shared memory (84 KB in float32) and the non-
// portable cluster sizes are set on the kernel's first launch on a
// device, which precedes any CUDA graph capture.
#include <cooperative_groups.h>

#include "kernels.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 32;       // panel width and block size
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kB + 4;  // row stride of a staged block
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float drsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double drsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float dfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double dfma(double a, double b, double c) {
  return fma(a, b, c);
}

// out = p[0 .. 3] from shared memory (p 16-byte aligned)
__device__ __forceinline__ void ld4(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&out)[4]) {
  const double2 v0 = *reinterpret_cast<const double2*>(p);
  const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
  out[0] = v0.x;
  out[1] = v0.y;
  out[2] = v1.x;
  out[3] = v1.y;
}

// One system's working buffers (this CTA's view)
template <typename T>
struct Work {
  T* L;  // A's lower triangle -> L (row-major n x n)
  T* R;  // R^T -> Li^T in the upper triangle, the right-hand side of Li
  T* w;  // dj * d -> w = L^-1 (dj * d)
  int n;
};

__device__ __forceinline__ void cluster_barrier() {
  cg::this_cluster().sync();
}

// Step 1 for panel kp, part 1, by all warps of the CTA that owns it:
// stage A_kk's lower triangle (identity rows past n) into sQ and, when
// updating, L_k,k-1 into sP (warp w the rows 4 w .. 4 w + 3), then A_kk
// -= L_k,k-1 L_k,k-1^T (warp w those rows, lane = column).  sP, sQ: warp
// 0's staging blocks.
template <typename T>
__device__ void diag_stage(const Work<T>& W, int kp, bool update, T* sP,
                           T* sQ, int warp, int lane) {
  const int n = W.n, r0 = kp * kB, kb = min(kB, n - r0);
  constexpr int kRows = kB / kWarps;
  T av[kRows], pv[kRows];  // every load in flight at once
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    const int r = kRows * warp + e;
    const T* row = W.L + static_cast<size_t>(r0 + r) * n + r0 + lane;
    av[e] = r < kb ? (lane <= r ? __ldcg(row) : T(0))
                   : (lane == r ? T(1) : T(0));
    pv[e] = update && r < kb ? __ldcg(row - kB) : T(0);
  }
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    sQ[(kRows * warp + e) * kLd + lane] = av[e];
    sP[(kRows * warp + e) * kLd + lane] = pv[e];
  }
  __syncthreads();
  if (update) {
    T pr[kB];  // row `lane` of L_k,k-1
#pragma unroll
    for (int m = 0; m < kB; m += 4) {
      T q[4];
      ld4(sP + lane * kLd + m, q);
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[m + e] = q[e];
    }
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      const int r = kRows * warp + e;
      T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int m = 0; m < kB; m += 4) {
        T q[4];
        ld4(sP + r * kLd + m, q);
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[f] = dfma(q[f], pr[m + f], acc[f]);
      }
      if (lane <= r && r < kb)
        sQ[r * kLd + lane] -= (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
  }
}

// Step 1 for panel kp, part 2, by one warp: L_kk = chol(A_kk) right-
// looking in registers (lane = row; each column reaches the other lanes
// through a shared-memory buffer; 1 / L_jj from the hardware reciprocal
// square root, one special-function call where a square root and a
// division stood on each column's dependent chain, inside the error
// class), then X = L_kk^-1 by forward
// substitution in registers (lane = column), written as L's diagonal
// block and, transposed, as R^T's (the final Li block).  sQ holds A_kk
// from diag_stage; sP is free.
template <typename T>
__device__ void diag_factor(const Work<T>& W, int kp, T* sP, T* sQ,
                            int lane) {
  const int n = W.n, r0 = kp * kB, kb = min(kB, n - r0);
  T a[kB], dinv[kB];
#pragma unroll
  for (int m = 0; m < kB; m += 4) {
    T q[4];
    ld4(sQ + lane * kLd + m, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) a[m + e] = q[e];
  }
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const T ajj = __shfl_sync(kFull, a[j], j);
    const T inv = drsqrt(ajj);
    const T piv = ajj * inv;
    dinv[j] = inv;
    if (lane == j)
      a[j] = piv;
    else if (lane > j)
      a[j] = a[j] * inv;
    T* col = sP + (j & 1) * kLd;  // column j, double-buffered
    col[lane] = a[j];
    __syncwarp();
#pragma unroll
    for (int m = (j + 1) & ~3; m < kB; m += 4) {
      T q[4];
      ld4(col + m, q);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m + e > j && lane >= m + e) a[m + e] = dfma(-a[j], q[e], a[m + e]);
    }
  }
#pragma unroll
  for (int m = 0; m < kB; ++m) sQ[lane * kLd + m] = a[m];
  __syncwarp();
  T x[kB];  // column `lane` of X
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int m = 0; m < i; m += 4) {
      T q[4];
      ld4(sQ + i * kLd + m, q);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m + e < i) acc[e] = dfma(q[e], x[m + e], acc[e]);
    }
    x[i] = ((i == lane ? T(1) : T(0)) -
            ((acc[0] + acc[1]) + (acc[2] + acc[3]))) * dinv[i];
  }
#pragma unroll
  for (int m = 0; m < kB; ++m) sP[lane * kLd + m] = x[m];
  __syncwarp();
  // L's rows and R^T's rows (X^T), lanes along each row
#pragma unroll 4
  for (int r = 0; r < kb; ++r) {
    if (lane <= r)
      __stcg(W.L + static_cast<size_t>(r0 + r) * n + r0 + lane,
             sQ[r * kLd + lane]);
    if (lane < kb)
      __stcg(W.R + static_cast<size_t>(r0 + r) * n + r0 + lane,
             sP[r * kLd + lane]);
  }
}

// Step 2 for panel k: every 32-vector v of the panel (R^T rows q < k0,
// L rows below the diagonal block, the w segment) becomes D v, with D =
// L_kk^-1 from R^T's diagonal block; warp gw of nw takes vectors gw, gw +
// nw, ..., eight at a time, their loads in flight with D's.
template <typename T>
__device__ void panel_task(const Work<T>& W, int k, int gw, int nw,
                           int lane) {
  const int n = W.n, k0 = k * kB, kb = min(kB, n - k0);
  const int nq = n - kb + 1;
  auto vec = [&](int q) {
    return q < k0       ? W.R + static_cast<size_t>(q) * n + k0
           : q < n - kb ? W.L + static_cast<size_t>(q + kb) * n + k0
                        : W.w + k0;
  };
  T dr[kB];  // row `lane` of D: D[lane][c] = R[k0 + c][k0 + lane]
#pragma unroll
  for (int c = 0; c < kB; ++c)
    dr[c] = c < kb && lane < kb
                ? __ldcg(W.R + static_cast<size_t>(k0 + c) * n + k0 + lane)
                : T(0);
  for (int q0 = gw; q0 < nq; q0 += 8 * nw) {
    T x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * nw;
      x[u] = q < nq && lane < kb ? __ldcg(vec(q) + lane) : T(0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * nw;
      if (q >= nq) break;
      T y = T(0);
#pragma unroll
      for (int c = 0; c < kB; ++c)
        y = dfma(dr[c], __shfl_sync(kFull, x[u], c), y);
      if (lane < kb) __stcg(vec(q) + lane, y);
    }
  }
}

// Step 3 for panel k, one 32 x 32 block by one warp: out(i, j) -= sum_m
// P[i][m] Q[j][m] with P = L's rows I (columns of panel k) and Q = L's
// rows J (A update, J > k: out is L's block (I, J), its lower triangle on
// the diagonal) or R^T's rows J (J <= k: out is R^T's block (J, I)); J =
// I + 1 is the w item, t_I -= P w_k.  Lane (a, b) = (lane / 4, lane % 4)
// owns rows a + 8 u and columns b + 4 v of the block.
struct Item {
  int I, J;
  bool loadP;  // sP does not hold this item's P yet
};

template <typename T>
__device__ void block_update(const Work<T>& W, int k, const Item& it, T* sP,
                             T* sQ, int lane) {
  const int n = W.n, k0 = k * kB, i0 = it.I * kB, j0 = it.J * kB;
  const bool witem = it.J == it.I + 1, isR = it.J <= k;
  const int a = lane >> 2, bq = lane & 3;
  // out(i, j) at base[i * si + j * sj]
  T* base = isR ? W.R : W.L;
  const size_t si = isR ? 1 : n, sj = isR ? n : 1;
  // every load in flight at once (a block costs one L2 round trip, not
  // one per row): the lane's outputs (the w item: acc[0][0] = t_I[lane]),
  // column `lane` of P (unless sP holds it from the previous item) and of
  // Q (the w item: row 0, w_k)
  T acc[4][8], pc[kB], qc[kB];
  unsigned live = 0;  // bit 8 u + v: the lane's output (u, v) is stored
  if (witem) {
    acc[0][0] = i0 + lane < n ? __ldcg(W.w + i0 + lane) : T(0);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int i = i0 + a + 8 * u, j = j0 + bq + 4 * v;
        const bool ok = i < n && j < n && (it.J != it.I || j <= i);
        live |= ok ? 1u << (8 * u + v) : 0u;
        acc[u][v] = ok ? __ldcg(base + i * si + j * sj) : T(0);
      }
  }
  if (it.loadP)
#pragma unroll
    for (int r = 0; r < kB; ++r)
      pc[r] = i0 + r < n ? __ldcg(W.L + static_cast<size_t>(i0 + r) * n +
                                  k0 + lane)
                         : T(0);
  const T* qsrc = base + static_cast<size_t>(j0) * n + k0 + lane;
#pragma unroll
  for (int r = 0; r < kB; ++r)
    qc[r] = witem ? (r == 0 ? __ldcg(W.w + k0 + lane) : T(0))
            : j0 + r < n ? __ldcg(qsrc + static_cast<size_t>(r) * n)
                         : T(0);
  if (it.loadP)
#pragma unroll
    for (int r = 0; r < kB; ++r) sP[r * kLd + lane] = pc[r];
#pragma unroll
  for (int r = 0; r < kB; ++r) sQ[r * kLd + lane] = qc[r];
  __syncwarp();
  if (witem) {  // t_I -= P w_k
    if (i0 + lane < n) {
      T s = acc[0][0];
#pragma unroll
      for (int m = 0; m < kB; m += 4) {
        T p[4], q[4];
        ld4(sP + lane * kLd + m, p);
        ld4(sQ + m, q);
#pragma unroll
        for (int e = 0; e < 4; ++e) s = dfma(-p[e], q[e], s);
      }
      __stcg(W.w + i0 + lane, s);
    }
    __syncwarp();
    return;
  }
#pragma unroll 2
  for (int m = 0; m < kB; m += 4) {
    T p[4][4], q[8][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) ld4(sP + (a + 8 * u) * kLd + m, p[u]);
#pragma unroll
    for (int v = 0; v < 8; ++v) ld4(sQ + (bq + 4 * v) * kLd + m, q[v]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[u][v] = dfma(-p[u][e], q[v][e], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v)
      if (live >> (8 * u + v) & 1u)
        __stcg(base + (i0 + a + 8 * u) * si + (j0 + bq + 4 * v) * sj,
               acc[u][v]);
  __syncwarp();  // the staging blocks are free for the next item
}

// Step 3 for panel k over worker warp wid of nwk: the blocks of row
// blocks I > k in order (J = 0 .. I, then the w item J = I + 1), block
// (k + 1, k + 1) left out (the lookahead's), dealt in contiguous runs, so
// consecutive items of a warp mostly share their P block.  (Putting the
// next item's loads in flight during the current item's products
// measured slower on the H100: the two items' registers crowd the
// warp.)
template <typename T>
__device__ void trailing_task(const Work<T>& W, int k, int nblk, int wid,
                              int nwk, T* sP, T* sQ, int lane) {
  auto cnt = [&](int I) { return I + 2 - (I == k + 1 ? 1 : 0); };
  int total = 0;
  for (int I = k + 1; I < nblk; ++I) total += cnt(I);
  const int t0 = static_cast<int>(static_cast<long long>(wid) * total / nwk);
  const int t1 =
      static_cast<int>(static_cast<long long>(wid + 1) * total / nwk);
  int I = k + 1, base = 0, loaded = -1;
  auto item = [&](int t) {
    while (t - base >= cnt(I)) base += cnt(I++);
    Item it{I, t - base, I != loaded};
    if (I == k + 1 && it.J >= k + 1) ++it.J;
    loaded = I;
    return it;
  };
  for (int t = t0; t < t1; ++t) block_update(W, k, item(t), sP, sQ, lane);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wide_chol_kernel(const T* __restrict__ Sig, const T* __restrict__ d,
                 const T* __restrict__ z, T* __restrict__ Lout,
                 T* __restrict__ Liout, T* __restrict__ djout,
                 T* __restrict__ mout, T* __restrict__ bpout,
                 T* __restrict__ wbuf, int n, T ridge,
                 unsigned long long* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sdj = reinterpret_cast<T*>(smem_raw);  // [kCholWideMaxN] each
  T* sw = sdj + kCholWideMaxN;
  T* sz = sw + kCholWideMaxN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* sP = sz + kCholWideMaxN + warp * 2 * kB * kLd;
  T* sQ = sP + kB * kLd;
  const int cs = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const size_t mo = static_cast<size_t>(blockIdx.y) * n * n;
  const size_t vo = static_cast<size_t>(blockIdx.y) * n;
  const T* S = Sig + mo;
  const Work<T> W{Lout + mo, Liout + mo, wbuf + vo, n};
  const int nblk = (n + kB - 1) / kB;
  const int gw = rank * kWarps + warp, nw = cs * kWarps;

  // ---- dj, A's lower triangle (zeros above), R^T = I, w = dj * d; a
  // warp per row, kQ rows' loads in flight at once (one in float64,
  // whose registers would spill)
  constexpr int kT = kCholWideMaxN / 32;  // row elements per lane
  constexpr int kQ = sizeof(T) == 4 ? 2 : 1;
  for (int j = threadIdx.x; j < n; j += kThreads)
    sdj[j] = T(1) / dsqrt(S[static_cast<size_t>(j) * n + j]);
  __syncthreads();
  for (int r0 = gw; r0 < n; r0 += kQ * nw) {
    T sv[kQ][kT];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = r0 + q * nw;
      const T* Sr = S + static_cast<size_t>(r) * n;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int c = lane + 32 * t;
        sv[q][t] = r < n && c <= r ? Sr[c] : T(0);
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = r0 + q * nw;
      if (r >= n) break;
      const T djr = sdj[r];
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int c = lane + 32 * t;
        if (c < n) {
          T v = T(0);
          if (c <= r) {
            v = sv[q][t] * djr * sdj[c];
            if (c == r) v = v + ridge;
          }
          __stcg(W.L + static_cast<size_t>(r) * n + c, v);
          // R^T's strict lower triangle is never read, and the last pass
          // writes all of it
          if (c >= r)
            __stcg(W.R + static_cast<size_t>(r) * n + c,
                   c == r ? T(1) : T(0));
        }
      }
      if (lane == 0) {
        __stcg(W.w + r, djr * d[vo + r]);
        djout[vo + r] = djr;
      }
    }
  }
  cluster_barrier();
  T* sP0 = sz + kCholWideMaxN;  // warp 0's staging blocks
  T* sQ0 = sP0 + kB * kLd;
  if (rank == 0) {
    diag_stage(W, 0, false, sP0, sQ0, warp, lane);
    if (warp == 0) diag_factor(W, 0, sP0, sQ0, lane);
  }
  cluster_barrier();

  // ---- the panels: step 2, then step 3 with the next diagonal block
  for (int k = 0; k < nblk; ++k) {
    panel_task(W, k, gw, nw, lane);
    cluster_barrier();
    if (k + 1 < nblk) {
      const int own = (k + 1) % cs;  // CTA whose warp 0 looks ahead
      if (rank == own) diag_stage(W, k + 1, true, sP0, sQ0, warp, lane);
      if (rank == own && warp == 0) {
        diag_factor(W, k + 1, sP0, sQ0, lane);
      } else {
        const int wid = gw - (gw > own * kWarps ? 1 : 0);
        trailing_task(W, k, nblk, wid, nw - 1, sP, sQ, lane);
      }
    }
    cluster_barrier();
  }

  // ---- [mean | bp] = dj * Li^T [w | z], a warp per column j of Li (row
  // j of R^T), kQ rows' loads in flight at once, which it also moves
  // into Li's lower triangle
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sw[i] = __ldcg(W.w + i);
    sz[i] = z[vo + i];
  }
  __syncthreads();
  for (int j0 = gw; j0 < n; j0 += kQ * nw) {
    T v[kQ][kT];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int j = j0 + q * nw;
      const T* row = W.R + static_cast<size_t>(j) * n;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int i = j + lane + 32 * t;
        v[q][t] = j < n && i < n ? __ldcg(row + i) : T(0);
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int j = j0 + q * nw;
      if (j >= n) break;
      T* row = W.R + static_cast<size_t>(j) * n;
      T a0 = T(0), a1 = T(0);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int i = j + lane + 32 * t;
        if (i < n) {
          a0 = dfma(v[q][t], sw[i], a0);
          a1 = dfma(v[q][t], sz[i], a1);
          if (i > j) {
            W.R[static_cast<size_t>(i) * n + j] = v[q][t];
            row[i] = T(0);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a0 = a0 + __shfl_xor_sync(kFull, a0, off);
        a1 = a1 + __shfl_xor_sync(kFull, a1, off);
      }
      if (lane == 0) {
        const T mean = sdj[j] * a0;
        mout[vo + j] = mean;
        bpout[vo + j] = mean + sdj[j] * a1;
      }
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
}

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (3 * kCholWideMaxN + kWarps * 2 * kB * kLd);
}

// The kernel's launch setup on a device, made at its first launch there
// (before any CUDA graph capture): shared-memory limit, non-portable
// cluster sizes allowed, and how many clusters of each size 1 .. 16 of
// this kernel the card runs at once (the GPCs' SM counts decide it).
struct ClusterFit {
  int active[17];  // [c]: clusters of c CTAs at once (c = 1 .. 16)
};

template <typename T>
cudaError_t setup(ClusterFit* fit) {
  static int known[kMaxDevices];
  static ClusterFit cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && known[dev]) {
    *fit = cached[dev];
    return cudaSuccess;
  }
  const auto kernel = wide_chol_kernel<T>;
  const size_t smem = smem_bytes<T>();
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  ClusterFit f = {};
  for (int c = 1; c <= 16; ++c) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&f.active[c], kernel, &cfg) !=
        cudaSuccess) {
      cudaGetLastError();  // clear it: this size is not used
      f.active[c] = 0;
    }
  }
  *fit = f;
  if (dev < kMaxDevices) {
    cached[dev] = f;
    known[dev] = 1;
  }
  return cudaSuccess;
}

// Cluster size for `batch` systems: the largest (up to 16) at which every
// system's cluster runs at once, else the portable 8.  The trailing
// updates, most of the work, are bound by the card's throughput, so
// filling it in one wave beats larger clusters in several: 9 CTAs at 8
// systems and 2 at 64 on the H100 (8 at 64, in five waves, measured
// 3.60 ms against 3.37 for the first wide form).
int cluster_size(const ClusterFit& fit, int batch) {
  for (int c = 16; c > 0; --c)
    if (fit.active[c] >= batch) return c;
  return 8;
}

template <typename T>
cudaError_t launch(const T* Sig, const T* d, const T* z, T* L, T* Li, T* dj,
                   T* mean, T* bp, T* w, int batch, int n, T ridge,
                   unsigned long long* count, cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  ClusterFit fit;
  cudaError_t err = setup<T>(&fit);
  if (err != cudaSuccess) return err;
  const int cs = cluster_size(fit, batch);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cs, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<T>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wide_chol_kernel<T>, Sig, d, z, L, Li, dj,
                           mean, bp, w, n, ridge, count);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

int ptg_chol_wide_config(int is_f64, int batch, int* cluster,
                         int* active16, int* threads, size_t* smem) {
  ClusterFit fit = {};
  const cudaError_t err = is_f64 ? setup<double>(&fit) : setup<float>(&fit);
  *cluster = cluster_size(fit, batch);
  *active16 = fit.active[16];
  *threads = kThreads;
  *smem = is_f64 ? smem_bytes<double>() : smem_bytes<float>();
  return static_cast<int>(err);
}

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
