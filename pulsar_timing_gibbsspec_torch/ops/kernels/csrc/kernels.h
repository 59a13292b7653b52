// Launchers of the port's hand-written Hopper kernels (sm_90a).
//
// Each launcher enqueues one kernel on `stream`, allocates nothing, does
// not synchronise, and returns cudaGetLastError() right after the launch
// so a refused launch (too many threads, too much shared memory) is
// reported to the caller instead of silently never running.  `count` is
// a device counter the kernel adds one to each time it runs (thread 0 of
// the first CTA), so runs replayed from a CUDA graph are counted too.
#pragma once

#include <cuda_runtime.h>

// Largest matrix order chol_solve_sample takes: one warp per system, a
// lane owning up to three rows or columns.
constexpr int kCholMaxN = 96;
// Largest augmented basis width B1 gram_accumulate takes: 16 x 16 threads
// of 4 x 4 register tiles per chain (float32 forms), 8 DMMA column tiles
// per warp (widening and float64 forms).
constexpr int kGramMaxB1 = 64;
// Row slices per pulsar of gram_accumulate's extent scan; the caller's
// extent scratch holds P * kGramExtentSlices ints.
constexpr int kGramExtentSlices = 8;
// Largest matrix order of the wide chol_solve_sample form (n >
// kCholMaxN) and augmented width of the wide gram_accumulate form (B1 >
// kGramMaxB1).
constexpr int kCholWideMaxN = 1024;
constexpr int kGramWideMaxB1 = 1024;

cudaError_t ptg_launch_chol_solve_sample_f32(
    const float* Sig, const float* d, const float* z, float* L, float* Li,
    float* dj, float* mean, float* bp, int batch, int n, float ridge,
    unsigned long long* count, cudaStream_t stream);

cudaError_t ptg_launch_chol_solve_sample_f64(
    const double* Sig, const double* d, const double* z, double* L,
    double* Li, double* dj, double* mean, double* bp, int batch, int n,
    double ridge, unsigned long long* count, cudaStream_t stream);

// G[b] = sum_s (Ta[b % P, s] / N[b, s])^T Ta[b % P, s] over Ta (P, nseg,
// m, B1) and N (batch, Nmax), rows at or beyond Nmax of TNa zero; extent
// is (P * kGramExtentSlices) int scratch (the rows of each pulsar that can
// contribute).  Two launches: the extent scan, then the Gram.
// form 0: float32 segment dots, float32 segment reduce, float32 out
// form 1: float32 segment dots, float64 segment reduce, float64 out
// form 2: float64 ("widen") accumulation inside and across segments
// form 3: float64 Ta and N (float64 storage), float64 products and sums
// Ta and N are float32 in forms 0-2 and float64 in form 3; G is float32 in
// form 0 and float64 otherwise.
cudaError_t ptg_launch_gram_accumulate(
    const void* Ta, const void* N, void* G, int* extent, int batch, int P,
    int nseg, int m, int B1, int Nmax, int form, unsigned long long* count,
    cudaStream_t stream);

// Wide form of chol_solve_sample (kCholMaxN < n <= kCholWideMaxN): the same
// outputs, from one launch of a thread-block cluster per system with the
// matrices in device memory; w is (batch, n) scratch.
cudaError_t ptg_launch_chol_solve_sample_wide_f32(
    const float* Sig, const float* d, const float* z, float* L, float* Li,
    float* dj, float* mean, float* bp, float* w, int batch, int n,
    float ridge, unsigned long long* count, cudaStream_t stream);

cudaError_t ptg_launch_chol_solve_sample_wide_f64(
    const double* Sig, const double* d, const double* z, double* L,
    double* Li, double* dj, double* mean, double* bp, double* w, int batch,
    int n, double ridge, unsigned long long* count, cudaStream_t stream);

// Wide form of gram_accumulate (kGramMaxB1 < B1 <= kGramWideMaxB1): the
// same arguments (extent unused: every row is multiplied), forms and
// result, the output tiled across CTAs.  One launch.
cudaError_t ptg_launch_gram_accumulate_wide(
    const void* Ta, const void* N, void* G, int* extent, int batch, int P,
    int nseg, int m, int B1, int Nmax, int form, unsigned long long* count,
    cudaStream_t stream);

// Launch configuration of the wide forms, as their launchers use it: the
// factor's cluster size at `batch` systems and the number of 16-CTA
// clusters the card runs at once (found, with the kernel's attributes
// set, on the first call on the current device), threads per CTA and
// dynamic shared memory; the Gram's output tile, threads per CTA and
// dynamic shared memory of form `form` at `batch` systems of augmented
// width B1 (the float64 form picks its tile from both).  Return a CUDA
// error code / -1 for a bad form.
int ptg_chol_wide_config(int is_f64, int batch, int* cluster,
                         int* active16, int* threads, size_t* smem);
int ptg_gram_wide_config(int form, int batch, int B1, int* tile,
                         int* threads, size_t* smem);
