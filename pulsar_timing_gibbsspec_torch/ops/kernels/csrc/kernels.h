// Launchers of the port's hand-written Hopper kernels (sm_90a).
//
// Each launcher enqueues one kernel on `stream`, allocates nothing, does
// not synchronise, and returns cudaGetLastError() right after the launch
// so a refused launch (too many threads, too much shared memory) is
// reported to the caller instead of silently never running.
#pragma once

#include <cuda_runtime.h>

// Largest matrix order chol_solve_sample takes (shared memory holds four
// n x n tiles of the element type).
constexpr int kCholMaxN = 96;
// Largest augmented basis width B1 gram_accumulate takes: a 16 x 16
// thread grid with a 4 x 4 register tile per thread covers 64 x 64.
constexpr int kGramMaxB1 = 64;

cudaError_t ptg_launch_chol_solve_sample_f32(
    const float* Sig, const float* d, const float* z, float* L, float* Li,
    float* dj, float* mean, float* bp, int batch, int n, float ridge,
    cudaStream_t stream);

cudaError_t ptg_launch_chol_solve_sample_f64(
    const double* Sig, const double* d, const double* z, double* L,
    double* Li, double* dj, double* mean, double* bp, int batch, int n,
    double ridge, cudaStream_t stream);

// form 0: float32 segment dots, float32 segment reduce, float32 out
// form 1: float32 segment dots, float64 segment reduce, float64 out
// form 2: float64 ("widen") accumulation inside and across segments
cudaError_t ptg_launch_gram_accumulate(
    const float* TNa, const float* Ta, void* G, int batch, int batch_ta,
    int nseg, int m, int B1, int form, cudaStream_t stream);
