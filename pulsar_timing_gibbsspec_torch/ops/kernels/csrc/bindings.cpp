// Plain C entry points of the kernel library, loaded from Python with
// ctypes (pulsar_timing_gibbsspec_torch/ops/kernels/build.py).  Each
// validates its sizes, enqueues one kernel on the given stream and
// returns the CUDA error code of the launch (0 on success); `count` is
// the device launch counter of the kernel's form (kernels.h).
#include <cuda_runtime.h>

#include "kernels.h"

extern "C" {

const char* ptg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ptg_chol_solve_sample(int is_f64, const void* Sig, const void* d,
                          const void* z, void* L, void* Li, void* dj,
                          void* mean, void* bp, int batch, int n,
                          double ridge, void* count, void* stream) {
  if (batch < 0 || n < 1 || n > kCholMaxN || count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned long long*>(count);
  if (is_f64)
    return static_cast<int>(ptg_launch_chol_solve_sample_f64(
        static_cast<const double*>(Sig), static_cast<const double*>(d),
        static_cast<const double*>(z), static_cast<double*>(L),
        static_cast<double*>(Li), static_cast<double*>(dj),
        static_cast<double*>(mean), static_cast<double*>(bp), batch, n,
        ridge, c, s));
  return static_cast<int>(ptg_launch_chol_solve_sample_f32(
      static_cast<const float*>(Sig), static_cast<const float*>(d),
      static_cast<const float*>(z), static_cast<float*>(L),
      static_cast<float*>(Li), static_cast<float*>(dj),
      static_cast<float*>(mean), static_cast<float*>(bp), batch, n,
      static_cast<float>(ridge), c, s));
}

int ptg_gram_accumulate(const void* Ta, const void* N, void* G, void* extent,
                        int batch, int P, int nseg, int m, int B1, int Nmax,
                        int form, void* count, void* stream) {
  if (batch < 0 || P < 1 || batch % P != 0 || nseg < 1 || m < 1 ||
      B1 < 1 || B1 > kGramMaxB1 || Nmax < 1 || Nmax > nseg * m ||
      form < 0 || form > 3 || count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ptg_launch_gram_accumulate(
      Ta, N, G, static_cast<int*>(extent), batch, P, nseg, m, B1, Nmax, form,
      static_cast<unsigned long long*>(count),
      static_cast<cudaStream_t>(stream)));
}

int ptg_chol_solve_sample_wide(int is_f64, const void* Sig, const void* d,
                               const void* z, void* L, void* Li, void* dj,
                               void* mean, void* bp, void* w, int batch,
                               int n, double ridge, void* count,
                               void* stream) {
  if (batch < 0 || batch > 65535 || n <= kCholMaxN || n > kCholWideMaxN ||
      count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned long long*>(count);
  if (is_f64)
    return static_cast<int>(ptg_launch_chol_solve_sample_wide_f64(
        static_cast<const double*>(Sig), static_cast<const double*>(d),
        static_cast<const double*>(z), static_cast<double*>(L),
        static_cast<double*>(Li), static_cast<double*>(dj),
        static_cast<double*>(mean), static_cast<double*>(bp),
        static_cast<double*>(w), batch, n, ridge, c, s));
  return static_cast<int>(ptg_launch_chol_solve_sample_wide_f32(
      static_cast<const float*>(Sig), static_cast<const float*>(d),
      static_cast<const float*>(z), static_cast<float*>(L),
      static_cast<float*>(Li), static_cast<float*>(dj),
      static_cast<float*>(mean), static_cast<float*>(bp),
      static_cast<float*>(w), batch, n, static_cast<float>(ridge), c, s));
}

int ptg_gram_accumulate_wide(const void* Ta, const void* N, void* G,
                             void* extent, int batch, int P, int nseg, int m,
                             int B1, int Nmax, int form, void* count,
                             void* stream) {
  if (batch < 0 || batch > 65535 || P < 1 || batch % P != 0 || nseg < 1 ||
      m < 1 || B1 <= kGramMaxB1 || B1 > kGramWideMaxB1 || Nmax < 1 ||
      Nmax > nseg * m || form < 0 || form > 3 || count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ptg_launch_gram_accumulate_wide(
      Ta, N, G, static_cast<int*>(extent), batch, P, nseg, m, B1, Nmax, form,
      static_cast<unsigned long long*>(count),
      static_cast<cudaStream_t>(stream)));
}

// out[0..4] = cluster size at `batch` systems (the factor; 1 for the
// Gram), output tile (the Gram; 0 for the factor), threads per CTA,
// dynamic shared memory bytes, and (the factor) how many 16-CTA clusters
// the card runs at once, of the wide form of `kernel` (0:
// chol_solve_sample, `variant` = is_f64; 1: gram_accumulate, `variant` =
// form, at augmented width B1).
int ptg_wide_config(int kernel, int variant, int batch, int B1, int* out) {
  int a = 0, active16 = 0, threads = 0;
  size_t smem = 0;
  int code;
  if (kernel == 0) {
    code = ptg_chol_wide_config(variant, batch, &a, &active16, &threads,
                                &smem);
    out[0] = a;
    out[1] = 0;
  } else {
    code = ptg_gram_wide_config(variant, batch, B1, &a, &threads, &smem);
    out[0] = 1;
    out[1] = a;
  }
  out[2] = threads;
  out[3] = static_cast<int>(smem);
  out[4] = active16;
  return code;
}

}  // extern "C"
