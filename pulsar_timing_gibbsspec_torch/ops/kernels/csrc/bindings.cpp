// Plain C entry points of the kernel library, loaded from Python with
// ctypes (pulsar_timing_gibbsspec_torch/ops/kernels/build.py).  Each
// validates its sizes, enqueues one kernel on the given stream and
// returns the CUDA error code of the launch (0 on success).
#include <cuda_runtime.h>

#include "kernels.h"

extern "C" {

const char* ptg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ptg_chol_solve_sample(int is_f64, const void* Sig, const void* d,
                          const void* z, void* L, void* Li, void* dj,
                          void* mean, void* bp, int batch, int n,
                          double ridge, void* stream) {
  if (batch < 0 || n < 1 || n > kCholMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return static_cast<int>(ptg_launch_chol_solve_sample_f64(
        static_cast<const double*>(Sig), static_cast<const double*>(d),
        static_cast<const double*>(z), static_cast<double*>(L),
        static_cast<double*>(Li), static_cast<double*>(dj),
        static_cast<double*>(mean), static_cast<double*>(bp), batch, n,
        ridge, s));
  return static_cast<int>(ptg_launch_chol_solve_sample_f32(
      static_cast<const float*>(Sig), static_cast<const float*>(d),
      static_cast<const float*>(z), static_cast<float*>(L),
      static_cast<float*>(Li), static_cast<float*>(dj),
      static_cast<float*>(mean), static_cast<float*>(bp), batch, n,
      static_cast<float>(ridge), s));
}

int ptg_gram_accumulate(const void* TNa, const void* Ta, void* G, int batch,
                        int batch_ta, int nseg, int m, int B1, int form,
                        void* stream) {
  if (batch < 0 || batch_ta < 1 || batch % batch_ta != 0 || nseg < 1 ||
      m < 1 || B1 < 1 || B1 > kGramMaxB1 || form < 0 || form > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ptg_launch_gram_accumulate(
      static_cast<const float*>(TNa), static_cast<const float*>(Ta), G, batch,
      batch_ta, nseg, m, B1, form, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
