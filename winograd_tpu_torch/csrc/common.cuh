// Shared by every kernel library of winograd_tpu_torch: each .cu file is
// built into its own shared library with a plain C interface (see
// kernels/_build.py), and each exports this error-string helper so the
// Python wrapper can name a refused launch.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* wt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
