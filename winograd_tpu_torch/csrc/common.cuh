// Shared by every kernel library of winograd_tpu_torch: each .cu file is
// built into its own shared library with a plain C interface (see
// kernels/_build.py), and each exports this error-string helper so the
// Python wrapper can name a refused launch. Also the fused ReLU and
// max-pool's maximum, which every kernel shares.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* wt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace wt {

// max(a, b), NaN when either is NaN, as jnp.maximum and torch.maximum
// (fmaxf returns the other operand); PTX max.NaN, the same as max.f32 on
// every other input.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The fused ReLU: max(y, 0), keeping a NaN (jnp.maximum(y, 0.0)).
__device__ __forceinline__ float relu(float y) { return max_nan(y, 0.f); }

}  // namespace wt
