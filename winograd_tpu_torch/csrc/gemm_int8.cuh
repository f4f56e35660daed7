// The arithmetic of the int8 serving tier's products.
//
// What every int8 layer computes (winograd_tpu/kernels/quantized.py::_qdot):
// each row of the f32 activation matrix A gets its own symmetric scale,
//   s_x[p] = max_k |A[p, k]| / 127   (1 where the row is all zero),
//   q[p, k] = clamp(rint(A[p, k] / s_x[p]), -127, 127)   (IEEE division,
//   round half to even; never built with --use_fast_math),
// the product q x B (B int8, (K, N) row-major, quantized offline per column
// with scale s_w[n]) is summed exactly in int32, and the epilogue sees
//   float(acc) * (s_x[p] * s_w[n]),
// then applies the folded BN and the rest. Because the int32 sum is exact,
// a K split adds its partial sums in any order and the f32 epilogue runs
// once per element after the sum. The epilogue rounds each multiply and add
// on its own (dequant, bn_rn: no FMA contraction), in the order of the plain
// version (kernels/quantized.py), so the two agree to the bit.
//
// The int8 kernels multiply on the int8 tensor cores (s8 wgmma); this
// header holds what they share of that arithmetic: the row scale, the
// quantization, the packing, the dequantization and the epilogues.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"

namespace wt {

__device__ __forceinline__ float scale_from_max(float m) {
  const float s = m / 127.f;
  return s == 0.f ? 1.f : s;
}

__device__ __forceinline__ int quantize(float v, float s) {
  const int q = static_cast<int>(rintf(v / s));
  return min(127, max(-127, q));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ int pack4(int q0, int q1, int q2, int q3) {
  return (q0 & 0xff) | ((q1 & 0xff) << 8) | ((q2 & 0xff) << 16) |
         (static_cast<int>(static_cast<unsigned>(q3 & 0xff) << 24));
}

// float(acc) * (s_x * s_w), each product rounded.
__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(static_cast<float>(acc), __fmul_rn(sx, sw));
}

// y * scale + bias with the multiply and the add rounded separately.
__device__ __forceinline__ float bn_rn(float y, float scale, float bias) {
  return __fadd_rn(__fmul_rn(y, scale), bias);
}

// y = float(acc) * (s_x * s_w[n]) * scale[n] + bias[n] (+ ReLU) into
// out[p, n] (row stride N).
struct Int8BnEpilogue {
  const float* __restrict__ sw;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  float* out;
  int N;
  int relu;
  // An output from its sum, its row's scale and its column's factors.
  static __device__ __forceinline__ float value(int acc, float sx, float sw_n, float scale_n,
                                                float bias_n, int relu) {
    const float y = bn_rn(dequant(acc, sx, sw_n), scale_n, bias_n);
    return relu ? wt::relu(y) : y;
  }
  __device__ __forceinline__ void operator()(int p, int n, int acc, float sx) const {
    out[static_cast<size_t>(p) * N + n] = value(acc, sx, sw[n], scale[n], bias[n], relu);
  }
};

// out[p, n] = relu(deq * scale[n] + bias[n] + res[p, n]), deq the
// dequantized product, each multiply and add rounded on its own; res may be
// out (each element is read only by the thread that overwrites it).
struct ResidualInt8Epilogue {
  const float* __restrict__ sw;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  const float* res;
  float* out;
  int N;
  __device__ __forceinline__ void store(int p, int n, float deq) const {
    const size_t i = static_cast<size_t>(p) * N + n;
    out[i] = wt::relu(__fadd_rn(bn_rn(deq, scale[n], bias[n]), __ldcg(res + i)));
  }
  __device__ __forceinline__ void operator()(int p, int n, int acc, float sx) const {
    store(p, n, dequant(acc, sx, sw[n]));
  }
};

}  // namespace wt
