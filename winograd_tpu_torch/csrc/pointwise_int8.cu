// Int8 1x1 conv + folded BN (+ ReLU) with per-row dynamic activation
// quantization: out[p, n] = float(q(x)[p, :] . w_q[:, n]) * (s_x[p] * s_w[n])
// * scale[n] + bias[n] (+ ReLU); gemm_int8.cuh states the arithmetic.
//
// Replaces: winograd_tpu/kernels/quantized.py::_quant_matmul_kernel
// (conv1x1_bn_int8_pallas). On the int8 ResNet-50 path it runs the
// projection block's three 1x1s (3136 x 64 -> 64 and 256) and the head FC
// (P = 1, K = 2048, N = 1000).
//
// Bound on the H100: the int8 products at 1979 TOPS are far below the
// bytes: x in f32 (4 bytes a value), the int8 weights and the f32 output,
// at 3.35 TB/s. At 3136 x 64 -> 256 that is 4.0 MB, ~1.2 us; the head reads
// its 2 MB of int8 weights once.
//
// Design: the int8 tile of gemm_int8.cuh, one 64 x 64 output tile per
// block: the block first finds its 64 rows' scales (one warp per row over
// all of K), then quantizes x as it stages it, multiplies by __dp4a into
// int32 and applies the dequant/BN epilogue. Each block of a row band
// recomputes the band's scales; at these widths that is a few KB of reads.
// No tensor cores (mma/wgmma) yet: that is later work.

#include "common.cuh"
#include "gemm_int8.cuh"

__global__ void __launch_bounds__(wt::kGemmThreads) pointwise_int8_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ sw, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ out, int P, int K, int N,
    int relu) {
  __shared__ __align__(16) int smem[wt::kInt8SmemBytes / 4];
  wt::int8_gemm_tile(wt::RowMajorA{x, K}, wq, P, K, N, blockIdx.y * wt::kBM,
                     blockIdx.x * wt::kBN, smem,
                     wt::Int8BnEpilogue{sw, scale, bias, out, N, relu});
}

extern "C" int pointwise_int8_conv1x1_bn(const float* x, const int8_t* wq,
                                         const float* sw, const float* scale,
                                         const float* bias, float* out, int P,
                                         int K, int N, int relu, void* stream) {
  if (P <= 0 || K <= 0 || N <= 0 || K % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + wt::kBN - 1) / wt::kBN, (P + wt::kBM - 1) / wt::kBM);
  pointwise_int8_kernel<<<grid, wt::kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wq, sw, scale, bias, out, P, K, N, relu);
  return static_cast<int>(cudaGetLastError());
}
