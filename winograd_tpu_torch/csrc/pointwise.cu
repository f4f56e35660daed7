// Fused 1x1 conv + folded BN (+ ReLU): out[P, N] = x[P, K] w[K, N] * scale + bias.
//
// Replaces: winograd_tpu/kernels/pointwise.py::_matmul_bn_kernel
// (conv1x1_bn_pallas). On the served ResNet-50 path it runs every 1x1 conv,
// the stride-2 3x3 as a GEMM on a strided im2col (K up to 4608), and the
// head FC (P = 1, N = 1000).
//
// Bound on the H100: at P >= 196 rows the GEMM does 2*P*K*N FLOPs on
// 4*(P*K + K*N + P*N) bytes, far above the FP32 ridge point (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/byte), so it is bound by the FP32 FFMA rate;
// the conv5_x layers (P = 49) and the head (P = 1) read each weight a few
// times at most and are bound by the weight bytes from HBM.
//
// Design: FP32 FFMA with FP32 accumulation, which holds the 1e-4 f32 bar
// where TF32 tensor cores would not. A shared-memory tiled SGEMM (gemm.cuh,
// 64 x 64 tile, 4 x 4 outputs per thread) with the BN FMA and ReLU in the
// epilogue, so the activation makes one trip through HBM each way. Ragged
// P, K and N are masked, so P = 1 and K = 4608 read nothing out of bounds.
// It leaves most of the FP32 peak unused at small P (few tiles for 132 SMs);
// split-K, wgmma with 3xTF32 and TMA pipelining are later work.

#include "common.cuh"
#include "gemm.cuh"

__global__ void __launch_bounds__(wt::kGemmThreads) pointwise_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int P, int K, int N, int relu) {
  __shared__ __align__(16) float smem[wt::kGemmSmemFloats];
  wt::gemm_bn_tile(wt::RowMajorA{x, K}, w, scale, bias, out, P, K, N, relu,
                   blockIdx.y * wt::kBM, blockIdx.x * wt::kBN, smem);
}

extern "C" int pointwise_conv1x1_bn(const float* x, const float* w,
                                    const float* scale, const float* bias,
                                    float* out, int P, int K, int N, int relu,
                                    void* stream) {
  if (P <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + wt::kBN - 1) / wt::kBN, (P + wt::kBM - 1) / wt::kBM);
  pointwise_kernel<<<grid, wt::kGemmThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, w, scale, bias,
                                                          out, P, K, N, relu);
  return static_cast<int>(cudaGetLastError());
}
