// Fused 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) as an implicit GEMM:
// out[(n,y,x), co] = sum_k im2col[(n,y,x), k] w9[k, co], k = (3r+s)*Cin + c.
//
// Replaces: winograd_tpu/kernels/direct.py::_direct_kernel
// (conv3x3_bn_direct_pallas). On the served ResNet-50 path it runs the 3x3
// of every conv4_x (14x14x256) and conv5_x (7x7x512) identity block.
//
// Bound on the H100: 2*H*W*9*Cin*Cout FLOPs against
// 4*(H*W*(Cin+Cout) + 9*Cin*Cout) bytes. At 14x14x256 that is 231 MFLOP on
// 2.8 MB (84 FLOP/byte, bound by the FP32 FFMA rate); at 7x7x512 it is
// 231 MFLOP on 9.6 MB of mostly weights (24 FLOP/byte, near the ridge).
//
// Design: the im2col matrix is never written to device memory. Each block
// gathers its (64 rows x 16 k) slice of it straight from the NHWC input
// into shared memory, zero where the 3x3 window leaves the map, and runs
// the same FP32 FFMA tile as the pointwise kernel (gemm.cuh), with BN and
// ReLU in the epilogue. The gather re-reads each input pixel up to 9 times
// from L2; at these map sizes the whole input stays in L2.

#include "common.cuh"
#include "gemm.cuh"

namespace {

struct Im2colA {
  const float* __restrict__ x;
  int H, W, C;
  __device__ __forceinline__ float operator()(int p, int k) const {
    const int rs = k / C;
    const int c = k - rs * C;
    const int r = rs / 3;
    const int s = rs - 3 * r;
    const int hw = H * W;
    const int n = p / hw;
    const int q = p - n * hw;
    const int y = q / W + r - 1;
    const int xx = q % W + s - 1;
    if (y < 0 || y >= H || xx < 0 || xx >= W) return 0.f;
    return x[(static_cast<size_t>(n * H + y) * W + xx) * C + c];
  }
};

}  // namespace

__global__ void __launch_bounds__(wt::kGemmThreads) direct_kernel(
    const float* __restrict__ x, const float* __restrict__ w9,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int N, int H, int W, int Cin, int Cout,
    int relu) {
  __shared__ __align__(16) float smem[wt::kGemmSmemFloats];
  wt::gemm_bn_tile(Im2colA{x, H, W, Cin}, w9, scale, bias, out, N * H * W,
                   9 * Cin, Cout, relu, blockIdx.y * wt::kBM,
                   blockIdx.x * wt::kBN, smem);
}

extern "C" int direct_conv3x3_bn(const float* x, const float* w9,
                                 const float* scale, const float* bias,
                                 float* out, int N, int H, int W, int Cin,
                                 int Cout, int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = N * H * W;
  const dim3 grid((Cout + wt::kBN - 1) / wt::kBN, (P + wt::kBM - 1) / wt::kBM);
  direct_kernel<<<grid, wt::kGemmThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, w9, scale, bias, out,
                                                       N, H, W, Cin, Cout,
                                                       relu);
  return static_cast<int>(cudaGetLastError());
}
