// Int8 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) as an implicit GEMM
// with per-im2col-row dynamic quantization: row p = (n, y, x) of the im2col
// matrix (K = 9 * Cin, k = (3r + s) * Cin + c, zero where the window leaves
// the map) gets its own scale over its 9 * Cin values, so one input pixel is
// quantized with a different scale for each output pixel that gathers it.
//
// Replaces: winograd_tpu/kernels/quantized.py::_direct_int8_kernel and
// ::_direct_int8_banded_kernel (conv3x3_bn_int8_pallas). The banded body is
// the same arithmetic cut into row bands to fit the TPU's scoped VMEM; here
// every block gathers only its own 64 rows, so one kernel covers both. On
// the int8 ResNet-50 path it runs the projection block's 3x3 at 56x56x64.
//
// Bound on the H100: at 56x56x64 -> 64 the 0.116 G int8 MACs take 0.12 us
// at 1979 TOPS; the bytes (f32 in and out, 37 KB of int8 weights) take
// 0.49 us: bound by bytes.
//
// Design: the int8 tile of gemm_int8.cuh with an A loader that gathers the
// im2col matrix from the NHWC input on the fly (grid_sync.cuh's Im2colCg,
// as csrc/direct.cu does in f32). The block first scans its 64 rows'
// 9 * Cin windows for their scales, then quantizes on gather. The input
// stays in L2 across the gathers.

#include "common.cuh"
#include "gemm_int8.cuh"

__global__ void __launch_bounds__(wt::kGemmThreads) direct_int8_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w9q,
    const float* __restrict__ sw, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ out, int N, int H, int W,
    int Cin, int Cout, int relu) {
  __shared__ __align__(16) int smem[wt::kInt8SmemBytes / 4];
  wt::int8_gemm_tile(wt::Im2colCg{x, H, W, Cin}, w9q, N * H * W, 9 * Cin, Cout,
                     blockIdx.y * wt::kBM, blockIdx.x * wt::kBN, smem,
                     wt::Int8BnEpilogue{sw, scale, bias, out, Cout, relu});
}

extern "C" int direct_int8_conv3x3_bn(const float* x, const int8_t* w9q,
                                      const float* sw, const float* scale,
                                      const float* bias, float* out, int N, int H,
                                      int W, int Cin, int Cout, int relu,
                                      void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || (9 * Cin) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = N * H * W;
  const dim3 grid((Cout + wt::kBN - 1) / wt::kBN, (P + wt::kBM - 1) / wt::kBM);
  direct_int8_kernel<<<grid, wt::kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w9q, sw, scale, bias, out, N, H, W, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}
