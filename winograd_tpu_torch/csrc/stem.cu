// Fused ResNet stem: 7x7/2 conv (pad 3) + folded BN + ReLU + 3x3/2 maxpool
// (pad 1 top/left, ceil-mode output), NHWC image -> pooled NHWC map, at
// precision "f32" or "bf16". "bf16" is the int8 serving tier's stem: the
// image and the weights are rounded to bf16 (round to nearest even) as they
// are staged; their products are exact, and they are summed in FP64 and
// rounded to float once, then BN's multiply and add round separately. The
// sum is then independent of its order, so the plain version (a float64
// matmul of the same bf16 values) matches the kernel to the bit, which the
// int8 layers after the stem need (csrc/stage_int8.cu says why).
//
// Replaces: winograd_tpu/kernels/stem.py::_stem_kernel (stem_fused_pallas,
// stem_fused_pallas_pre). The TPU kernel consumes a space-to-depth operand
// built outside it, a relayout that exists for the TPU's 128-lane tiling;
// this kernel reads the raw image and takes the same w192 weight operand
// (rows ordered (a, b, u, v, c), tap (r, s) = (2a+u, 2b+v), see
// models/resnet50.py::stem_filter_s2d), mapping each tap to its row itself.
//
// Bound on the H100: at 224x224x3 -> 112x112x64 the conv is 236 MFLOP on
// 0.6 MB of image and 0.8 MB of pooled output: bound by the FP32 FFMA rate.
//
// Design: one block produces a 4 x 8 tile of pooled outputs for every
// channel. It stages the 23 x 39 x Cin input patch and all 49*Cin*C
// weights in shared memory, computes the 9 x 17 conv outputs the pool
// windows need (20% recomputed at the tile borders), applies BN + ReLU and
// keeps them in shared memory, then pools. At "bf16" the changes are the
// rounding at the two staging loops and the FP64 sums. Each thread owns one conv row
// of one channel, so every weight read from shared memory feeds 17 FMAs
// and the input reads are broadcasts. Conv positions outside the conv map
// (the pool's top/left pad, ceil-mode overhang) are stored as 0: after the
// ReLU every value is >= 0 and every pool window holds a real position, so
// max with 0 is exact. FP32 FFMA with FP32 accumulation throughout.

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kPY = 4;                 // pooled rows per block
constexpr int kPX = 8;                 // pooled columns per block
constexpr int kCR = 2 * kPY + 1;       // conv rows per block
constexpr int kCC = 2 * kPX + 1;       // conv columns per block
constexpr int kIR = 2 * (kCR - 1) + 7; // input rows per block
constexpr int kIC = 2 * (kCC - 1) + 7; // input columns per block
constexpr int kThreads = 192;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) stem_kernel(
    const float* __restrict__ x, const float* __restrict__ w192,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int H, int W, int Cin, int C) {
  extern __shared__ float smem[];
  float* ws = smem;                      // [7][7][Cin][C]
  float* xs = ws + 49 * Cin * C;         // [kIR][kIC][Cin]
  float* cs = xs + kIR * kIC * Cin;      // [kCR][kCC][C]

  const int tid = threadIdx.x;
  const int ho = (H + 1) / 2;
  const int wo = (W + 1) / 2;
  const int po = (ho + 1) / 2;
  const int qo = (wo + 1) / 2;
  const int n = blockIdx.z;
  const int py0 = blockIdx.y * kPY;
  const int px0 = blockIdx.x * kPX;

  for (int idx = tid; idx < 49 * Cin * C; idx += kThreads) {
    const int c = idx % C;
    const int t = idx / C;
    const int ci = t % Cin;
    const int rs = t / Cin;
    const int r = rs / 7;
    const int s = rs % 7;
    const int row = (((r / 2) * 4 + s / 2) * 4 + (r % 2) * 2 + s % 2) * Cin + ci;
    const float wv = w192[static_cast<size_t>(row) * C + c];
    ws[idx] = kBf16 ? round_bf16(wv) : wv;
  }
  // Conv row cy reads input rows 2*cy - 3 .. 2*cy + 3; this block's first
  // conv row is 2*py0 - 1.
  const int iy0 = 4 * py0 - 5;
  const int ix0 = 4 * px0 - 5;
  for (int idx = tid; idx < kIR * kIC * Cin; idx += kThreads) {
    const int ci = idx % Cin;
    const int t = idx / Cin;
    const int j = t % kIC;
    const int i = t / kIC;
    const int yy = iy0 + i;
    const int xx = ix0 + j;
    const float xv = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                         ? x[(static_cast<size_t>(n * H + yy) * W + xx) * Cin + ci]
                         : 0.f;
    xs[idx] = kBf16 ? round_bf16(xv) : xv;
  }
  __syncthreads();

  for (int item = tid; item < kCR * C; item += kThreads) {
    const int c = item % C;
    const int lr = item / C;
    using Acc = typename std::conditional<kBf16, double, float>::type;
    Acc acc[kCC];
#pragma unroll
    for (int j = 0; j < kCC; ++j) acc[j] = 0;
    for (int r = 0; r < 7; ++r)
      for (int s = 0; s < 7; ++s)
        for (int ci = 0; ci < Cin; ++ci) {
          const float wv = ws[((r * 7 + s) * Cin + ci) * C + c];
          const float* xr = xs + ((2 * lr + r) * kIC + s) * Cin + ci;
#pragma unroll
          for (int j = 0; j < kCC; ++j) {
            if constexpr (kBf16)
              acc[j] = fma(static_cast<double>(xr[2 * j * Cin]), static_cast<double>(wv), acc[j]);
            else
              acc[j] = fmaf(xr[2 * j * Cin], wv, acc[j]);
          }
        }
    const int cy = 2 * py0 - 1 + lr;
    const float sc = scale[c];
    const float bi = bias[c];
#pragma unroll
    for (int j = 0; j < kCC; ++j) {
      const int cx = 2 * px0 - 1 + j;
      const bool live = cy >= 0 && cy < ho && cx >= 0 && cx < wo;
      float y;
      if constexpr (kBf16)
        y = __fadd_rn(__fmul_rn(static_cast<float>(acc[j]), sc), bi);
      else
        y = acc[j] * sc + bi;
      cs[(lr * kCC + j) * C + c] = live ? fmaxf(y, 0.f) : 0.f;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < kPY * kPX * C; idx += kThreads) {
    const int c = idx % C;
    const int t = idx / C;
    const int lx = t % kPX;
    const int ly = t / kPX;
    const int py = py0 + ly;
    const int px = px0 + lx;
    if (py >= po || px >= qo) continue;
    float m = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        m = fmaxf(m, cs[((2 * ly + dr) * kCC + 2 * lx + dc) * C + c]);
    out[(static_cast<size_t>(n * po + py) * qo + px) * C + c] = m;
  }
}

}  // namespace

extern "C" int stem_conv7x7_bn_relu_maxpool(const float* x, const float* w192,
                                            const float* scale,
                                            const float* bias, float* out,
                                            int N, int H, int W, int Cin,
                                            int C, int bf16, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || C <= 0 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (49 * Cin * C + kIR * kIC * Cin + kCR * kCC * C);
  const auto kernel = bf16 ? &stem_kernel<true> : &stem_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int po = ((H + 1) / 2 + 1) / 2;
  const int qo = ((W + 1) / 2 + 1) / 2;
  const dim3 grid((qo + kPX - 1) / kPX, (po + kPY - 1) / kPY, N);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w192, scale, bias, out, H, W, Cin, C);
  return static_cast<int>(cudaGetLastError());
}
