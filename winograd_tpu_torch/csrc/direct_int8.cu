// Int8 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) as an implicit GEMM
// with per-im2col-row dynamic quantization: row p = (n, y, x) of the im2col
// matrix (K = 9 * Cin, k = (3r + s) * Cin + c, zero where the window leaves
// the map) gets its own scale over its 9 * Cin values, so one input pixel is
// quantized with a different scale for each output pixel that gathers it.
//
// Replaces: winograd_tpu/kernels/quantized.py::_direct_int8_kernel and
// ::_direct_int8_banded_kernel (conv3x3_bn_int8_pallas). The banded body is
// the same arithmetic cut into row bands to fit the TPU's scoped VMEM; here
// one kernel covers both. On the int8 ResNet-50 path it runs the projection
// block's 3x3 at 56x56x64, on the int8 ResNet-34 path conv5_x's entry b-leg
// at 7x7x512.
//
// Bound on the H100: bytes. At 7x7x512 the 0.12 G int8 MACs take 0.12 us
// at 1979 TOPS, the f32 map in and out and 2.4 MB of int8 weights 0.77 us
// at 3.35 TB/s; at 56x56x64, 0.49 us of f32 activations. But 49 rows give
// 8 output tiles of 64 x 64: a tile a block leaves 124 of 132 SMs idle, and
// each block's walk over K = 4608 is the time.
//
// Design: one cooperative launch of three phases on mma_int8.cuh.
// 1. Each im2col row's scale is computed once, by a group of warps reading
//    the row window by window, Cin contiguous, in float4s (a window's source
//    pixel is worked out when a thread's walk enters it, not per load);
//    the row is then quantized once into a (P, Kp) int8 workspace matrix
//    (Kp = K rounded up to 32, zero-padded). The same phase writes the weights k-contiguous,
//    (Cout, Kp), for the tensor cores' B operand. Grid barrier.
// 2. mma.sync s8 x s8 -> s32 on 64 x 64 tiles with cp.async stages, K split
//    so that tiles x splits reach about one wave of SMs; int32 partials to
//    the workspace. Grid barrier.
// 3. The splits' partials are added (exact in any order) and the
//    Int8BnEpilogue applied once per element: dequant and BN each rounded
//    in the plain twin's order, so kernel and twin agree to the bit.
// With one split, phase 2 applies the epilogue and phase 3 is skipped. The
// grid, the K split and the workspace's layout are the host's plan
// (kernels/quantized.py::direct_int8_plan); this entry checks it against
// the geometry compiled here and refuses one that does not fit.

#include "common.cuh"
#include "mma_int8.cuh"

namespace {

namespace s8 = wt::s8mma;

constexpr int kSplitStep = s8::kBK;

struct Args {
  const float* x;
  const int8_t* w9q;  // (K, Cout)
  const float* sw;
  const float* scale;
  const float* bias;
  float* out;
  unsigned int* bar;
  float* sx;    // P row scales
  int8_t* aq;   // (P, Kp) quantized im2col rows
  int8_t* bt;   // (Cout, Kp) weights, k-contiguous
  int* part;    // splits x P x Cout int32 partial sums
  int N, H, W, Cin, Cout, relu, Kp, splits, chunk;
};

template <bool kVec>
__global__ void __launch_bounds__(s8::kThreads) direct_int8_kernel(Args a) {
  __shared__ __align__(16) int8_t smem[s8::kSmemBytes];
  __shared__ float red[s8::kThreads / 32];
  const int P = a.N * a.H * a.W, K = 9 * a.Cin;
  s8::quantize_rows_phase(s8::Im2colRows<kVec>{a.x, a.H, a.W, a.Cin / 4}, P, K, a.Kp,
                          a.aq, a.sx, red);
  s8::transpose_phase(a.w9q, K, a.Cout, a.Kp, a.bt);
  wt::grid_sync(a.bar);
  s8::gemm_phase(a.aq, a.bt, a.sx, P, a.Cout, a.Kp, a.splits, a.chunk,
                 wt::Int8BnEpilogue{a.sw, a.scale, a.bias, a.out, a.Cout, a.relu}, a.part,
                 a.bar, smem);
}

// Blocks of the kernel the current device holds resident at once (a
// cooperative grid may not be larger); 0 on error.
int resident_blocks(const void* kernel, int vec) {
  static int cache[64][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev][vec] == 0) cache[dev][vec] = cooperative_grid(kernel, 0, s8::kThreads);
  return cache[dev][vec];
}

}  // namespace

// The host's plan (kernels/quantized.py::direct_int8_plan): Kp, K = 9 * Cin
// padded to a multiple of s8::kKAlign; `tile` the output tiles' width, which
// must be s8::kBM; a cooperative grid of `blocks` blocks, at most as many
// as the device holds resident; Kp in `splits` ranges of `chunk`, the last
// one shorter, chunk a multiple of kSplitStep when splits > 1. ws, ws_words
// 4-byte words: the grid barrier's two counters at word 0, then the P row
// scales at word sx, the (P, Kp) quantized rows at aq, the (Cout, Kp)
// transposed weights at bt and, past one split, the splits x P x Cout int32
// partial sums at part, in this order; aq, bt and part multiples of 4.
extern "C" int direct_int8_conv3x3_bn(const float* x, const int8_t* w9q, const float* sw,
                                      const float* scale, const float* bias, float* out,
                                      float* ws, long long ws_words, long long sx, long long aq,
                                      long long bt, long long part, int N, int H, int W,
                                      int Cin, int Cout, int relu, int Kp, int tile, int blocks,
                                      int splits, int chunk, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 4 != 0 || splits <= 0 ||
      chunk <= 0 || blocks <= 0 || tile != s8::kBM || Kp < 9 * Cin || Kp % s8::kKAlign != 0 ||
      static_cast<long long>(chunk) * splits < Kp ||
      static_cast<long long>(chunk) * (splits - 1) >= Kp ||
      (splits > 1 && chunk % kSplitStep != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long P = static_cast<long long>(N) * H * W;
  if (sx < 2 || aq < sx + P || bt < aq + P * Kp / 4 || part < bt + Cout * (Kp / 4LL) ||
      aq % 4 != 0 || bt % 4 != 0 || part % 4 != 0 ||
      ws_words < part + (splits > 1 ? splits * P * Cout : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const void* kernel = vec ? reinterpret_cast<const void*>(direct_int8_kernel<true>)
                           : reinterpret_cast<const void*>(direct_int8_kernel<false>);
  const int resident = resident_blocks(kernel, vec);
  if (resident <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{x, w9q, sw, scale, bias, out, bar,
         ws + sx, reinterpret_cast<int8_t*>(ws + aq), reinterpret_cast<int8_t*>(ws + bt),
         reinterpret_cast<int*>(ws + part), N, H, W, Cin, Cout, relu, Kp, splits, chunk};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(s8::kThreads), args, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
