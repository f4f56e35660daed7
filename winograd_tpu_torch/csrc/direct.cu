// Fused 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) as an implicit GEMM:
// out[(n,y,x), co] = sum_k im2col[(n,y,x), k] w9[k, co], k = (3r+s)*Cin + c.
//
// Replaces: winograd_tpu/kernels/direct.py::_direct_kernel
// (conv3x3_bn_direct_pallas). On the served paths it runs ResNet-50's two
// conv5_x identity 3x3s at 7x7x512 (the f32 route runs conv5_x per layer)
// and ResNet-34's conv5_x entry b-leg at 7x7x512.
//
// Bound on the H100: at 7x7x512, 231 MFLOP (three TF32 passes: 1.4 us at
// 495 TFLOP/s) on 9.4 MB of f32 weights (2.8 us at 3.35 TB/s): bytes. But
// 49 rows and 512 columns are 8 output tiles of 64 x 64: a kernel that gives
// each tile one block leaves 124 of 132 SMs idle, and each block's walk
// over K = 4608 alone is the time.
//
// Design: splitk_tf32.cuh's split-K MMA kernel, the pointwise kernel's, with
// A an implicit im2col. The 64 x 64 tiles run in 3xTF32 on the tensor cores
// (mma_tf32.cuh, FP32-level error), A and B staged by cp.async in a 4-deep
// ring; the im2col matrix is never written: a copy of A names the source
// pixel of its k (the window (r, s) = divmod(k / Cin, 3)) or zero-fills
// where the window leaves the map. Where Cin % 4 == 0 four consecutive k
// lie in one window and one pixel, so A moves in 16-byte copies; other Cin
// take the 4-byte copies. K is split over blocks by the host's plan
// (kernels/direct.py::direct_plan) until tiles x splits reach about two
// blocks an SM; the last block of a tile adds the splits' f32 partials in
// split order and applies BN (+ ReLU), so calls repeat to the bit. This
// entry checks the plan against the geometry compiled here.
//
// The bf16w tier (direct_conv3x3_bn_bf16w: w9 bf16, the JAX kernel at
// precision="bf16w", ResNet-34's conv5_x entry b-leg at bf16w) is the same
// kernel and plan on mma_bf16w.cuh's tile (wt::mma_tile by the weights'
// type): the implicit im2col split hi/lo into two bf16 m16n8k16 passes on
// the bf16 weights, 4.7 MB at 7x7x512 instead of 9.4.

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "splitk_tf32.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace sk = wt::splitk;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Both entries: check the plan, bind the workspace, launch. WT: the
// weights' element type (float, or __nv_bfloat16 at bf16w).
template <class WT>
int conv3x3_bn(const float* x, const WT* w9, const float* scale, const float* bias, float* out,
               float* ws, long long ws_words, long long part, int N, int H, int W, int Cin,
               int Cout, int relu, int tile, int splits, int chunk, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || tile != tc::kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = N * H * W, K = 9 * Cin;
  const int tiles = (P + tile - 1) / tile * ((Cout + tile - 1) / tile);
  if (!sk::plan_fits(P, K, Cout, tiles, splits, chunk, ws_words, part))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  sk::GemmArgs<WT> a{x, w9, scale, bias, out, nullptr, nullptr, P, K, Cout, relu, splits, chunk};
  cudaError_t e = sk::bind_workspace(a, ws, part, tiles, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const tc::Im2colA src{x, H, W, Cin, P};
  // 16-byte copies: Cin a multiple of 4, Cout of 4 floats or 8 bf16 values.
  constexpr int kVecCout = std::is_same_v<WT, float> ? 4 : 8;
  if (Cin % 4 == 0 && Cout % kVecCout == 0 && aligned16(x) && aligned16(w9) && aligned16(out))
    e = sk::launch_mma<true>(a, src, tiles, s);
  else
    e = sk::launch_mma<false>(a, src, tiles, s);
  return static_cast<int>(e);
}

}  // namespace

// The host's plan (kernels/direct.py::direct_plan): `tile` is the width of
// the output tiles and must be this library's (64); K = 9 * Cin in `splits`
// ranges of `chunk`, the last one shorter, chunk a multiple of
// sk::kSplitStep when splits > 1. ws (may be null at one split): one counter
// per output tile from word 0, the splits x P x Cout partial sums from word
// `part` (a multiple of 4), ws_words words in all.
extern "C" int direct_conv3x3_bn(const float* x, const float* w9, const float* scale,
                                 const float* bias, float* out, float* ws, long long ws_words,
                                 long long part, int N, int H, int W, int Cin, int Cout,
                                 int relu, int tile, int splits, int chunk, void* stream) {
  return conv3x3_bn(x, w9, scale, bias, out, ws, ws_words, part, N, H, W, Cin, Cout, relu, tile,
                    splits, chunk, stream);
}

// The bf16w tier: w9 (9 * Cin, Cout) bf16, the rest as direct_conv3x3_bn.
extern "C" int direct_conv3x3_bn_bf16w(const float* x, const __nv_bfloat16* w9,
                                       const float* scale, const float* bias, float* out,
                                       float* ws, long long ws_words, long long part, int N,
                                       int H, int W, int Cin, int Cout, int relu, int tile,
                                       int splits, int chunk, void* stream) {
  return conv3x3_bn(x, w9, scale, bias, out, ws, ws_words, part, N, H, W, Cin, Cout, relu, tile,
                    splits, chunk, stream);
}
