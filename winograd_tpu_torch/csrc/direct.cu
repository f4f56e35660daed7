// Fused 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) as an implicit GEMM:
// out[(n,y,x), co] = sum_k im2col[(n,y,x), k] w9[k, co], k = (3r+s)*Cin + c.
//
// Replaces: winograd_tpu/kernels/direct.py::_direct_kernel
// (conv3x3_bn_direct_pallas). On the served paths it runs ResNet-50's two
// conv5_x identity 3x3s at 7x7x512 (the f32 route runs conv5_x per layer),
// ResNet-34's conv5_x entry b-leg at 7x7x512, and the train steps' 3x3 data
// gradients (56x56x64 up to 7x7x512).
//
// Bound on the H100: at 7x7x512, 231 MFLOP (three TF32 passes: 1.4 us at
// 495 TFLOP/s) on 9.4 MB of f32 weights (2.8 us at 3.35 TB/s): bytes. But
// 49 rows and 512 columns are 8 output tiles of 64 x 64: a kernel that gives
// each tile one block leaves 124 of 132 SMs idle, and each block's walk
// over K = 4608 alone is the time.
//
// Design: wgmma_cluster.cuh's one-launch GEMM, the pointwise kernel's MMA
// path, with A the implicit im2col (mma_tf32.cuh::Im2colA<1>): 64 x 64
// wgmma tiles in 3xTF32 (FP32-level error, each 32-deep stage's products
// promoted in FP32), the weights (9 Cin, Cout) by TMA onto mbarriers, A by
// cp.async; the im2col matrix is never written: a copy of A names the
// source pixel of its k (the window (r, s) = divmod(k / Cin, 3)) or
// zero-fills where the window leaves the map. Where Cin % 4 == 0 four
// consecutive k lie in one window and one pixel, so A moves in 16-byte
// copies (the kVec route, with the TMA weights); other shapes take the
// element route. K is split by the host's plan (kernels/direct.py::
// direct_plan: enough ranges to fill the card and to keep each block's walk
// short, a power of two of them) into at most wgc::kClusterMax = 16 ranges,
// the splits of a tile one thread-block cluster (past 8 a non-portable one)
// adding their partials in rank order through distributed shared memory:
// one launch, no workspace, no counters, no memset, and calls repeat to the
// bit. At N=1 the 8 output tiles of 7x7x512 run as 128 blocks. This entry
// checks the plan against the geometry compiled here.
//
// The bf16w tier (direct_conv3x3_bn_bf16w: w9 bf16, the JAX kernel at
// precision="bf16w", ResNet-34's conv5_x entry b-leg at bf16w) is the same
// kernel and plan on wgmma_tile.cuh's bf16 tile: the implicit im2col split
// hi/lo into two bf16 wgmma passes on the bf16 weights, 4.7 MB at 7x7x512
// instead of 9.4.

#include <cuda_bf16.h>

#include "common.cuh"
#include "mma_tf32.cuh"
#include "wgmma_cluster.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace wgc = wt::wgc;

// Both entries: check the plan, launch. WT: the weights' element type
// (float, or __nv_bfloat16 at bf16w).
template <class WT>
int conv3x3_bn(const float* x, const WT* w9, const float* scale, const float* bias, float* out,
               int N, int H, int W, int Cin, int Cout, int relu, int tile, int splits, int chunk,
               void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || tile != wt::wg::kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = N * H * W;
  wgc::Args<WT> a{{}, w9, scale, bias, out, P, 9 * Cin, Cout, relu, splits, chunk};
  const cudaError_t e = wgc::run<wgc::kClusterMax>(a, tc::Im2colA<1>{x, H, W, Cin, P},
                                                   Cin % 4 == 0 && wgc::aligned16(x),
                                                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

}  // namespace

// The host's plan (kernels/direct.py::direct_plan): `tile` is the width of
// the output tiles and must be this library's (64); K = 9 * Cin in `splits`
// ranges of `chunk`, the last one shorter, chunk a multiple of the tile's
// 32-deep stage when splits > 1, at most wgc::kClusterMax splits.
extern "C" int direct_conv3x3_bn(const float* x, const float* w9, const float* scale,
                                 const float* bias, float* out, int N, int H, int W, int Cin,
                                 int Cout, int relu, int tile, int splits, int chunk,
                                 void* stream) {
  return conv3x3_bn(x, w9, scale, bias, out, N, H, W, Cin, Cout, relu, tile, splits, chunk,
                    stream);
}

// The bf16w tier: w9 (9 * Cin, Cout) bf16, the rest as direct_conv3x3_bn.
extern "C" int direct_conv3x3_bn_bf16w(const float* x, const __nv_bfloat16* w9,
                                       const float* scale, const float* bias, float* out, int N,
                                       int H, int W, int Cin, int Cout, int relu, int tile,
                                       int splits, int chunk, void* stream) {
  return conv3x3_bn(x, w9, scale, bias, out, N, H, W, Cin, Cout, relu, tile, splits, chunk,
                    stream);
}
