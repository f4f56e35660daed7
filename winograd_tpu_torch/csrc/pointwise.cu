// Fused 1x1 conv + folded BN (+ ReLU): out[P, N] = x[P, K] w[K, N] * scale + bias.
//
// Replaces: winograd_tpu/kernels/pointwise.py::_matmul_bn_kernel
// (conv1x1_bn_pallas). On the served paths it runs the 1x1 convs that no
// fused kernel holds (ResNet-50's conv2_x entry and conv5_x, ResNet-34's
// downsample projections), the stride-2 3x3s as GEMMs on a strided im2col
// (K up to 2304) and the head FC (P = N images, K = 2048 or 512, N = 1000).
//
// Bound on the H100: the served shapes are small. At P <= 196 the GEMM
// reads each weight a few times at most; the head (P = 1 or 8) streams
// 8.2 MB of weights for 2 MFLOP and is bound by those bytes (2.45 us at
// 3.35 TB/s). Their output tiles number 8 to 32, so a kernel that gives each
// tile one block and walks all of K alone leaves most of the 132 SMs idle
// and is bound by the latency of its one block's K loop.
//
// Design, two paths (the host's plan, kernels/pointwise.py::split_plan,
// picks one by P and the K split; this entry checks the plan against the
// geometry compiled here and refuses one that does not fit):
// * MMA (P > 8): 64 x 64 tiles of mma_tf32.cuh (3xTF32 on the tensor
//   cores, FP32-level error; cp.async stages in a 4-deep ring), with K
//   split over blocks until tiles x splits reach about one wave of SMs.
// * GEMV (P <= kGemvMaxP): the block owns 128 columns and a K range; each
//   warp streams whole 512-byte rows of w with 16-byte loads, the rows of x
//   sit in shared memory, and the warps' sums meet in shared memory in
//   warp order. Splits fill about one block per SM.
// Both add their K splits' partial sums as splitk_tf32.cuh does: in split
// order, by the last block of a tile, so the same inputs give the same bits
// on every call.

#include <stdint.h>

#include "common.cuh"
#include "splitk_tf32.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace sk = wt::splitk;
using sk::Args;

constexpr int kGemvMaxP = 8;      // rows the GEMV's registers and shared arrays hold
constexpr int kGemvCols = 128;    // columns a GEMV block owns
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvXChunk = 256;

// Four adjacent weights of row k from column n on (zero past N).
template <bool kVec>
__device__ __forceinline__ float4 weights4(const Args& a, int k, int n) {
  const float* row = a.w + static_cast<size_t>(k) * a.N;
  if (kVec) return n < a.N ? __ldg(reinterpret_cast<const float4*>(row + n)) : float4{};
  float4 v;
  v.x = n < a.N ? __ldg(row + n) : 0.f;
  v.y = n + 1 < a.N ? __ldg(row + n + 1) : 0.f;
  v.z = n + 2 < a.N ? __ldg(row + n + 2) : 0.f;
  v.w = n + 3 < a.N ? __ldg(row + n + 3) : 0.f;
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kGemvThreads) pointwise_gemv_kernel(Args a) {
  __shared__ float xs[kGemvMaxP][kGemvXChunk];
  __shared__ float red[kGemvWarps][kGemvMaxP][kGemvCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kGemvCols, split = blockIdx.y;
  const int k0 = split * a.chunk, k1 = min(a.K, k0 + a.chunk);
  const int n = n0 + lane * 4;

  float acc[kGemvMaxP][4];
#pragma unroll
  for (int p = 0; p < kGemvMaxP; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  for (int kc = k0; kc < k1; kc += kGemvXChunk) {
    const int len = min(kGemvXChunk, k1 - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < a.P * kGemvXChunk; i += kGemvThreads) {
      const int p = i / kGemvXChunk, kk = i % kGemvXChunk;
      xs[p][kk] = kk < len ? __ldg(a.x + static_cast<size_t>(p) * a.K + kc + kk) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = warp; kk < len; kk += kGemvWarps) {
      const float4 wv = weights4<kVec>(a, kc + kk, n);
#pragma unroll
      for (int p = 0; p < kGemvMaxP; ++p) {
        if (p < a.P) {
          const float xv = xs[p][kk];
          acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
          acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
          acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
          acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kGemvMaxP; ++p)
    if (p < a.P)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][p][lane * 4 + j] = acc[p][j];
  __syncthreads();

  float* part = a.part + static_cast<size_t>(split) * a.P * a.N;
  for (int i = threadIdx.x; i < a.P * kGemvCols; i += kGemvThreads) {
    const int p = i / kGemvCols, c = i % kGemvCols;
    if (n0 + c >= a.N) continue;
    float s = red[0][p][c];
#pragma unroll
    for (int wv = 1; wv < kGemvWarps; ++wv) s += red[wv][p][c];
    const size_t at = static_cast<size_t>(p) * a.N + n0 + c;
    if (a.splits == 1)
      a.out[at] = sk::bn(a, n0 + c, s);
    else
      part[at] = s;
  }
  if (a.splits == 1 || !sk::arrive_last(a, blockIdx.x)) return;
  sk::reduce_splits<float, kGemvMaxP * kGemvCols / kGemvThreads, 8, kGemvThreads>(
      a, 0, n0, a.P * kGemvCols, kGemvCols, 1);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The host's plan (kernels/pointwise.py::split_plan): `gemv` picks the path,
// `tile` is the width of its output tiles and must be this library's
// (kGemvCols for the GEMV, 64 for the MMA tiles; the GEMV takes at most
// kGemvMaxP rows); K in `splits` ranges of `chunk`, the last one shorter,
// chunk a multiple of sk::kSplitStep when splits > 1. ws (may be null at one
// split): one counter per output tile from word 0, the splits x P x N
// partial sums from word `part` (a multiple of 4), ws_words words in all.
extern "C" int pointwise_conv1x1_bn(const float* x, const float* w, const float* scale,
                                    const float* bias, float* out, float* ws, long long ws_words,
                                    long long part, int P, int K, int N, int relu, int gemv,
                                    int tile, int splits, int chunk, void* stream) {
  if (tile != (gemv ? kGemvCols : tc::kBM) || (gemv && P > kGemvMaxP))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_n = (N + tile - 1) / tile;
  const int tiles = gemv ? tiles_n : (P + tile - 1) / tile * tiles_n;
  if (!sk::plan_fits(P, K, N, tiles, splits, chunk, ws_words, part))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  Args a{x, w, scale, bias, out, nullptr, nullptr, P, K, N, relu, splits, chunk};
  cudaError_t e = sk::bind_workspace(a, ws, part, tiles, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (gemv) {
    const dim3 grid(tiles, splits);
    if (N % 4 == 0 && aligned16(w))
      pointwise_gemv_kernel<true><<<grid, kGemvThreads, 0, s>>>(a);
    else
      pointwise_gemv_kernel<false><<<grid, kGemvThreads, 0, s>>>(a);
    e = cudaGetLastError();
  } else {
    const tc::RowMajorA src{x, P, K};
    if (K % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(out))
      e = sk::launch_mma<true>(a, src, tiles, s);
    else
      e = sk::launch_mma<false>(a, src, tiles, s);
  }
  return static_cast<int>(e);
}
