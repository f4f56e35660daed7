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
// * MMA (P > 8): wgmma_cluster.cuh's one-launch GEMM (shared with
//   csrc/direct.cu) on A = x row-major: 64 x 64 tiles of wgmma_tile.cuh
//   (wgmma on one warpgroup, 3xTF32, FP32-level error; the weight tiles by
//   TMA onto mbarriers, A by cp.async, a 4-deep ring), with K split until
//   tiles x splits reach about one wave of SMs, at most 8 ways (a portable
//   cluster).
//   The K splits of one output tile are the blocks of one thread-block
//   cluster (cluster dims (1, splits, 1)): each leaves its partial tile in
//   its shared memory, and after a cluster barrier block r adds rows
//   r * 64 / splits .. of every block's partial through distributed shared
//   memory, in rank order 0, 1, ..., and applies BN and ReLU. No partial
//   reaches device memory, no counter, no memset before the launch.
// * GEMV (P <= kGemvMaxP): the block owns 128 columns and a K range; each
//   warp streams whole 512-byte rows of w with 16-byte loads, the rows of x
//   sit in shared memory, and the warps' sums meet in shared memory in
//   warp order. Splits fill about one block per SM; their partial sums go
//   to a workspace and the last block of a column tile adds them in split
//   order (splitk_tf32.cuh's reduction, its counters zeroed before the
//   launch).
// Both paths add their K splits in a fixed order, so the same inputs give
// the same bits on every call.
//
// The bf16w tier (pointwise_conv1x1_bn_bf16w: bf16 weights, the JAX
// kernel at precision="bf16w") runs the same plan on the same two paths:
// the MMA tiles are wgmma_tile.cuh's bf16 ones (the f32 activation split
// hi/lo, two bf16 wgmma passes on the weights read straight from the TMA's
// swizzled box), and the GEMV stages a_hi + a_lo (exact in f32), reads four
// bf16 weights (8 bytes) a lane a row and adds both exact products with
// one FMA. Its weight bytes, which bound the head, are half the f32 tier's.

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "splitk_tf32.cuh"
#include "wgmma_cluster.cuh"
#include "wgmma_tile.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace sk = wt::splitk;
namespace wg = wt::wg;
namespace wgc = wt::wgc;
using sk::Args;
using sk::GemmArgs;
using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// The same of bf16 weights, widened exactly to f32; kVec: one 8-byte load.
template <bool kVec>
__device__ __forceinline__ float4 weights4(const GemmArgs<bf16>& a, int k, int n) {
  const auto* row = reinterpret_cast<const unsigned short*>(a.w) + static_cast<size_t>(k) * a.N;
  if (kVec) {
    if (n >= a.N) return float4{};
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + n));
    return make_float4(bf16_bits(u.x & 0xffffu), bf16_bits(u.x >> 16), bf16_bits(u.y & 0xffffu),
                       bf16_bits(u.y >> 16));
  }
  float4 v;
  v.x = n < a.N ? bf16_bits(__ldg(row + n)) : 0.f;
  v.y = n + 1 < a.N ? bf16_bits(__ldg(row + n + 1)) : 0.f;
  v.z = n + 2 < a.N ? bf16_bits(__ldg(row + n + 2)) : 0.f;
  v.w = n + 3 < a.N ? bf16_bits(__ldg(row + n + 3)) : 0.f;
  return v;
}

// An x value as the GEMV stages it: as it is, or for bf16 weights a_hi +
// a_lo, its bf16 halves a_hi = bf16(x) and a_lo = bf16(x - a_hi) summed.
// That sum has at most 17 significant bits, so it is exact in f32, and one
// fmaf(a_hi + a_lo, w, acc) rounds acc + a_hi * w + a_lo * w once: the two
// bf16w products, exact, in one FMA. The split is made once a value here,
// not by each of the 32 lanes that read it.
template <class BT>
__device__ __forceinline__ float stage_x(float v) {
  if constexpr (std::is_same_v<BT, bf16>) {
    const float hi = __bfloat162float(__float2bfloat16_rn(v));
    return hi + __bfloat162float(__float2bfloat16_rn(v - hi));
  } else {
    return v;
  }
}

template <bool kVec, class BT>
__global__ void __launch_bounds__(kGemvThreads) pointwise_gemv_kernel(GemmArgs<BT> a) {
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
      xs[p][kk] = kk < len ? stage_x<BT>(__ldg(a.x + static_cast<size_t>(p) * a.K + kc + kk)) : 0.f;
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

using wgc::aligned16;
bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

// Both entries: check the plan, bind the GEMV's workspace or encode the
// MMA path's weight map, launch the plan's path.
template <class BT>
int conv1x1_bn(const float* x, const BT* w, const float* scale, const float* bias, float* out,
               float* ws, long long ws_words, long long part, int P, int K, int N, int relu,
               int gemv, int tile, int splits, int chunk, void* stream) {
  constexpr bool kBf16 = std::is_same_v<BT, bf16>;
  if (tile != (gemv ? kGemvCols : wg::kBM) || (gemv && P > kGemvMaxP))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_n = (N + tile - 1) / tile;
  const int tiles = gemv ? tiles_n : (P + tile - 1) / tile * tiles_n;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (gemv) {
    if (!sk::plan_fits(P, K, N, tiles, splits, chunk, ws_words, part))
      return static_cast<int>(cudaErrorInvalidValue);
    GemmArgs<BT> a{x, w, scale, bias, out, nullptr, nullptr, P, K, N, relu, splits, chunk};
    e = sk::bind_workspace(a, ws, part, tiles, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(tiles, splits);
    if (N % 4 == 0 && (kBf16 ? aligned8(w) : aligned16(w)))
      pointwise_gemv_kernel<true, BT><<<grid, kGemvThreads, 0, s>>>(a);
    else
      pointwise_gemv_kernel<false, BT><<<grid, kGemvThreads, 0, s>>>(a);
    e = cudaGetLastError();
  } else {
    // K in `splits` ranges of `chunk` (the last shorter, each but the last
    // a multiple of the tile's stage), the splits of a tile one cluster.
    wgc::Args<BT> a{{}, w, scale, bias, out, P, K, N, relu, splits, chunk};
    e = wgc::run<wgc::kClusterPortable>(a, tc::RowMajorA{x, P, K}, K % 4 == 0 && aligned16(x),
                                        s);
  }
  return static_cast<int>(e);
}

}  // namespace

// The host's plan (kernels/pointwise.py::split_plan): `gemv` picks the path,
// `tile` is the width of its output tiles and must be this library's
// (kGemvCols for the GEMV, 64 for the MMA tiles; the GEMV takes at most
// kGemvMaxP rows); K in `splits` ranges of `chunk`, the last one shorter,
// chunk a multiple of the 32-deep stage when splits > 1, at most
// wgc::kClusterPortable splits on the MMA path. ws: the GEMV's, past one split (may
// be null otherwise): one counter per output tile from word 0, the splits x
// P x N partial sums from word `part` (a multiple of 4), ws_words words in
// all; the MMA path takes none.
extern "C" int pointwise_conv1x1_bn(const float* x, const float* w, const float* scale,
                                    const float* bias, float* out, float* ws, long long ws_words,
                                    long long part, int P, int K, int N, int relu, int gemv,
                                    int tile, int splits, int chunk, void* stream) {
  return conv1x1_bn(x, w, scale, bias, out, ws, ws_words, part, P, K, N, relu, gemv, tile, splits,
                    chunk, stream);
}

// The bf16w tier: w (K, N) bf16, the rest as pointwise_conv1x1_bn.
extern "C" int pointwise_conv1x1_bn_bf16w(const float* x, const bf16* w, const float* scale,
                                          const float* bias, float* out, float* ws,
                                          long long ws_words, long long part, int P, int K, int N,
                                          int relu, int gemv, int tile, int splits, int chunk,
                                          void* stream) {
  return conv1x1_bn(x, w, scale, bias, out, ws, ws_words, part, P, K, N, relu, gemv, tile, splits,
                    chunk, stream);
}
