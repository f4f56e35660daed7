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
// * GEMV (P <= kGemvMaxP, the heads): gemv_cluster.cuh's form. A block
//   owns a column tile of 128 or 64 columns (the plan's) and a range of K;
//   one warp asks for its whole weight slab by 1D bulk copies onto the
//   ring's mbarriers at the start (64 KB a block at the R-50 head); the
//   rows of x sit in shared memory, each thread multiplies four columns of
//   its rows by FMA from shared memory, and the row groups' sums meet in
//   shared memory in group order. The K splits of a column tile are the
//   blocks of one cluster (a power of two of them, at most 16 under the
//   non-portable opt-in), which push their partial sums through
//   distributed shared memory to the block that owns each; after one
//   cluster barrier the owners add them in rank order and apply BN and
//   ReLU: no workspace, no counter, no memset, no atomics.
// Both paths add their K splits in a fixed order, so the same inputs give
// the same bits on every call.
//
// The bf16w tier (pointwise_conv1x1_bn_bf16w: bf16 weights, the JAX
// kernel at precision="bf16w") runs the same plan on the same two paths:
// the MMA tiles are wgmma_tile.cuh's bf16 ones (the f32 activation split
// hi/lo, two bf16 wgmma passes on the weights read straight from the TMA's
// swizzled box), and the GEMV stages a_hi + a_lo (exact in f32), reads four
// bf16 weights (8 bytes) a thread a row and adds both exact products with
// one FMA. Its weight bytes, which bound the head, are half the f32 tier's.

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "gemv_cluster.cuh"
#include "wgmma_cluster.cuh"
#include "wgmma_tile.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace gv = wt::gemv;
namespace wg = wt::wg;
namespace wgc = wt::wgc;
using bf16 = __nv_bfloat16;

constexpr int kGemvMaxP = gv::kMaxP;  // rows the GEMV's registers and shared arrays hold
constexpr int kGemvCols = 128;        // columns of a GEMV block's tile: this or half of it
constexpr int kGemvXChunk = 512;      // k of x staged in shared memory at a time

// The GEMV's operands and plan; BT: the weights' element type (float, or
// __nv_bfloat16 at bf16w).
template <class BT>
struct GemvArgs {
  const float* x;
  const BT* w;
  const float* scale;
  const float* bias;
  float* out;
  int P, K, N, relu, splits, chunk;
};

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// Four adjacent weights from a row in shared memory (16 bytes of f32, or 8
// of bf16 widened exactly to f32).
__device__ __forceinline__ float4 weights4(const float*, const unsigned char* row) {
  return *reinterpret_cast<const float4*>(row);
}
__device__ __forceinline__ float4 weights4(const bf16*, const unsigned char* row) {
  const uint2 u = *reinterpret_cast<const uint2*>(row);
  return make_float4(bf16_bits(u.x & 0xffffu), bf16_bits(u.x >> 16), bf16_bits(u.y & 0xffffu),
                     bf16_bits(u.y >> 16));
}

// The same from row k of the (K, N) weights in device memory, element by
// element, zero past N (the shapes bulk copies cannot read).
template <class BT>
__device__ __forceinline__ float4 weights4(const BT* w, int N, int k, int n) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (n + j >= N) {
      v[j] = 0.f;
    } else if constexpr (std::is_same_v<BT, bf16>) {
      v[j] = bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(w) +
                             static_cast<size_t>(k) * N + n + j));
    } else {
      v[j] = __ldg(w + static_cast<size_t>(k) * N + n + j);
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// An x value as the GEMV stages it: as it is, or for bf16 weights a_hi +
// a_lo, its bf16 halves a_hi = bf16(x) and a_lo = bf16(x - a_hi) summed.
// That sum has at most 17 significant bits, so it is exact in f32, and one
// fmaf(a_hi + a_lo, w, acc) rounds acc + a_hi * w + a_lo * w once: the two
// bf16w products, exact, in one FMA. The split is made once a value here,
// not by each thread that reads it.
template <class BT>
__device__ __forceinline__ float stage_x(float v) {
  if constexpr (std::is_same_v<BT, bf16>) {
    const float hi = __bfloat162float(__float2bfloat16_rn(v));
    return hi + __bfloat162float(__float2bfloat16_rn(v - hi));
  } else {
    return v;
  }
}

// One block per (column tile, split), grid (tiles, splits), the splits of a
// tile one cluster (a block's rank is its split). kVec: the weights'
// rows by bulk copies (gv::bulk_rows); kCols: the tile's columns, 128 or
// 64. Thread t multiplies columns 4 (t % (kCols / 4)) .. +3 of rows g, g +
// kGroups, ... of each stage, g = t / (kCols / 4).
template <bool kVec, int kCols, class BT>
__global__ void __launch_bounds__(gv::kThreads)
    pointwise_gemv(const __grid_constant__ GemvArgs<BT> a) {
  using Slab = gv::Slab<kCols, sizeof(BT)>;
  constexpr int kTpr = kCols / 4;
  constexpr int kGroups = gv::kThreads / kTpr;
  static_assert(Slab::kSmemBytes >= sizeof(float) * kGroups * kGemvMaxP * kCols,
                "the idle ring holds the row groups' sums");
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[gv::kStages];
  __shared__ float xs[kGemvMaxP][kGemvXChunk];
  __shared__ float recv[kGemvMaxP * kCols + gv::kClusterMax];  // this block's share, by split
  const int t = threadIdx.x, g = t / kTpr, c = 4 * (t % kTpr);
  const int n0 = blockIdx.x * kCols, split = blockIdx.y;
  const int k0 = split * a.chunk, k1 = min(a.K, k0 + a.chunk);
  const Slab slab{reinterpret_cast<const unsigned char*>(a.w), ring, bars, a.N, n0, k0, k1};
  wt::cluster_arrive_relaxed();  // this block has started (waited for before the pushes)
  if (kVec) slab.begin();
  // The BN of the sums this block will own after the cluster barrier, read
  // while the weights stream in.
  constexpr int kOwn = (kGemvMaxP * kCols + gv::kThreads - 1) / gv::kThreads;
  const int count = a.P * kCols, per = gv::share(count, a.splits);
  float own_s[kOwn], own_b[kOwn];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int j = t + u * gv::kThreads, n = n0 + (split * per + j) % kCols;
    const bool ok = j < per && split * per + j < count && n < a.N;
    own_s[u] = ok ? __ldg(a.scale + n) : 0.f;
    own_b[u] = ok ? __ldg(a.bias + n) : 0.f;
  }

  float acc[kGemvMaxP][4];
#pragma unroll
  for (int p = 0; p < kGemvMaxP; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;
  int xk = k0;  // the k of xs[.][0]
  gv::walk<kVec, kGemvXChunk>(
      slab,
      [&](int kc, int len) {
        xk = kc;
        for (int i = t; i < a.P * len; i += gv::kThreads) {
          const int p = i / len, kk = i - p * len;
          xs[p][kk] = stage_x<BT>(__ldg(a.x + static_cast<size_t>(p) * a.K + kc + kk));
        }
      },
      [&](int s, int r0, int rows) {
#pragma unroll 4
        for (int r = g; r < rows; r += kGroups) {
          const float4 wv = kVec ? weights4(a.w, slab.row(s, r) + c * sizeof(BT))
                                 : weights4(a.w, a.N, r0 + r, n0 + c);
          const int kx = r0 + r - xk;
#pragma unroll
          for (int p = 0; p < kGemvMaxP; ++p) {
            if (p < a.P) {
              const float xv = xs[p][kx];
              acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
              acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
              acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
              acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
            }
          }
        }
      });

  // The row groups' sums meet in the idle ring, then add in group order.
  float* red = reinterpret_cast<float*>(ring);  // [kGroups][kGemvMaxP][kCols]
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kGemvMaxP; ++p)
    if (p < a.P)
      *reinterpret_cast<float4*>(red + (g * kGemvMaxP + p) * kCols + c) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  __syncthreads();
  wt::cluster_wait();  // every block of the cluster has started
  for (int i = t; i < count; i += gv::kThreads) {
    const int p = i / kCols, cc = i % kCols;
    float sum = red[p * kCols + cc];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) sum += red[(q * kGemvMaxP + p) * kCols + cc];
    gv::push(recv, i, per, split, sum);
  }
  // This block's share of the tile's sums, over the cluster's blocks in
  // rank order, through BN (+ ReLU).
  wt::cluster_sync();
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int j = t + u * gv::kThreads, i = split * per + j, p = i / kCols, n = n0 + i % kCols;
    if (j >= per || i >= count || n >= a.N) continue;
    const float y = gv::gather(recv, j, per, a.splits) * own_s[u] + own_b[u];
    a.out[static_cast<size_t>(p) * a.N + n] = a.relu ? wt::relu(y) : y;
  }
}

// The GEMV at kCols columns a tile; clusters: as gv::launch takes it.
template <int kCols, class BT>
cudaError_t gemv(const GemvArgs<BT>& a, bool vec, cudaStream_t s, int* clusters = nullptr) {
  constexpr size_t kSmem = gv::Slab<kCols, sizeof(BT)>::kSmemBytes;
  const int tiles = (a.N + kCols - 1) / kCols;
  return vec ? gv::launch<&pointwise_gemv<true, kCols, BT>>(a, tiles, a.splits, kSmem, s, clusters)
             : gv::launch<&pointwise_gemv<false, kCols, BT>>(a, tiles, a.splits, kSmem, s,
                                                             clusters);
}

// The GEMV under the plan's tile width (kGemvCols or half of it).
template <class BT>
cudaError_t run_gemv(const GemvArgs<BT>& a, int tile, cudaStream_t s, int* clusters = nullptr) {
  const bool vec = gv::bulk_rows(a.w, a.K, a.N, sizeof(BT));
  return tile == kGemvCols ? gemv<kGemvCols>(a, vec, s, clusters)
                           : gemv<kGemvCols / 2>(a, vec, s, clusters);
}

using wgc::aligned16;

// Both entries: check the plan, launch the plan's path (the MMA path's
// weight map encoded here).
template <class BT>
int conv1x1_bn(const float* x, const BT* w, const float* scale, const float* bias, float* out,
               int P, int K, int N, int relu, int gemv, int tile, int splits, int chunk,
               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (gemv) {
    if ((tile != kGemvCols && tile != kGemvCols / 2) ||
        !gv::plan_fits(P, K, N, splits, chunk))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        run_gemv(GemvArgs<BT>{x, w, scale, bias, out, P, K, N, relu, splits, chunk}, tile, s));
  }
  if (tile != wg::kBM) return static_cast<int>(cudaErrorInvalidValue);
  // K in `splits` ranges of `chunk` (the last shorter, each but the last
  // a multiple of the tile's stage), the splits of a tile one cluster.
  wgc::Args<BT> a{{}, w, scale, bias, out, P, K, N, relu, splits, chunk};
  return static_cast<int>(
      wgc::run<wgc::kClusterPortable>(a, tc::RowMajorA{x, P, K}, K % 4 == 0 && aligned16(x), s));
}

}  // namespace

// The host's plan (kernels/pointwise.py::split_plan): `gemv` picks the path,
// `tile` is the width of its output tiles (kGemvCols or half of it for the
// GEMV, which takes at most kGemvMaxP rows; 64 for the MMA tiles); K in
// `splits` ranges of `chunk`, the last one shorter, chunk a multiple of
// the 32-deep stage when splits > 1: on the GEMV a power of two of splits,
// at most gv::kClusterMax; on the MMA path at most wgc::kClusterPortable.
// Neither path takes a workspace.
extern "C" int pointwise_conv1x1_bn(const float* x, const float* w, const float* scale,
                                    const float* bias, float* out, int P, int K, int N, int relu,
                                    int gemv, int tile, int splits, int chunk, void* stream) {
  return conv1x1_bn(x, w, scale, bias, out, P, K, N, relu, gemv, tile, splits, chunk, stream);
}

// The bf16w tier: w (K, N) bf16, the rest as pointwise_conv1x1_bn.
extern "C" int pointwise_conv1x1_bn_bf16w(const float* x, const bf16* w, const float* scale,
                                          const float* bias, float* out, int P, int K, int N,
                                          int relu, int gemv, int tile, int splits, int chunk,
                                          void* stream) {
  return conv1x1_bn(x, w, scale, bias, out, P, K, N, relu, gemv, tile, splits, chunk, stream);
}

// The clusters of the GEMV's served instantiation (bulk copies; bf16 weights
// where bf16w) of `tile` columns and `splits` blocks that the current device
// holds at once, into *clusters (the plan asks before it takes more than a
// portable cluster).
extern "C" int pointwise_gemv_clusters(int bf16w, int tile, int splits, int* clusters) {
  if ((tile != kGemvCols && tile != kGemvCols / 2) || splits <= 0 ||
      splits > gv::kClusterMax || (splits & (splits - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *clusters = 0;
  if (bf16w) {
    const GemvArgs<bf16> a{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 4, 4, 0, splits, 4};
    return static_cast<int>(run_gemv(a, tile, nullptr, clusters));
  }
  const GemvArgs<float> a{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 4, 4, 0, splits, 4};
  return static_cast<int>(run_gemv(a, tile, nullptr, clusters));
}
