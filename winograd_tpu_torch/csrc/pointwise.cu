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
// With one split the block applies the epilogue itself. With several, each
// writes its f32 partial tile to the workspace (splits x P x N) and counts
// itself in at its tile's counter (at the workspace's start, zeroed by this
// entry before the launch); the last block of a tile to arrive adds the
// partials in split order 0, 1, ..., S-1 and applies BN and ReLU once.
// Which block is last varies; the order of the sum does not, so the same
// inputs give the same bits on every call. Nothing is allocated and nothing copied to or from the host,
// so the launch can be captured in a CUDA graph.

#include <stdint.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

namespace tc = wt::tf32x3;

constexpr int kGemvMaxP = 8;      // rows the GEMV's registers and shared arrays hold
constexpr int kGemvCols = 128;    // columns a GEMV block owns
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvXChunk = 256;
constexpr int kSplitStep = tc::kBK;  // every split but the last is a multiple of this
static_assert(tc::kBM == tc::kBN, "the plan names one MMA tile width");

struct Args {
  const float* x;
  const float* w;
  const float* scale;
  const float* bias;
  float* out;
  unsigned int* counters;  // one per output tile
  float* part;             // splits x P x N
  int P, K, N, relu, splits, chunk;
};

__device__ __forceinline__ float bn(const Args& a, int n, float acc) {
  const float y = acc * a.scale[n] + a.bias[n];
  return a.relu ? fmaxf(y, 0.f) : y;
}

// After this block wrote its partial sums: true for the last block of
// `tile` to arrive, which then sees every other block's partials.
__device__ __forceinline__ bool arrive_last(const Args& a, int tile) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counters + tile, 1u) == a.splits - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ void load_cg(const float* p, float& v) { v = __ldcg(p); }
__device__ __forceinline__ void load_cg(const float* p, float4& v) {
  v = __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void add(float& s, float v) { s += v; }
__device__ __forceinline__ void add(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}
__device__ __forceinline__ void store_bn(const Args& a, size_t at, int n, float v) {
  a.out[at] = bn(a, n, v);
}
__device__ __forceinline__ void store_bn(const Args& a, size_t at, int n, const float4& v) {
  *reinterpret_cast<float4*>(a.out + at) =
      make_float4(bn(a, n, v.x), bn(a, n + 1, v.y), bn(a, n + 2, v.z), bn(a, n + 3, v.w));
}

// out = BN(part[0] + part[1] + ... + part[splits - 1]) over the block's
// positions: kPer positions a thread, position i at row i / cols and
// column (i % cols) * width of the tile at (p0, n0), `width` = 1 or 4
// adjacent columns (T = float or float4). The loads of kUnroll splits for
// all kPer positions are in flight together; each element still adds its
// splits one by one in split order.
template <class T, int kPer, int kUnroll, int kThreadsPerBlock>
__device__ __forceinline__ void reduce_splits(const Args& a, int p0, int n0, int positions,
                                              int cols, int width) {
  const size_t pn = static_cast<size_t>(a.P) * a.N;
  for (int base = threadIdx.x; base < positions; base += kPer * kThreadsPerBlock) {
    size_t at[kPer];
    int col[kPer];
    bool ok[kPer];
    T s[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = base + j * kThreadsPerBlock;
      const int p = p0 + i / cols;
      col[j] = n0 + i % cols * width;
      ok[j] = i < positions && p < a.P && col[j] < a.N;
      at[j] = static_cast<size_t>(p) * a.N + col[j];
      if (ok[j]) load_cg(a.part + at[j], s[j]);
    }
    for (int k = 1; k < a.splits; k += kUnroll) {
      T v[kUnroll][kPer];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (ok[j] && k + u < a.splits) load_cg(a.part + (k + u) * pn + at[j], v[u][j]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (ok[j] && k + u < a.splits) add(s[j], v[u][j]);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (ok[j]) store_bn(a, at[j], col[j], s[j]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(tc::kThreads) pointwise_mma_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_n = (a.N + tc::kBN - 1) / tc::kBN;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int p0 = tile / tiles_n * tc::kBM, n0 = tile % tiles_n * tc::kBN;
  const int k0 = split * a.chunk, k1 = min(a.K, k0 + a.chunk);
  tc::Acc acc;
  tc::tile<kVec>(a.x, a.w, a.P, a.K, a.N, p0, n0, k0, k1, smem, acc);

  if (a.splits == 1) {
    tc::for_each_acc(acc, [&](int r, int c, float v) {
      if (p0 + r < a.P && n0 + c < a.N)
        a.out[static_cast<size_t>(p0 + r) * a.N + n0 + c] = bn(a, n0 + c, v);
    });
    return;
  }
  float* part = a.part + static_cast<size_t>(split) * a.P * a.N;
  tc::for_each_acc(acc, [&](int r, int c, float v) {
    if (p0 + r < a.P && n0 + c < a.N) part[static_cast<size_t>(p0 + r) * a.N + n0 + c] = v;
  });
  if (!arrive_last(a, tile)) return;
  if (kVec)  // N % 4 == 0: four adjacent columns a load
    reduce_splits<float4, 8, 1, tc::kThreads>(a, p0, n0, tc::kBM * tc::kBN / 4, tc::kBN / 4, 4);
  else
    reduce_splits<float, 8, 1, tc::kThreads>(a, p0, n0, tc::kBM * tc::kBN, tc::kBN, 1);
}

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
      a.out[at] = bn(a, n0 + c, s);
    else
      part[at] = s;
  }
  if (a.splits == 1 || !arrive_last(a, blockIdx.x)) return;
  reduce_splits<float, kGemvMaxP * kGemvCols / kGemvThreads, 8, kGemvThreads>(
      a, 0, n0, a.P * kGemvCols, kGemvCols, 1);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Sets the MMA kernel's dynamic shared memory limit once per device.
cudaError_t allow_mma_smem(const void* kernel, int vec) {
  static bool done[64][2] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev][vec]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tc::kSmemBytes));
    if (e != cudaSuccess) return e;
    done[dev][vec] = true;
  }
  return cudaSuccess;
}

}  // namespace

// The host's plan (kernels/pointwise.py::split_plan): `gemv` picks the path,
// `tile` is the width of its output tiles and must be this library's
// (kGemvCols for the GEMV, 64 for the MMA tiles; the GEMV takes at most
// kGemvMaxP rows); K in `splits` ranges of `chunk`, the last one shorter,
// chunk a multiple of kSplitStep when splits > 1. ws (may be null at one
// split): one counter per output tile from word 0, the splits x P x N
// partial sums from word `part` (a multiple of 4), ws_words words in all.
extern "C" int pointwise_conv1x1_bn(const float* x, const float* w, const float* scale,
                                    const float* bias, float* out, float* ws, long long ws_words,
                                    long long part, int P, int K, int N, int relu, int gemv,
                                    int tile, int splits, int chunk, void* stream) {
  if (P <= 0 || K <= 0 || N <= 0 || splits <= 0 || chunk <= 0 ||
      tile != (gemv ? kGemvCols : tc::kBM) || (gemv && P > kGemvMaxP) ||
      static_cast<long long>(chunk) * splits < K ||
      static_cast<long long>(chunk) * (splits - 1) >= K ||
      (splits > 1 && chunk % kSplitStep != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_n = (N + tile - 1) / tile;
  const int tiles = gemv ? tiles_n : (P + tile - 1) / tile * tiles_n;
  if (splits > 1 && (part < tiles || part % 4 != 0 ||
                     ws_words < part + static_cast<long long>(splits) * P * N))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  Args a{x, w, scale, bias, out, nullptr, nullptr, P, K, N, relu, splits, chunk};
  if (splits > 1) {
    a.counters = reinterpret_cast<unsigned int*>(ws);
    a.part = ws + part;
    const cudaError_t e = cudaMemsetAsync(a.counters, 0, sizeof(unsigned int) * tiles, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(tiles, splits);
  if (gemv) {
    const bool vec = N % 4 == 0 && aligned16(w);
    if (vec)
      pointwise_gemv_kernel<true><<<grid, kGemvThreads, 0, s>>>(a);
    else
      pointwise_gemv_kernel<false><<<grid, kGemvThreads, 0, s>>>(a);
  } else {
    const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(out);
    const void* kernel = vec ? reinterpret_cast<const void*>(pointwise_mma_kernel<true>)
                             : reinterpret_cast<const void*>(pointwise_mma_kernel<false>);
    const cudaError_t e = allow_mma_smem(kernel, vec);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (vec)
      pointwise_mma_kernel<true><<<grid, tc::kThreads, tc::kSmemBytes, s>>>(a);
    else
      pointwise_mma_kernel<false><<<grid, tc::kThreads, tc::kSmemBytes, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
