// Int8 1x1 conv + folded BN (+ ReLU) with per-row dynamic activation
// quantization: out[p, n] = float(q(x)[p, :] . w_q[:, n]) * (s_x[p] * s_w[n])
// * scale[n] + bias[n] (+ ReLU); gemm_int8.cuh states the arithmetic (row
// scale max|x| / 127 by IEEE division, 1 for a zero row; rint clamped to
// +-127; an exact int32 sum; the epilogue's multiplies and adds rounded one
// by one), so the kernel equals kernels/quantized.py::conv1x1_bn_int8_plain
// to the bit.
//
// Replaces: winograd_tpu/kernels/quantized.py::_quant_matmul_kernel
// (conv1x1_bn_int8_pallas). On the int8 ResNet-50 path it runs the
// projection block's three 1x1s (3136 x 64 -> 64, 256 and 256) and the head
// FC (P = 1, K = 2048, N = 1000); on the int8 ResNet-34 path the strided
// 3x3 b-legs as GEMMs on a strided im2col (784 x 576 -> 128, 196 x 1152 ->
// 256, 49 x 2304 -> 512), the projections (784 x 64 -> 128, 196 x 128 ->
// 256, 49 x 256 -> 512) and the head (1 x 512 -> 1000).
//
// Bound on the H100: bytes. The int8 products at 1979 TOPS take at most
// 0.06 us at these shapes; x in f32 (4 bytes a value), the int8 weights and
// the f32 output take 0.06-1.2 us at 3.35 TB/s (the head reads its 2 MB of
// int8 weights once: 0.6 us). Their output tiles number 8 to 196, so one
// block walking a tile's whole K alone leaves most SMs idle.
//
// Design (the host's plan, kernels/quantized.py::pointwise_int8_plan, picks
// the path, the tile and the K split; this entry checks the plan against
// the geometry compiled here and refuses one that does not fit):
// * GEMV (P <= kGemvMaxP; the plan gives it the N=1 head): a block owns
//   kGemvCols columns and a K range. It finds its rows' scales over all of
//   K (P <= 8 rows), then
//   quantizes the rows over its K range once into shared memory; each warp
//   reads four weight rows of its 128 columns at a time, coalesced along N,
//   turns them k-contiguous in registers (byte permutes) and multiplies by
//   __dp4a into int32. The warps' sums meet in shared memory; with several
//   K ranges the last block of a column tile adds the int32 partial sums
//   (exact in any order) and applies the epilogue once.
// * Cluster (any P; the strided b-legs and most 1x1s): wgmma_s8_cluster.cuh's
//   one-launch s8 wgmma GEMM (shared with csrc/direct_int8.cu) on x's rows
//   (XRows): a block of two warpgroups on a 64-row tile of the plan's 64 or
//   128 columns, a tile's K splits the blocks of one thread-block cluster
//   (at most kClusterMax) that exchange their rows' maxima and add their
//   int32 partials through distributed shared memory. No grid barrier, no
//   memset, no workspace, no cooperative launch: what the mma.sync
//   cooperative form (a quantize phase, two grid barriers, int32 partials
//   through device memory) paid at every launch.
// * One pass (Kp <= kOnePassMaxK): one block a 64 x 64 output tile on
//   mma_int8.cuh's s8 mma.sync warp tile, its 64 rows quantized once into
//   shared memory and its 64 weight columns written k-contiguous beside
//   them, no barrier. Kept where the sweep finds it faster: K of one short
//   walk over many rows (tools/chip_split_sweep.py, PERF.md).

#include <stdint.h>

#include "common.cuh"
#include "mma_int8.cuh"
#include "wgmma_s8.cuh"
#include "wgmma_s8_cluster.cuh"

namespace {

namespace s8 = wt::s8mma;
namespace q8 = wt::wgs8;
namespace sc = wt::s8cluster;
// The max |v| over a float4 as bits: a NaN above every number, so a row
// with a NaN gets a NaN scale, as torch.amax gives the plain version.
using sc::abs_bits4;

// The plan's paths, as the host numbers them.
constexpr int kGemv = 0;
constexpr int kOnePass = 1;
constexpr int kCluster = 2;

constexpr int kGemvMaxP = 8;      // rows the GEMV's registers and shared arrays hold
constexpr int kGemvCols = 128;    // columns a GEMV block owns: four a lane
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvStep = 32;     // a GEMV split is a multiple of this: one 4-k group a warp
constexpr int kGemvXChunk = 1024;  // k of x quantized into shared memory at a time
constexpr int kOnePassMaxK = 256;  // Kp of the rows the one-pass form holds in shared memory
constexpr int kOnePassLd = kOnePassMaxK + 16;  // bytes a shared row: 32 distinct banks a fragment

static_assert(kGemvStep == 4 * kGemvWarps, "a GEMV step is one 4-k group a warp");
static_assert(kGemvXChunk % kGemvStep == 0, "x chunks hold whole GEMV steps");
static_assert(kOnePassMaxK % 128 == 0, "a lane holds kOnePassMaxK / 128 float4s of a row");

struct Args {
  const float* x;     // (P, K), 16-byte aligned, K % 4 == 0
  const int8_t* wq;   // (K, N)
  const float* sw;
  const float* scale;
  const float* bias;
  float* out;
  unsigned int* bar;  // the GEMV's tile counters
  int* part;          // the GEMV's int32 partial sums of the K splits
  int P, K, N, relu, Kp, splits, chunk;
};

__device__ __forceinline__ wt::Int8BnEpilogue epilogue(const Args& a) {
  return wt::Int8BnEpilogue{a.sw, a.scale, a.bias, a.out, a.N, a.relu};
}

// --- GEMV: P <= kGemvMaxP -------------------------------------------------

template <bool kVec>
__global__ void __launch_bounds__(kGemvThreads) pointwise_int8_gemv(Args a) {
  __shared__ float sx[kGemvMaxP];
  __shared__ unsigned xq[kGemvMaxP][kGemvXChunk / 4];
  __shared__ int red[kGemvWarps][kGemvMaxP][kGemvCols];
  __shared__ bool last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kGemvCols, split = blockIdx.y;
  const int k0 = split * a.chunk, k1 = min(a.K, k0 + a.chunk);
  const int n = n0 + 4 * lane;

  if (warp < a.P) {  // row `warp`'s scale over all of K
    const float4* row = reinterpret_cast<const float4*>(a.x + static_cast<size_t>(warp) * a.K);
    unsigned m = 0u;
    for (int j = lane; j < a.K / 4; j += 32) m = max(m, abs_bits4(__ldg(row + j)));
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) sx[warp] = q8::scale_of_bits(m);
  }
  int acc[kGemvMaxP][4];
#pragma unroll
  for (int p = 0; p < kGemvMaxP; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p][e] = 0;

  for (int kc = k0; kc < k1; kc += kGemvXChunk) {
    const int words = min(kGemvXChunk, k1 - kc) / 4;
    __syncthreads();  // the scales are in; every warp is done with the last chunk
    for (int i = threadIdx.x; i < a.P * words; i += kGemvThreads) {
      const int p = i / words, j = i - p * words;
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(a.x + static_cast<size_t>(p) * a.K + kc) + j);
      xq[p][j] = s8::quantize4(v, sx[p]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = warp; j < words; j += kGemvWarps) {
      unsigned r[4], c[4];
      s8::rows4<kVec>(a.wq, a.K, a.N, kc + 4 * j, n, r);
      s8::transpose4(r, c);
#pragma unroll
      for (int p = 0; p < kGemvMaxP; ++p) {
        if (p < a.P) {
          const int xv = static_cast<int>(xq[p][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][e] = __dp4a(xv, static_cast<int>(c[e]), acc[p][e]);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kGemvMaxP; ++p)
    if (p < a.P)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][p][4 * lane + e] = acc[p][e];
  __syncthreads();

  const wt::Int8BnEpilogue epi = epilogue(a);
  int* part = a.part + static_cast<size_t>(split) * a.P * a.N;
  for (int i = threadIdx.x; i < a.P * kGemvCols; i += kGemvThreads) {
    const int p = i / kGemvCols, c = i % kGemvCols;
    if (n0 + c >= a.N) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[w][p][c];
    if (a.splits == 1)
      epi(p, n0 + c, s, sx[p]);
    else
      part[static_cast<size_t>(p) * a.N + n0 + c] = s;
  }
  if (a.splits == 1) return;
  // The last block of this column tile to arrive sees every split's sums.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.bar + blockIdx.x, 1u) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t pn = static_cast<size_t>(a.P) * a.N;
  for (int i = threadIdx.x; i < a.P * kGemvCols; i += kGemvThreads) {
    const int p = i / kGemvCols, c = i % kGemvCols;
    if (n0 + c >= a.N) continue;
    const size_t at = static_cast<size_t>(p) * a.N + n0 + c;
    int s = 0;
#pragma unroll 8
    for (int k = 0; k < a.splits; ++k) s += __ldcg(a.part + k * pn + at);
    epi(p, n0 + c, s, sx[p]);
  }
}

// --- one pass: Kp <= kOnePassMaxK -----------------------------------------

constexpr int kRowF4 = kOnePassMaxK / 128;           // float4s of a row a lane holds
constexpr int kRowsPerWarp = s8::kBM / (s8::kThreads / 32);

template <bool kVec>
__global__ void __launch_bounds__(s8::kThreads) pointwise_int8_one_pass(Args a) {
  __shared__ __align__(16) int8_t sa[s8::kBM * kOnePassLd];
  __shared__ __align__(16) int8_t sb[s8::kBN * kOnePassLd];
  __shared__ float sx[s8::kBM];
  const int tiles_n = (a.N + s8::kBN - 1) / s8::kBN;
  const int p0 = blockIdx.x / tiles_n * s8::kBM, n0 = blockIdx.x % tiles_n * s8::kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k4 = a.K / 4, kp4 = a.Kp / 4;

  // The block's 64 weight columns, k-contiguous: items of four k by four
  // columns, their loads issued before the rows'.
  constexpr int kItems = kOnePassMaxK / 4 * (s8::kBN / 4) / s8::kThreads;
  unsigned w[kItems][4];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int item = threadIdx.x + i * s8::kThreads, kg = item / (s8::kBN / 4);
    if (kg < kp4) s8::rows4<kVec>(a.wq, a.K, a.N, 4 * kg, n0 + item % (s8::kBN / 4) * 4, w[i]);
  }
  // The warp's rows r = warp, warp + 8, ...: every load in flight, then
  // each row's scale and its int8 values, zero past K and past P.
  float4 v[kRowsPerWarp][kRowF4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int p = p0 + warp + i * (s8::kThreads / 32);
    const float4* row = reinterpret_cast<const float4*>(a.x + static_cast<size_t>(p) * a.K);
#pragma unroll
    for (int f = 0; f < kRowF4; ++f) {
      const int j = lane + 32 * f;
      v[i][f] = p < a.P && j < k4 ? __ldg(row + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * (s8::kThreads / 32);
    unsigned m = 0u;
#pragma unroll
    for (int f = 0; f < kRowF4; ++f) m = max(m, abs_bits4(v[i][f]));
    const float s = q8::scale_of_bits(__reduce_max_sync(0xffffffffu, m));
    unsigned* dst = reinterpret_cast<unsigned*>(sa + r * kOnePassLd);
#pragma unroll
    for (int f = 0; f < kRowF4; ++f) {
      const int j = lane + 32 * f;
      if (j < kp4) dst[j] = s8::quantize4(v[i][f], s);  // zeros quantize to zero
    }
    if (lane == 0) sx[r] = s;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int item = threadIdx.x + i * s8::kThreads, kg = item / (s8::kBN / 4);
    if (kg >= kp4) continue;
    unsigned c[4];
    s8::transpose4(w[i], c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<unsigned*>(sb + (item % (s8::kBN / 4) * 4 + e) * kOnePassLd + 4 * kg) =
          c[e];
  }
  __syncthreads();

  s8::Acc acc;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  for (int ks = 0; ks < a.Kp; ks += 32)
    s8::mma_k32(sa, sb, kOnePassLd, ks, acc, warp / 4, warp % 4);
  const wt::Int8BnEpilogue epi = epilogue(a);
  s8::for_each_acc(acc, [&](int r, int c, int v) {
    if (p0 + r < a.P && n0 + c < a.N) epi(p0 + r, n0 + c, v, sx[r]);
  });
}

bool vec_weights(const int8_t* wq, int N) {
  return N % 4 == 0 && reinterpret_cast<uintptr_t>(wq) % 4 == 0;
}

}  // namespace

// The host's plan (kernels/quantized.py::pointwise_int8_plan): `path` (0
// GEMV, 1 one pass, 2 cluster); Kp, K padded to a multiple of s8::kKAlign
// (K itself for the GEMV); `tile` the output tiles' width (kGemvCols, else
// q8::kBM); `blocks` the grid (the GEMV's column tiles x splits, the one
// pass's tiles, the cluster path's tiles x splits); Kp in `splits` ranges
// of `chunk`, the last one shorter (a cluster split a multiple of
// sc::kClusterStep, at most sc::kClusterPortable). ws, ws_words 4-byte words (may be
// null where the plan needs none): for the GEMV past one split, a counter
// per column tile from word 0 and the splits x P x N int32 partial sums
// from word `part`; no other path takes a workspace. x must be 16-byte
// aligned and K a multiple of 4 (the wrapper pads Cin).
extern "C" int pointwise_int8_conv1x1_bn(const float* x, const int8_t* wq, const float* sw,
                                         const float* scale, const float* bias, float* out,
                                         float* ws, long long ws_words, long long part, int P,
                                         int K, int N, int relu, int path, int Kp, int tile,
                                         int blocks, int splits, int chunk, void* stream) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0 || K <= 0 || N <= 0 || K % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      Kp < K || splits <= 0 || chunk <= 0 || blocks <= 0 ||
      static_cast<long long>(chunk) * splits < Kp ||
      static_cast<long long>(chunk) * (splits - 1) >= Kp)
    return invalid;
  const auto s = static_cast<cudaStream_t>(stream);
  Args a{x, wq, sw, scale, bias, out, nullptr, nullptr, P, K, N, relu, Kp, splits, chunk};
  const int tiles_mma = (P + s8::kBM - 1) / s8::kBM * ((N + s8::kBN - 1) / s8::kBN);
  const bool vec = vec_weights(wq, N);
  cudaError_t e = cudaSuccess;
  if (path == kGemv) {
    const int tiles = (N + kGemvCols - 1) / kGemvCols;
    if (P > kGemvMaxP || tile != kGemvCols || Kp != K || blocks != tiles * splits ||
        (splits > 1 && (chunk % kGemvStep != 0 || part < tiles || part % 4 != 0 ||
                        ws_words < part + static_cast<long long>(splits) * P * N)))
      return invalid;
    if (splits > 1) {
      a.bar = reinterpret_cast<unsigned int*>(ws);
      a.part = reinterpret_cast<int*>(ws + part);
      e = cudaMemsetAsync(a.bar, 0, sizeof(unsigned int) * tiles, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(tiles, splits);
    if (vec)
      pointwise_int8_gemv<true><<<grid, kGemvThreads, 0, s>>>(a);
    else
      pointwise_int8_gemv<false><<<grid, kGemvThreads, 0, s>>>(a);
  } else if (path == kOnePass) {
    if (tile != s8::kBM || Kp % s8::kKAlign != 0 || Kp > kOnePassMaxK || splits != 1 ||
        blocks != tiles_mma)
      return invalid;
    if (vec)
      pointwise_int8_one_pass<true><<<blocks, s8::kThreads, 0, s>>>(a);
    else
      pointwise_int8_one_pass<false><<<blocks, s8::kThreads, 0, s>>>(a);
  } else if (path == kCluster) {
    const sc::Args c{wq, sw, scale, bias, out, P, K, N, relu, Kp, splits, chunk};
    return static_cast<int>(sc::run<sc::kClusterPortable>(c, sc::XRows{x, P, K}, tile, blocks, s));
  } else {
    return invalid;
  }
  return static_cast<int>(cudaGetLastError());
}
