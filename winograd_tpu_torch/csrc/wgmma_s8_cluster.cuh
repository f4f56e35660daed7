// One int8 GEMM with per-row dynamic activation quantization and folded BN
// (+ ReLU) as one launch on s8 wgmma, the K splits of an output tile the
// blocks of one thread-block cluster:
//   out[p, n] = float(q(A)[p, :] . w_q[:, n]) * (s_x[p] * s_w[n]) * scale[n]
//               + bias[n] (+ ReLU),
// A's rows from a row source (XRows: a row-major (P, K) matrix, csrc/
// pointwise_int8.cu's 1x1s; XIm2col: the pad-1 stride-1 3x3 im2col of an
// (N, H, W, C) map, csrc/direct_int8.cu), gemm_int8.cuh's arithmetic (row
// scale max|row| / 127 by IEEE division, 1 for a zero row; rint clamped to
// +-127; an exact int32 sum; the epilogue's multiplies and adds rounded one
// by one), so the kernel equals the plain versions to the bit.
//
// A block of two warpgroups on a 64-row tile of kCols (64 or 128) columns
// (64 a warpgroup, both on one A), s8 wgmma m64n64k32 (wgmma_s8.cuh's
// instruction and 128-byte swizzle); a tile's K splits are the blocks of
// one cluster (cluster dims (1, splits, 1), at most kMax: 8 for the 1x1s,
// 16 for the 3x3, past 8 a non-portable cluster within one GPC; one K range
// is a cluster of one). Each thread owns a
// quarter of one row: the block takes its 64 rows' max |a| over its own K
// range (no atomics), and the cluster exchanges these through distributed
// shared memory into each row's whole maximum (a max is exact in any
// order; the bits of |a| order a NaN above every number, so a row with a
// NaN gets a NaN scale, as torch.amax gives the plain version). Each block
// then quantizes its K range once, in spans of kSpan k held in shared
// memory as wgmma's K-major A, beside its columns' weights staged K-major
// (16 k rows of four columns a thread, byte-permuted into the swizzled rows
// as csrc/winograd_int8.cu stages u_q: no k-contiguous copy, no TMA map; a
// warp's loads whole 32-byte sectors, its stores conflict-free), and
// multiplies. Past one split each block leaves its int32 partial tile in its
// shared memory and, after a cluster barrier, block r adds rows r * 64 /
// splits .. of every block's partial (exact in any order) and applies the
// epilogue once an element. No grid barrier, no memset, no workspace, no
// cooperative launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "gemm_int8.cuh"
#include "mma_int8.cuh"
#include "wgmma_s8.cuh"
#include "wgmma_s8_phase.cuh"

namespace wt {
namespace s8cluster {

namespace s8 = wt::s8mma;
namespace q8 = wt::wgs8;
namespace wg = wt::wg;

constexpr int kClusterMax = 16;      // K splits of a cluster tile: the blocks of one cluster
constexpr int kClusterPortable = 8;  // the most a cluster holds without the non-portable opt-in
constexpr int kClusterStep = 32;  // a cluster split is a multiple of this: one wgmma k step

// The product's weights, epilogue and plan: w_q (K, N) int8 row-major, its
// K padded to Kp (a multiple of s8::kKAlign, zero past K) in `splits`
// ranges of `chunk`.
struct Args {
  const int8_t* wq;
  const float* sw;
  const float* scale;
  const float* bias;
  float* out;
  int P, K, N, relu, Kp, splits, chunk;
};

// ---- row sources: row(p) once a thread, load(row, k) four values from k
// (a multiple of 4), zero past P and past K.

// A row-major (P, K) float matrix, 16-byte aligned, K % 4 == 0.
struct XRows {
  const float* x;
  int P, K;
  struct Row {
    const float* px;  // null past P
  };
  __device__ __forceinline__ Row row(int p) const {
    return Row{p < P ? x + static_cast<size_t>(p) * K : nullptr};
  }
  __device__ __forceinline__ float4 load(const Row& r, int k) const {
    return r.px != nullptr && k < K ? __ldg(reinterpret_cast<const float4*>(r.px + k))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// The pad-1 stride-1 3x3 im2col rows of an (N, H, W, C) float map (16-byte
// aligned, C % 4 == 0): row p = (n, y, x) and k = (3r + s) C + c take the
// value at (y + r - 1, x + s - 1), zero where the window leaves the map;
// K = 9 C. Four consecutive k lie in one window and one pixel.
struct XIm2col {
  const float* x;
  int H, W, C, P;
  struct Row {
    const float* px;  // the row's own pixel (its window (1, 1)); null past P
    int y, x;
  };
  __device__ __forceinline__ Row row(int p) const {
    if (p >= P) return Row{nullptr, 0, 0};
    const int q = p % (H * W);
    return Row{x + static_cast<size_t>(p) * C, q / W, q % W};
  }
  __device__ __forceinline__ float4 load(const Row& r, int k) const {
    // the window: a shift where C is a power of two (every served width)
    const int rs = (C & (C - 1)) == 0 ? k >> (__ffs(C) - 1) : k / C;
    const int dy = rs / 3 - 1, dx = rs % 3 - 1;
    const int y = r.y + dy, xx = r.x + dx;
    if (r.px == nullptr || rs >= 9 || y < 0 || y >= H || xx < 0 || xx >= W)
      return make_float4(0.f, 0.f, 0.f, 0.f);
    return __ldg(reinterpret_cast<const float4*>(r.px + (dy * W + dx) * C + (k - rs * C)));
  }
};

// ---- the kernel ----------------------------------------------------------------

// A cluster block: two warpgroups on a 64 x kCols output tile (kCols 64:
// the first warpgroup's 64 columns; 128: 64 each), sharing A. Thread t
// owns row t / 4 of A and the float4s 4 i + t % 4 of each 16-k step of it;
// unit (k group, column group) of a weight stage as unit_of gives it.
constexpr int kThreads = 2 * q8::kWgThreads;
constexpr int kSpan = 256;                  // k of A and B a block stages at once
constexpr int kSpanStages = kSpan / q8::kBK;
constexpr int kStageF4 = q8::kBK / 16;      // float4s of its row a thread stages a stage
constexpr int kLdRed = 2 * q8::kBN + 4;     // ints a row of a partial tile in shared memory
// A span of A (64 x kSpan) and of B (128 columns x kSpan), aligned to the
// swizzle's 1024-byte atom; the partial tile reuses it.
constexpr size_t kSmemBytes =
    1024 + static_cast<size_t>(kSpanStages) * (q8::kABytes + 2 * q8::kBBytes);
static_assert(q8::kBM * kLdRed * 4 + 1024 <= kSmemBytes, "a partial tile fits the span");
static_assert(kThreads / 4 == q8::kBM, "four threads a row of A");

// The weights of one stage of kb into the B slots (the tile's columns as
// rows, K-major, 128-byte swizzle, 64 columns a warpgroup's slot): unit u
// (u < kCols / 4 * 8) is the 16 k from kb + 16 j of columns n0 + 4 c .. +3
// (unit_of). A warp takes eight column groups of four k groups, so each of
// its row loads is four 32-byte sectors and each 16-byte store phase hits
// eight distinct chunks.
template <int kCols>
__device__ __forceinline__ int2 unit_of(int u) {
  constexpr int kWarpsAcross = kCols / 4 / 8;  // warps side by side along the columns
  const int lane = u % 32, warp = u / 32;
  return make_int2(lane % 8 + 8 * (warp % kWarpsAcross), lane / 8 + 4 * (warp / kWarpsAcross));
}

template <bool kVec, int kCols>
__device__ __forceinline__ void load_unit(const Args& a, int n0, int kb, int u,
                                          unsigned (&r)[4][4]) {
  const int2 cj = unit_of<kCols>(u);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    s8::rows4<kVec>(a.wq, a.K, a.N, kb + 16 * cj.y + 4 * q, n0 + 4 * cj.x, r[q]);
}

template <int kCols>
__device__ __forceinline__ void store_unit(int u, const unsigned (&r)[4][4], int8_t* slot) {
  const int2 cj = unit_of<kCols>(u);
  const int c = cj.x, j = cj.y;
  unsigned w[4][4];  // [column][word of 4 k]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned cw[4];
    s8::transpose4(r[q], cw);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e][q] = cw[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = 4 * c + e, o = col % q8::kBN;
    *reinterpret_cast<uint4*>(slot + col / q8::kBN * q8::kBBytes + o * q8::kBK +
                              ((j ^ (o & 7)) << 4)) =
        make_uint4(w[e][0], w[e][1], w[e][2], w[e][3]);
  }
}

// The max of |v| over a float4 as bits (wgmma_s8.cuh::abs_bits).
__device__ __forceinline__ unsigned abs_bits4(const float4& v) {
  return max(max(q8::abs_bits(v.x), q8::abs_bits(v.y)), max(q8::abs_bits(v.z), q8::abs_bits(v.w)));
}

// One block per (output tile, split), grid (tiles, splits), the splits of a
// tile one cluster (a block's rank is its split). kVec: N % 4 == 0 and the
// weights 4-byte aligned; kCols: the tile's columns, 64 or 128; kMax: the
// most splits; Src: the rows of A (XRows, XIm2col).
template <bool kVec, int kCols, int kMax, class Src>
__global__ void __launch_bounds__(kThreads, 2) cluster_gemm_s8(const Args a, const Src src) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  __shared__ unsigned rmax[q8::kBM];
  __shared__ float sc[q8::kBM], rc[q8::kBM];
  int8_t* sa = reinterpret_cast<int8_t*>(dsmem) + ((1024 - (wt::smem_addr(dsmem) & 1023)) & 1023);
  int8_t* sb = sa + kSpanStages * q8::kABytes;  // stage st's slots at st * 2 * kBBytes
  const int tiles_n = (a.N + kCols - 1) / kCols;
  const int p0 = blockIdx.x / tiles_n * q8::kBM, n0 = blockIdx.x % tiles_n * kCols;
  const int split = blockIdx.y;
  const int k0 = split * a.chunk, k1 = min(a.Kp, k0 + a.chunk);
  const int t = threadIdx.x, row = t / 4;
  const auto ar = src.row(p0 + row);
  constexpr int kUnits = kCols / 4 * (q8::kBK / 16);  // weight units a stage

  // Pass 1: the max |a| of this thread's row over the block's K range,
  // eight loads in flight, then its four threads' maximum.
  unsigned m = 0u;
  for (int kb = k0 + 4 * (t % 4); kb < k1; kb += 16 * 8) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = kb + 16 * i < k1 ? src.load(ar, kb + 16 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 8; ++i) m = max(m, abs_bits4(v[i]));
  }
  m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
  if (t % 4 == 0) rmax[row] = m;
  // Each row's whole maximum from the cluster's blocks, then its scale.
  if (a.splits > 1)
    wt::cluster_sync();
  else
    __syncthreads();
  if (t < q8::kBM) {
    unsigned mm = rmax[t];
    const unsigned at = wt::smem_addr(rmax + t);
    for (int q = 0; q < a.splits; ++q) mm = max(mm, wt::load_rank_u32(at, q));
    sc[t] = q8::scale_of_bits(mm);
    rc[t] = 1.f / sc[t];
  }
  __syncthreads();

  // Pass 2, a span at a time: the weights and the rows (read again)
  // staged into the span's slots, then the products.
  const int wgi = q8::wg_index();
  const bool mma = wgi * q8::kBN < kCols;  // the warpgroup has columns
  const float s = sc[row], rs = rc[row];
  q8::Acc acc;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  for (int s0 = k0; s0 < k1; s0 += kSpan) {
    const int s1 = min(k1, s0 + kSpan);
    // A stage at a time: its weights' loads, its rows' loads, the weights
    // stored, the rows quantized (the loads of each in flight together,
    // a stage's registers live at a time).
#pragma unroll
    for (int st = 0; st < kSpanStages; ++st) {
      const int kb = s0 + st * q8::kBK;
      if (kb >= s1) break;
      unsigned w[4][4];
      if (t < kUnits) load_unit<kVec, kCols>(a, n0, kb, t, w);
      float4 v[kStageF4];
#pragma unroll
      for (int i = 0; i < kStageF4; ++i) {
        const int k = kb + 4 * (t % 4) + 16 * i;
        v[i] = k < s1 ? src.load(ar, k) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (t < kUnits) store_unit<kCols>(t, w, sb + st * 2 * q8::kBBytes);
#pragma unroll
      for (int i = 0; i < kStageF4; ++i) {
        const int kk = 4 * (t % 4) + 16 * i;  // k within the stage
        if (kb + kk >= s1) break;
        const int j = kk / 16;
        *reinterpret_cast<unsigned*>(sa + st * q8::kABytes + row * q8::kBK +
                                     ((j ^ (row & 7)) << 4) + kk % 16) =
            wt::s8phase::quantize4_fast(v[i], s, rs);
      }
    }
    wg::fence_proxy_async();  // the generic stores before wgmma reads them
    __syncthreads();
    if (mma) {
      wg::wgmma_fence();
      for (int kk = 0; kk < s1 - s0; kk += 32) {
        const int st = kk / q8::kBK, off = kk % q8::kBK;
        const int8_t* b = sb + st * 2 * q8::kBBytes + wgi * q8::kBBytes + off;
        q8::wgmma_s8(acc, wg::desc128(sa + st * q8::kABytes + off, 16, 1024),
                     wg::desc128(b, 16, 1024), 1);
      }
      wg::wgmma_commit();
      wg::wgmma_wait_all();
      q8::fence_acc(acc);
    }
    __syncthreads();  // every product read the span before the next is staged
  }

  const wt::Int8BnEpilogue epi{a.sw, a.scale, a.bias, a.out, a.N, a.relu};
  const int nw = n0 + wgi * q8::kBN;  // the warpgroup's first column
  if (a.splits == 1) {
    if (mma)
      q8::for_each_acc([&](int r, int c, int i) {
        if (p0 + r < a.P && nw + c < a.N) epi(p0 + r, nw + c, acc[i], sc[r]);
      });
    return;
  }
  // The span is idle: it holds this block's partial tile for the cluster.
  int* red = reinterpret_cast<int*>(sa);
  wg::fence_proxy_async();  // the products' reads of the span before these writes
  if (mma)
    q8::for_each_acc([&](int r, int c, int i) { red[r * kLdRed + wgi * q8::kBN + c] = acc[i]; });
  wt::cluster_sync();
  const int rows = (q8::kBM + a.splits - 1) / a.splits;
  const int r0 = split * rows, r1 = min(q8::kBM, r0 + rows);
  const unsigned base = wt::smem_addr(red);
  for (int i = t; i < (r1 - r0) * kCols; i += kThreads) {
    const int r = r0 + i / kCols, c = i % kCols;
    if (p0 + r >= a.P || n0 + c >= a.N) continue;
    const unsigned at = base + 4u * (r * kLdRed + c);
    int v[kMax];
#pragma unroll
    for (int q = 0; q < kMax; ++q)
      v[q] = q < a.splits ? static_cast<int>(wt::load_rank_u32(at, q)) : 0;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kMax; ++q) sum += v[q];
    epi(p0 + r, n0 + c, sum, sc[r]);
  }
  wt::cluster_sync();  // no block leaves while another reads its partial or its maxima
}

// ---- host side ---------------------------------------------------------------

// Launches cluster_gemm_s8<kVec, kCols, kMax, Src> on grid (tiles, splits)
// in clusters of (1, splits, 1), setting its dynamic shared memory limit
// (and, past a portable cluster, allowing non-portable sizes) once per
// device.
template <bool kVec, int kCols, int kMax, class Src>
cudaError_t launch(const Args& a, const Src& src, int tiles, cudaStream_t s) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(cluster_gemm_s8<kVec, kCols, kMax, Src>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return e;
    if (kMax > kClusterPortable)
      e = cudaFuncSetAttribute(cluster_gemm_s8<kVec, kCols, kMax, Src>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cluster_gemm_s8<kVec, kCols, kMax, Src>, a, src);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Checks the host's plan and launches it: `tile` the output tiles' width
// (64 or 128), `blocks` the grid (tiles x splits), Kp in `splits` ranges
// of `chunk` (the last one shorter, each but the last a multiple of
// kClusterStep, at most kMax: kClusterPortable for csrc/pointwise_int8.cu,
// kClusterMax for csrc/direct_int8.cu; allowing a non-portable cluster
// slowed the 1x1s' portable ones), Kp the smallest multiple of s8::kKAlign
// at or above K.
template <int kMax, class Src>
cudaError_t run(const Args& a, const Src& src, int tile, int blocks, cudaStream_t s) {
  static_assert(kMax == kClusterPortable || kMax == kClusterMax, "a cluster of 8 or of 16");
  const int tiles = (a.P + q8::kBM - 1) / q8::kBM * ((a.N + tile - 1) / tile);
  if (a.P <= 0 || a.K <= 0 || a.N <= 0 || (tile != q8::kBN && tile != 2 * q8::kBN) ||
      a.Kp < a.K || a.Kp % s8::kKAlign != 0 || a.Kp >= a.K + s8::kKAlign || a.splits <= 0 ||
      a.splits > kMax || a.chunk <= 0 ||
      static_cast<long long>(a.chunk) * a.splits < a.Kp ||
      static_cast<long long>(a.chunk) * (a.splits - 1) >= a.Kp ||
      (a.splits > 1 && a.chunk % kClusterStep != 0) || blocks != tiles * a.splits)
    return cudaErrorInvalidValue;
  const bool vec = a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.wq) % 4 == 0;
  if (tile == q8::kBN)
    return vec ? launch<true, q8::kBN, kMax>(a, src, tiles, s)
               : launch<false, q8::kBN, kMax>(a, src, tiles, s);
  return vec ? launch<true, 2 * q8::kBN, kMax>(a, src, tiles, s)
             : launch<false, 2 * q8::kBN, kMax>(a, src, tiles, s);
}

}  // namespace s8cluster
}  // namespace wt
