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
// * GEMV (P <= kGemvMaxP, the heads): gemv_cluster.cuh's form, as
//   csrc/pointwise.cu's GEMV. A block owns a column tile of 128 or 64
//   columns and a range of K; one warp asks for its whole int8 weight slab
//   by 1D bulk copies onto the ring's mbarriers at the start. The block
//   takes its rows' max |x| over its own K range, and the tile's K splits,
//   the blocks of one cluster, push these to each other through
//   distributed shared memory for each row's scale (no block reads a row
//   over all of K);
//   each block quantizes its K range of x once into shared memory, turns
//   four weight rows of four columns k-contiguous from shared memory (byte
//   permutes) and multiplies by __dp4a into int32 (not s8 wgmma: its M is
//   at least 64 rows, the heads have 1-8, and the weights' bytes, not the
//   products, bound them). The row groups' sums meet in shared memory, the
//   splits' int32 partials are pushed to their owners through distributed
//   shared memory and added there (exact in any order), and the epilogue
//   runs once an element. No workspace, no counter, no memset, no atomics.
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
#include "gemv_cluster.cuh"
#include "mma_int8.cuh"
#include "wgmma_s8.cuh"
#include "wgmma_s8_cluster.cuh"

namespace {

namespace s8 = wt::s8mma;
namespace q8 = wt::wgs8;
namespace sc = wt::s8cluster;
namespace gv = wt::gemv;
// The max |v| over a float4 as bits: a NaN above every number, so a row
// with a NaN gets a NaN scale, as torch.amax gives the plain version.
using sc::abs_bits4;

// The plan's paths, as the host numbers them.
constexpr int kGemv = 0;
constexpr int kOnePass = 1;
constexpr int kCluster = 2;

constexpr int kGemvMaxP = gv::kMaxP;  // rows the GEMV's registers and shared arrays hold
constexpr int kGemvCols = 128;        // columns of a GEMV block's tile: this or half of it
constexpr int kGemvXChunk = 1024;     // k of x quantized into shared memory at a time
constexpr int kOnePassMaxK = 256;  // Kp of the rows the one-pass form holds in shared memory
constexpr int kOnePassLd = kOnePassMaxK + 16;  // bytes a shared row: 32 distinct banks a fragment

static_assert(kOnePassMaxK % 128 == 0, "a lane holds kOnePassMaxK / 128 float4s of a row");

struct Args {
  const float* x;     // (P, K), 16-byte aligned, K % 4 == 0
  const int8_t* wq;   // (K, N)
  const float* sw;
  const float* scale;
  const float* bias;
  float* out;
  int P, K, N, relu, Kp, splits, chunk;
};

__device__ __forceinline__ wt::Int8BnEpilogue epilogue(const Args& a) {
  return wt::Int8BnEpilogue{a.sw, a.scale, a.bias, a.out, a.N, a.relu};
}

// --- GEMV: P <= kGemvMaxP -------------------------------------------------

// One block per (column tile, split), grid (tiles, splits), the splits of a
// tile one cluster (a block's rank is its split). kVec: the weights' rows
// by bulk copies (gv::bulk_rows); kCols: the tile's columns, 128 or 64.
// Thread t multiplies columns 4 (t % (kCols / 4)) .. +3 of the 4-row
// groups g, g + kGroups, ... of each stage, g = t / (kCols / 4).
template <bool kVec, int kCols>
__global__ void __launch_bounds__(gv::kThreads)
    pointwise_int8_gemv(const __grid_constant__ Args a) {
  using Slab = gv::Slab<kCols, 1>;
  constexpr int kTpr = kCols / 4;
  constexpr int kGroups = gv::kThreads / kTpr;
  static_assert(Slab::kSmemBytes >= sizeof(int) * kGroups * kGemvMaxP * kCols,
                "the idle ring holds the row groups' sums");
  static_assert(Slab::kRows % 4 == 0 && kGemvMaxP <= gv::kWarps, "4-row groups; a warp a row");
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[gv::kStages];
  __shared__ unsigned rmax[gv::kClusterMax][kGemvMaxP];  // each split's row maxima
  __shared__ float sx[kGemvMaxP];
  __shared__ unsigned xq[kGemvMaxP][kGemvXChunk / 4];
  __shared__ int recv[kGemvMaxP * kCols + gv::kClusterMax];  // this block's share, by split
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, g = t / kTpr, c = 4 * (t % kTpr);
  const int n0 = blockIdx.x * kCols, split = blockIdx.y;
  const int k0 = split * a.chunk, k1 = min(a.K, k0 + a.chunk);
  const Slab slab{reinterpret_cast<const unsigned char*>(a.wq), ring, bars, a.N, n0, k0, k1};
  wt::cluster_arrive_relaxed();  // this block has started (waited for before the pushes)
  if (kVec) slab.begin();

  // Row `warp`'s max |x| over this block's K range, pushed to every block
  // of the cluster; then each row's over the cluster's blocks, its scale.
  unsigned m = 0u;
  if (warp < a.P) {
    const float4* row = reinterpret_cast<const float4*>(a.x + static_cast<size_t>(warp) * a.K);
#pragma unroll 4
    for (int j = k0 / 4 + lane; j < k1 / 4; j += 32) m = max(m, abs_bits4(__ldg(row + j)));
    m = __reduce_max_sync(0xffffffffu, m);
  }
  wt::cluster_wait();  // every block of the cluster has started
  if (warp < a.P && lane < a.splits) wt::store_rank_u32(wt::smem_addr(&rmax[split][warp]), lane, m);
  wt::cluster_sync();
  if (t < a.P) {
    unsigned mm = 0u;
    for (int q = 0; q < a.splits; ++q) mm = max(mm, rmax[q][t]);
    sx[t] = q8::scale_of_bits(mm);
  }

  int acc[kGemvMaxP][4];
#pragma unroll
  for (int p = 0; p < kGemvMaxP; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p][e] = 0;
  int xk = k0;  // the k of xq[.][0]'s first byte
  gv::walk<kVec, kGemvXChunk>(
      slab,
      [&](int kc, int len) {  // the scales are in (the walk's barrier)
        xk = kc;
        const int words = len / 4;
        for (int i = t; i < a.P * words; i += gv::kThreads) {
          const int p = i / words, j = i - p * words;
          const float4 v =
              __ldg(reinterpret_cast<const float4*>(a.x + static_cast<size_t>(p) * a.K + kc) + j);
          xq[p][j] = s8::quantize4(v, sx[p]);
        }
      },
      [&](int s, int r0, int rows) {
#pragma unroll 2
        for (int r = 4 * g; r < rows; r += 4 * kGroups) {
          unsigned w[4], cw[4];
          if (kVec) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              w[i] = *reinterpret_cast<const unsigned*>(slab.row(s, r + i) + c);
          } else {
            s8::rows4<false>(a.wq, a.K, a.N, r0 + r, n0 + c, w);
          }
          s8::transpose4(w, cw);
          const int j = (r0 + r - xk) / 4;
#pragma unroll
          for (int p = 0; p < kGemvMaxP; ++p) {
            if (p < a.P) {
              const int xv = static_cast<int>(xq[p][j]);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[p][e] = __dp4a(xv, static_cast<int>(cw[e]), acc[p][e]);
            }
          }
        }
      });

  // The epilogue's column factors of the sums this block will own after
  // the cluster barrier, read while the row groups' sums meet (held over
  // the walk, at 128 columns, they spilled to local memory).
  constexpr int kOwn = (kGemvMaxP * kCols + gv::kThreads - 1) / gv::kThreads;
  const int count = a.P * kCols, per = gv::share(count, a.splits);
  float own_w[kOwn], own_s[kOwn], own_b[kOwn];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int j = t + u * gv::kThreads, n = n0 + (split * per + j) % kCols;
    const bool ok = j < per && split * per + j < count && n < a.N;
    own_w[u] = ok ? __ldg(a.sw + n) : 0.f;
    own_s[u] = ok ? __ldg(a.scale + n) : 0.f;
    own_b[u] = ok ? __ldg(a.bias + n) : 0.f;
  }
  // The row groups' sums meet in the idle ring, then add (exact).
  int* red = reinterpret_cast<int*>(ring);  // [kGroups][kGemvMaxP][kCols]
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kGemvMaxP; ++p)
    if (p < a.P)
      *reinterpret_cast<int4*>(red + (g * kGemvMaxP + p) * kCols + c) =
          make_int4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  __syncthreads();
  for (int i = t; i < count; i += gv::kThreads) {
    const int p = i / kCols, cc = i % kCols;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) sum += red[(q * kGemvMaxP + p) * kCols + cc];
    gv::push(recv, i, per, split, sum);
  }
  // This block's share of the tile's sums over the cluster's blocks, then
  // the epilogue on the factors read above.
  wt::cluster_sync();
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int j = t + u * gv::kThreads, i = split * per + j, p = i / kCols, n = n0 + i % kCols;
    if (j >= per || i >= count || n >= a.N) continue;
    a.out[static_cast<size_t>(p) * a.N + n] = wt::Int8BnEpilogue::value(
        gv::gather(recv, j, per, a.splits), sx[p], own_w[u], own_s[u], own_b[u], a.relu);
  }
}

// The GEMV at kCols columns a tile; clusters: as gv::launch takes it.
template <int kCols>
cudaError_t gemv(const Args& a, bool vec, cudaStream_t s, int* clusters = nullptr) {
  constexpr size_t kSmem = gv::Slab<kCols, 1>::kSmemBytes;
  const int tiles = (a.N + kCols - 1) / kCols;
  return vec ? gv::launch<&pointwise_int8_gemv<true, kCols>>(a, tiles, a.splits, kSmem, s, clusters)
             : gv::launch<&pointwise_int8_gemv<false, kCols>>(a, tiles, a.splits, kSmem, s,
                                                              clusters);
}

// The GEMV under the plan's tile width (kGemvCols or half of it).
cudaError_t run_gemv(const Args& a, int tile, cudaStream_t s, int* clusters = nullptr) {
  const bool vec = gv::bulk_rows(a.wq, a.K, a.N, 1);
  return tile == kGemvCols ? gemv<kGemvCols>(a, vec, s, clusters)
                           : gemv<kGemvCols / 2>(a, vec, s, clusters);
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
// (K itself for the GEMV); `tile` the output tiles' width (kGemvCols or
// half of it for the GEMV, else q8::kBM or twice it on the cluster path);
// `blocks` the grid (the GEMV's column tiles x splits, the one pass's tiles,
// the cluster path's tiles x splits); Kp in `splits` ranges of `chunk`, the
// last one shorter (a GEMV split a multiple of gv::kStep, a power of two of
// them, at most gv::kClusterMax; a cluster split a multiple of
// sc::kClusterStep, at most sc::kClusterPortable). No path takes a
// workspace. x must be 16-byte aligned and K a multiple of 4 (the wrapper
// pads Cin).
extern "C" int pointwise_int8_conv1x1_bn(const float* x, const int8_t* wq, const float* sw,
                                         const float* scale, const float* bias, float* out, int P,
                                         int K, int N, int relu, int path, int Kp, int tile,
                                         int blocks, int splits, int chunk, void* stream) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0 || K <= 0 || N <= 0 || K % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      Kp < K || splits <= 0 || chunk <= 0 || blocks <= 0 ||
      static_cast<long long>(chunk) * splits < Kp ||
      static_cast<long long>(chunk) * (splits - 1) >= Kp)
    return invalid;
  const auto s = static_cast<cudaStream_t>(stream);
  const Args a{x, wq, sw, scale, bias, out, P, K, N, relu, Kp, splits, chunk};
  const int tiles_mma = (P + s8::kBM - 1) / s8::kBM * ((N + s8::kBN - 1) / s8::kBN);
  if (path == kGemv) {
    if ((tile != kGemvCols && tile != kGemvCols / 2) || Kp != K ||
        blocks != (N + tile - 1) / tile * splits ||
        !gv::plan_fits(P, K, N, splits, chunk))
      return invalid;
    return static_cast<int>(run_gemv(a, tile, s));
  }
  if (path == kOnePass) {
    if (tile != s8::kBM || Kp % s8::kKAlign != 0 || Kp > kOnePassMaxK || splits != 1 ||
        blocks != tiles_mma)
      return invalid;
    if (vec_weights(wq, N))
      pointwise_int8_one_pass<true><<<blocks, s8::kThreads, 0, s>>>(a);
    else
      pointwise_int8_one_pass<false><<<blocks, s8::kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (path == kCluster) {
    const sc::Args c{wq, sw, scale, bias, out, P, K, N, relu, Kp, splits, chunk};
    return static_cast<int>(sc::run<sc::kClusterPortable>(c, sc::XRows{x, P, K}, tile, blocks, s));
  }
  return invalid;
}

// The clusters of the GEMV's served instantiation (bulk copies) of `tile`
// columns and `splits` blocks that the current device holds at once, into
// *clusters (the plan asks before it takes more than a portable cluster).
extern "C" int pointwise_int8_gemv_clusters(int tile, int splits, int* clusters) {
  if ((tile != kGemvCols && tile != kGemvCols / 2) || splits <= 0 ||
      splits > gv::kClusterMax || (splits & (splits - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *clusters = 0;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 4, 4, 0, 4, splits, 4};
  return static_cast<int>(run_gemv(a, tile, nullptr, clusters));
}
