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
// * Cluster (any P; the strided b-legs and most 1x1s): a block of two
//   warpgroups on a 64-row tile of the plan's 64 or 128 columns (64 a
//   warpgroup, both on one A), s8 wgmma m64n64k32 (wgmma_s8.cuh's
//   instruction and 128-byte swizzle); a tile's K splits are the blocks of
//   one thread-block cluster (cluster dims (1, splits, 1), at most
//   kClusterMax, the portable size; one K range is a cluster of one). Each
//   thread owns a quarter of one row: the block takes its 64 rows' max |x|
//   over its own K range (no atomics), and the cluster exchanges these
//   through distributed shared memory into each row's whole maximum (a max
//   is exact in any order). Each block then quantizes its K range once, in
//   spans of kSpan k held in shared memory as wgmma's K-major A, beside its
//   columns' weights staged K-major (16 k rows of four columns a thread,
//   byte-permuted into the swizzled rows as csrc/winograd_int8.cu stages
//   u_q: no k-contiguous copy, no TMA map; a warp's loads whole 32-byte
//   sectors, its stores conflict-free), and multiplies. Past one split each
//   block leaves its int32 partial tile in its shared memory and, after a
//   cluster barrier, block r adds rows r * 64 / splits .. of every block's
//   partial (exact in any order) and applies the epilogue once an element.
//   No grid barrier, no memset, no workspace, no cooperative launch: what
//   the mma.sync cooperative form (a quantize phase, two grid barriers,
//   int32 partials through device memory) paid at every launch.
// * One pass (Kp <= kOnePassMaxK): one block a 64 x 64 output tile on
//   mma_int8.cuh's s8 mma.sync warp tile, its 64 rows quantized once into
//   shared memory and its 64 weight columns written k-contiguous beside
//   them, no barrier. Kept where the sweep finds it faster: K of one short
//   walk over many rows (tools/chip_split_sweep.py, PERF.md).

#include <stdint.h>

#include "cluster.cuh"
#include "common.cuh"
#include "mma_int8.cuh"
#include "wgmma_s8.cuh"
#include "wgmma_s8_phase.cuh"

namespace {

namespace s8 = wt::s8mma;
namespace q8 = wt::wgs8;
namespace wg = wt::wg;

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
constexpr int kClusterMax = 8;      // K splits of a cluster tile: one portable cluster
constexpr int kClusterStep = 32;    // a cluster split is a multiple of this: one wgmma k step

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

// The max of |v| over a float4 as bits (wgmma_s8.cuh::abs_bits): a NaN
// above every number, so a row with a NaN gets a NaN scale, as torch.amax
// gives the plain version (fmaxf would drop it).
__device__ __forceinline__ unsigned abs_bits4(const float4& v) {
  return max(max(q8::abs_bits(v.x), q8::abs_bits(v.y)), max(q8::abs_bits(v.z), q8::abs_bits(v.w)));
}

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

// --- cluster: the K splits of a tile one thread-block cluster --------------

// A cluster block: two warpgroups on a 64 x kCols output tile (kCols 64:
// the first warpgroup's 64 columns; 128: 64 each), sharing A. Thread t
// owns row t / 4 of A and the float4s 4 i + t % 4 of each 16-k step of it;
// unit (k group, column group) of a weight stage as unit_of gives it.
constexpr int kCThreads = 2 * q8::kWgThreads;
constexpr int kSpan = 256;                  // k of A and B a block stages at once
constexpr int kSpanStages = kSpan / q8::kBK;
constexpr int kStageF4 = q8::kBK / 16;      // float4s of its row a thread stages a stage
constexpr int kLdRed = 2 * q8::kBN + 4;     // ints a row of a partial tile in shared memory
// A span of A (64 x kSpan) and of B (128 columns x kSpan), aligned to the
// swizzle's 1024-byte atom; the partial tile reuses it.
constexpr size_t kClusterSmem =
    1024 + static_cast<size_t>(kSpanStages) * (q8::kABytes + 2 * q8::kBBytes);
static_assert(q8::kBM * kLdRed * 4 + 1024 <= kClusterSmem, "a partial tile fits the span");
static_assert(kCThreads / 4 == q8::kBM, "four threads a row of A");

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

// x's float4 of row p at k (zero past P and K).
__device__ __forceinline__ float4 load_x(const Args& a, int p, int k) {
  return p < a.P && k < a.K
             ? __ldg(reinterpret_cast<const float4*>(a.x + static_cast<size_t>(p) * a.K + k))
             : make_float4(0.f, 0.f, 0.f, 0.f);
}

// One block per (output tile, split), grid (tiles, splits), the splits of a
// tile one cluster (a block's rank is its split). kVec: N % 4 == 0 and the
// weights 4-byte aligned; kCols: the tile's columns, 64 or 128.
template <bool kVec, int kCols>
__global__ void __launch_bounds__(kCThreads, 2) pointwise_int8_cluster(Args a) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  __shared__ unsigned rmax[q8::kBM];
  __shared__ float sc[q8::kBM], rc[q8::kBM];
  int8_t* sa = reinterpret_cast<int8_t*>(dsmem) + ((1024 - (wt::smem_addr(dsmem) & 1023)) & 1023);
  int8_t* sb = sa + kSpanStages * q8::kABytes;  // stage st's slots at st * 2 * kBBytes
  const int tiles_n = (a.N + kCols - 1) / kCols;
  const int p0 = blockIdx.x / tiles_n * q8::kBM, n0 = blockIdx.x % tiles_n * kCols;
  const int split = blockIdx.y;
  const int k0 = split * a.chunk, k1 = min(a.Kp, k0 + a.chunk);
  const int t = threadIdx.x, row = t / 4, p = p0 + row;
  constexpr int kUnits = kCols / 4 * (q8::kBK / 16);  // weight units a stage

  // Pass 1: the max |x| of this thread's row over the block's K range,
  // eight loads in flight, then its four threads' maximum.
  unsigned m = 0u;
  for (int kb = k0 + 4 * (t % 4); kb < k1; kb += 16 * 8) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = kb + 16 * i < k1 ? load_x(a, p, kb + 16 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
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
        v[i] = k < s1 ? load_x(a, p, k) : make_float4(0.f, 0.f, 0.f, 0.f);
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

  const wt::Int8BnEpilogue epi = epilogue(a);
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
  for (int i = t; i < (r1 - r0) * kCols; i += kCThreads) {
    const int r = r0 + i / kCols, c = i % kCols;
    if (p0 + r >= a.P || n0 + c >= a.N) continue;
    const unsigned at = base + 4u * (r * kLdRed + c);
    int v[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      v[q] = q < a.splits ? static_cast<int>(wt::load_rank_u32(at, q)) : 0;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q) sum += v[q];
    epi(p0 + r, n0 + c, sum, sc[r]);
  }
  wt::cluster_sync();  // no block leaves while another reads its partial or its maxima
}

// Launches pointwise_int8_cluster<kVec, kCols> on grid (tiles, splits) in
// clusters of (1, splits, 1), setting its dynamic shared memory limit once
// per device.
template <bool kVec, int kCols>
cudaError_t launch_cluster(const Args& a, int tiles, cudaStream_t s) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(pointwise_int8_cluster<kVec, kCols>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kClusterSmem));
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, a.splits);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = kClusterSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, pointwise_int8_cluster<kVec, kCols>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
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
// kClusterStep, at most kClusterMax). ws, ws_words 4-byte words (may be
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
    const int tiles = (P + q8::kBM - 1) / q8::kBM * ((N + tile - 1) / tile);
    if ((tile != q8::kBN && tile != 2 * q8::kBN) || Kp % s8::kKAlign != 0 ||
        Kp >= K + s8::kKAlign || splits > kClusterMax ||
        (splits > 1 && chunk % kClusterStep != 0) || blocks != tiles * splits)
      return invalid;
    if (tile == q8::kBN)
      e = vec ? launch_cluster<true, q8::kBN>(a, tiles, s)
              : launch_cluster<false, q8::kBN>(a, tiles, s);
    else
      e = vec ? launch_cluster<true, 2 * q8::kBN>(a, tiles, s)
              : launch_cluster<false, 2 * q8::kBN>(a, tiles, s);
    return static_cast<int>(e);
  } else {
    return invalid;
  }
  return static_cast<int>(cudaGetLastError());
}
