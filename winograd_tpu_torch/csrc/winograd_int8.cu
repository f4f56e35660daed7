// Int8 fused 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) by Winograd
// F(2,3): per 4x4 input tile t (a row) and tile position p,
//   V[t, p, :] = (Bt d Bt^T)[p] over the input channels, in FP64, each value
//                rounded to float once;
//   s[t, p]   = a per-row symmetric scale of V[t, p, :], q = clamp(rint(V / s));
//   M[t, p, o] = float(sum_c q[t, p, c] * u_q[p, c, o]) * (s[t, p] * s_u[p, o]);
//   Y = At M At^T in FP64, rounded once; y = Y * scale + bias (+ ReLU),
// stored clipped at the right and bottom edges of an odd map. u_q (16, Cin,
// Cout) int8 and s_u (16, Cout) are quantize_winograd_filter's per-position
// per-column weights. The row scale follows the JAX kernel's two branches,
// chosen as it chooses them (n_j = output-channel tiles of 128):
//   * Cout <= 128 (one output tile): a scale per group of cg = 128 input
//     channels (cg = Cin when 128 does not divide Cin), s = max|V| / 127 (1
//     for an all-zero group); each group's product is dequantized on its own
//     and the groups' f32 results are added in group order;
//   * Cout > 128 (the quantized V stash): one scale over all of Cin,
//     s = (max|V|, or 1 for an all-zero row) / 127, and one int32 sum over
//     all groups before one dequantization.
//
// Replaces: winograd_tpu/kernels/quantized.py::_winograd_int8_kernel
// (conv3x3_bn_winograd_int8_pallas). On the int8 ResNet-34 path it runs the
// stride-1 3x3s at 28x28x128 (one output tile) and 14x14x256 (the stash).
//
// Bound on the H100: at 28x28x128 and 14x14x256 the 16 position products
// are 51 M int8 MACs, 0.05 us at 1979 TOPS; x and out in f32 and the int8
// filter take 0.3-0.4 us at 3.35 TB/s: bound by bytes.
//
// Design: the 16 positions are 16 independent int8 GEMMs, (T, Cin) x (Cin,
// Cout), and a row's scale needs only its own position's V. So a work item
// is (a block of kTiles tiles, one position p, a block of kCols output
// channels): it computes V[p] of its tiles over Cin straight from x
// (the four pixels that position reads, with wt::sandwich's FP64 FMA chain
// for that element, so no value can differ from the full transform's), once,
// into shared memory; each warp reduces two rows' |V| (whole row or per
// group) and quantizes them once, k-contiguous; the item's slice of u_q[p]
// is turned k-contiguous as it is staged (four weight rows at a time, byte
// permutes, as csrc/pointwise_int8.cu does), so the wrapper keeps the JAX
// layout; each warp multiplies its 16 columns on mma.sync.m16n8k32 s8
// (mma_int8.cuh's fragments), one int32 sum a group, and dequantizes into
// M (16, T, Cout) in f32 in the workspace. The items of all 16 positions
// are dealt to a resident cooperative grid; after one grid barrier
// (grid_sync.cuh) the grid runs At M At^T, BN and ReLU once per (tile,
// output channel): one launch. At N=1 that is 208 items at 28x28x128 and
// 128 at 14x14x256, one a block; V[p] is transformed once per column block
// (once at Cout <= 128, twice at 256). Half as many columns an item read x
// twice as often and ran 4-38% slower; a form in which a block owned its
// tiles for all 16 positions, with M in shared memory and no barrier, ran
// 1.6-9x slower (tools/chip_split_sweep.py, PERF.md). Shared memory holds
// one span of K: at most kChunk channels of V, of the quantized rows and of
// the weight columns (109 KB, so two blocks an SM fit at any Cin); a wider
// Cin is walked in spans (position_item), the served widths (<= 256) in one.
// The host's plan (kernels/quantized.py::winograd_int8_plan) sets the grid
// and the span; this entry checks them.
// The transforms and At run in FP64 and round once, the scale is an IEEE
// division, the dequantization and BN round each multiply and add on its own
// in the plain version's order, and the groups' parts are added in group
// order: the kernel equals kernels/quantized.py::
// conv3x3_bn_winograd_int8_plain to the bit.

#include <stdint.h>

#include "common.cuh"
#include "mma_int8.cuh"
#include "winograd.cuh"

namespace {

namespace s8 = wt::s8mma;

constexpr int kTiles = 16;   // Winograd tiles an item: the rows of one m16 fragment
constexpr int kCols = 128;   // output channels an item: kFrags n8 fragments a warp
constexpr int kThreads = s8::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kFrags = kCols / 8 / kWarps;
constexpr int kRows = kTiles / kWarps;  // rows a warp quantizes
constexpr int kBlocksPerSm = 2;
constexpr int kPad = 16;  // bytes past a span in a quantized row: 32 distinct banks a fragment
constexpr int kChunk = 512;  // K an item stages at once, at most (a span)
constexpr int kGroup = 128;  // input channels a row scale covers in the group branch
constexpr int kBatch = 4;  // weight items a thread has in flight at once
constexpr int kBatchV = kBatch * kTiles / (kCols / 4);  // and V items, in the same ratio

static_assert(kCols == 8 * kFrags * kWarps, "a warp owns kFrags n8 fragments of the columns");
static_assert(kTiles == kRows * kWarps, "a warp quantizes whole rows");
static_assert(kCols / 4 % kTiles == 0 && kBatch * kTiles % (kCols / 4) == 0,
              "a batch holds whole V items beside its weight items");

struct Args {
  const float* x;     // (N, H, W, Cin)
  const int8_t* uq;   // (16, Cin, Cout)
  const float* su;    // (16, Cout)
  const float* scale;
  const float* bias;
  float* out;
  float* m;           // M (16, T, Cout)
  unsigned int* bar;  // the grid barrier
  int N, H, W, Cin, Cout, relu, stash;
  int groups, cg;     // the row scales' groups of cg channels (one in the stash)
  int Kp, tw, hw, T, tile_blocks, col_blocks;
  bool xvec, uvec;    // x read as float4s; u_q's rows read as words
};

// Shared memory of an item, in bytes, for spans of `chunk` of K holding
// `groups` scale groups: V of its rows over a span in f32, the rows
// quantized, the weight columns k-contiguous, the rows' scales.
struct Layout {
  int ld, aq, bq, sc, bytes;
  __host__ __device__ Layout(int chunk, int groups) {
    ld = chunk + kPad;
    aq = kTiles * chunk * 4;
    bq = aq + kTiles * ld;
    sc = bq + kCols * ld;
    bytes = sc + (kTiles * groups * 4 + 15) / 16 * 16;
  }
};

// Tile t's output corner (n, oy0, ox0).
__device__ __forceinline__ void tile_corner(const Args& a, int t, int& n, int& oy0, int& ox0) {
  n = t / a.hw;
  const int r = t - n * a.hw;
  oy0 = r / a.tw * 2;
  ox0 = r % a.tw * 2;
}

// Channels c .. c+3 of pixel (n, y, x), zero outside the map and past Cin.
__device__ __forceinline__ float4 pixel4(const Args& a, int n, int y, int x, int c) {
  if (y < 0 || y >= a.H || x < 0 || x >= a.W) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* px = a.x + (static_cast<size_t>(n * a.H + y) * a.W + x) * a.Cin + c;
  if (a.xvec) return __ldg(reinterpret_cast<const float4*>(px));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < a.Cin ? __ldg(px + e) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The two nonzero entries of row i of Bt, in column order.
struct BtRow {
  int k[2];
  double c[2];
  __device__ __forceinline__ explicit BtRow(int i) {
    bool first = true;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = wt::Wino<2>::bt(ii, j);
        if (v == 0.f || ii != i) continue;
        if (first) {
          k[0] = j;
          c[0] = v;
        } else {
          k[1] = j;
          c[1] = v;
        }
        first = false;
      }
  }
};

// V[pi][pj] of one channel from its four pixels d[k][l] (k over the rows,
// l over the columns that Bt's rows pi and pj select): wt::sandwich<2, 4,
// false>'s FMA chain for that element, zero terms skipped, so equal to the
// full transform's value.
__device__ __forceinline__ float v_of(const BtRow& rp, const BtRow& cp, const float (&d)[2][2]) {
  double t[2];
#pragma unroll
  for (int l = 0; l < 2; ++l)
    t[l] = fma(rp.c[1], static_cast<double>(d[1][l]),
               fma(rp.c[0], static_cast<double>(d[0][l]), 0.0));
  return static_cast<float>(fma(cp.c[1], t[1], fma(cp.c[0], t[0], 0.0)));
}

// The row scale of a row (or group) whose largest |V| is m: the stash's
// (m, or 1 for an all-zero row) / 127, else scale_from_max.
__device__ __forceinline__ float row_scale(const Args& a, float m) {
  return a.stash ? (m == 0.f ? 1.f : m) / 127.f : wt::scale_from_max(m);
}

// The span [c0, c0 + len) of K of the item: V[p] of every (row, four
// channels) into vf (rows of len floats), zero past T and Cin, and, where
// kWeights, u_q[p]'s slice k-contiguous into bq (items of four k by four
// columns), in batches of kBatch weight items and kBatchV V items a thread:
// every weight word and pixel of a batch is requested before any is used,
// so a thread waits on memory once a batch (once an item at len <= 256).
template <bool kWeights>
__device__ __forceinline__ void stage_span(const Args& a, const Layout& L, const BtRow& rp,
                                           const BtRow& cp, const int8_t* up, int t0, int co0,
                                           int c0, int len, float* vf, int8_t* bq) {
  const int q4 = len / 4;
  const int bitems = q4 * (kCols / 4), vitems = kTiles * q4;
  // Both kinds run out in the same batch: vitems / bitems = kBatchV / kBatch.
  for (int b0 = threadIdx.x, v0 = threadIdx.x; v0 < vitems;
       b0 += kBatch * kThreads, v0 += kBatchV * kThreads) {
    unsigned w[kBatch][4];
    float4 d4[kBatchV][2][2];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = b0 + u * kThreads;
      if (!kWeights || i >= bitems) break;
      const int kq = i / (kCols / 4), nq = i % (kCols / 4);
      if (a.uvec)
        s8::rows4<true>(up, a.Cin, a.Cout, c0 + 4 * kq, co0 + 4 * nq, w[u]);
      else
        s8::rows4<false>(up, a.Cin, a.Cout, c0 + 4 * kq, co0 + 4 * nq, w[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatchV; ++u) {
      const int i = v0 + u * kThreads;
      if (i >= vitems) break;
      const int r = i / q4, c = c0 + 4 * (i - r * q4);
      int n, y0, x0;
      tile_corner(a, t0 + r, n, y0, x0);
      const bool live = t0 + r < a.T && c < a.Cin;
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int l = 0; l < 2; ++l)
          d4[u][k][l] = live ? pixel4(a, n, y0 - 1 + rp.k[k], x0 - 1 + cp.k[l], c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = b0 + u * kThreads;
      if (!kWeights || i >= bitems) break;
      const int kq = i / (kCols / 4), nq = i % (kCols / 4);
      unsigned cw[4];
      s8::transpose4(w[u], cw);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<unsigned*>(bq + (4 * nq + e) * L.ld + 4 * kq) = cw[e];
    }
#pragma unroll
    for (int u = 0; u < kBatchV; ++u) {
      const int i = v0 + u * kThreads;
      if (i >= vitems) break;
      float v[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        float d[2][2];
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int l = 0; l < 2; ++l) d[k][l] = reinterpret_cast<const float*>(&d4[u][k][l])[ch];
        v[ch] = v_of(rp, cp, d);
      }
      reinterpret_cast<float4*>(vf)[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// M[p] of the item's kTiles tiles from t0 and kCols output channels from
// co0 through store(row, column, value), rows and columns relative to the
// item (the caller skips none: store checks t < T and co < Cout). With
// kSpans the item walks Kp in spans of `span` (< Kp) holding `span_groups`
// scale groups each, else all of Kp is one span (the served widths). Each
// span's V and weight columns are staged, its rows quantized and
// multiplied. A group of kGroup channels lies in one span, so the group
// branch scales, multiplies and dequantizes each group within its span and
// adds the groups' parts in group order across spans. A scale over the
// whole row (the stash, or one group of Cin) needs max|V| over every span
// before the first product: past one span the item first walks its spans
// for the maxima alone, then again for the products (V computed twice, the
// same FMA chain each time), and its one int32 sum runs on across spans.
template <bool kSpans, class Store>
__device__ __forceinline__ void position_item(const Args& a, const Layout& L, int span,
                                              int span_groups, int p, int t0, int co0,
                                              int8_t* smem, const Store& store) {
  float* vf = reinterpret_cast<float*>(smem);
  int8_t* aq = smem + L.aq;
  int8_t* bq = smem + L.bq;
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool whole_row = a.stash || a.groups == 1;  // one scale over all of Cin
  const int chunk = kSpans ? span : a.Kp;
  const int gspan = kSpans ? span_groups : a.groups;
  __syncthreads();  // the previous item is done with shared memory
  // The weight scales of the thread's output columns, in flight from here.
  const int row0 = lane / 4, col0 = warp * 8 * kFrags + 2 * (lane % 4);
  float su[kFrags][2];
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      su[f][e] = __ldg(a.su + p * a.Cout + min(co0 + col0 + 8 * f + e, a.Cout - 1));

  const int8_t* up = a.uq + static_cast<size_t>(p) * a.Cin * a.Cout;
  const BtRow rp(p / 4), cp(p % 4);
  // A warp's kRows rows side by side: V in f32 and quantized.
  const float4* row[kRows];
  unsigned* dst[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
    dst[rr] = reinterpret_cast<unsigned*>(aq + (warp + rr * kWarps) * L.ld);

  // Past one span, a whole-row scale from the maxima of every span.
  float whole[kRows];
  if (kSpans && whole_row) {
    float m[kRows] = {};
    for (int c0 = 0; c0 < a.Kp; c0 += chunk) {
      const int len = min(chunk, a.Kp - c0);
      if (c0 > 0) __syncthreads();  // the span before is reduced
      stage_span<false>(a, L, rp, cp, up, t0, co0, c0, len, vf, bq);
      __syncthreads();
      for (int j = lane; j < len / 4; j += 32)
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          m[rr] = s8::abs_max4(m[rr], reinterpret_cast<const float4*>(vf)[(warp + rr * kWarps) *
                                                                           (len / 4) + j]);
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) whole[rr] = row_scale(a, wt::warp_max(m[rr]));
  }

  float out[kFrags][4];
  int acc[kFrags][4];
  for (int c0 = 0; c0 < a.Kp; c0 += chunk) {
    const int len = min(chunk, a.Kp - c0), q4 = len / 4;
    if (c0 > 0 || kSpans && whole_row) __syncthreads();  // the last span is done with smem
    stage_span<true>(a, L, rp, cp, up, t0, co0, c0, len, vf, bq);
    __syncthreads();

    // Each row's scale per group (or over the whole row) and its int8
    // values.
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      row[rr] = reinterpret_cast<const float4*>(vf + (warp + rr * kWarps) * len);
    const int gq = whole_row ? q4 : a.cg / 4;  // float4s a group
    for (int g = 0; g * gq < q4; ++g) {
      float s[kRows];
      if (kSpans && whole_row) {
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) s[rr] = whole[rr];
      } else {
        float m[kRows] = {};
        for (int j = g * gq + lane; j < (g + 1) * gq; j += 32)
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) m[rr] = s8::abs_max4(m[rr], row[rr][j]);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) s[rr] = row_scale(a, wt::warp_max(m[rr]));
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        if (lane == 0) sc[(warp + rr * kWarps) * gspan + g] = s[rr];
      for (int j = g * gq + lane; j < (g + 1) * gq; j += 32)
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) dst[rr][j] = s8::quantize4(row[rr][j], s[rr]);
    }
    __syncthreads();

    // The warp's 16 x (8 kFrags) outputs, an int32 sum a group (one over
    // the whole row, across spans), dequantized and added in group order.
    const int klen = whole_row ? len : a.cg;
    for (int g = 0; g * klen < len; ++g) {
      if (!whole_row || c0 == 0)
#pragma unroll
        for (int f = 0; f < kFrags; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][e] = 0;
      for (int ks = g * klen; ks < (g + 1) * klen; ks += 32) {
        unsigned fa[4];
        s8::frag_a(aq, L.ld, 0, ks, fa);
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          unsigned fb[2];
          s8::frag_b(bq, L.ld, warp * 8 * kFrags + 8 * f, ks, fb);
          s8::mma(acc[f], fa, fb);
        }
      }
      if (whole_row && c0 + len < a.Kp) continue;  // the row's sum runs on
      const bool first = whole_row || c0 + g * klen == 0;
#pragma unroll
      for (int f = 0; f < kFrags; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float part =
              wt::dequant(acc[f][e], sc[(row0 + e / 2 * 8) * gspan + g], su[f][e % 2]);
          out[f][e] = first ? part : __fadd_rn(out[f][e], part);
        }
    }
    if (!kSpans) break;
  }
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) store(row0 + e / 2 * 8, col0 + 8 * f + e % 2, out[f][e]);
}

// y = At M At^T of tile t at output channel co, rounded once, then BN (+
// ReLU), stored clipped at the map's edges.
__device__ __forceinline__ void inverse(const Args& a, int t, int co, const float (&mp)[16]) {
  double md[4][4];
#pragma unroll
  for (int p = 0; p < 16; ++p) md[p / 4][p % 4] = mp[p];
  double y[2][2];
  wt::sandwich<2, 2, true>(md, y);
  int n, oy0, ox0;
  tile_corner(a, t, n, oy0, ox0);
  const float s = __ldg(a.scale + co), b = __ldg(a.bias + co);
#pragma unroll
  for (int oi = 0; oi < 2; ++oi)
#pragma unroll
    for (int oj = 0; oj < 2; ++oj) {
      const int oy = oy0 + oi, ox = ox0 + oj;
      if (oy < a.H && ox < a.W) {
        float val = wt::bn_rn(static_cast<float>(y[oi][oj]), s, b);
        if (a.relu) val = wt::relu(val);
        a.out[(static_cast<size_t>(n * a.H + oy) * a.W + ox) * a.Cout + co] = val;
      }
    }
}

// chunk: the K a span stages (Kp itself without kSpans). It stays out of
// Args: one more field there, before Kp, cost the one-span path 1-4% at
// the served widths (tools/chip_split_sweep.py --ab, PERF.md).
template <bool kSpans>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) winograd_int8_kernel(Args a,
                                                                               int chunk) {
  extern __shared__ __align__(16) int8_t smem[];
  const int gspan = a.groups == 1 ? 1 : chunk / a.cg;
  const Layout L = kSpans ? Layout(chunk, gspan) : Layout(a.Kp, a.groups);
  const int items = 16 * a.tile_blocks * a.col_blocks;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int p = item % 16, tc = item / 16;
    const int t0 = tc / a.col_blocks * kTiles, co0 = tc % a.col_blocks * kCols;
    position_item<kSpans>(a, L, chunk, gspan, p, t0, co0, smem, [&](int r, int c, float v) {
      if (t0 + r < a.T && co0 + c < a.Cout)
        a.m[(static_cast<size_t>(p) * a.T + t0 + r) * a.Cout + co0 + c] = v;
    });
  }
  wt::grid_sync(a.bar);
  const size_t tc = static_cast<size_t>(a.T) * a.Cout;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < tc;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    float mp[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) mp[p] = __ldcg(a.m + p * tc + i);
    inverse(a, static_cast<int>(i / a.Cout), static_cast<int>(i % a.Cout), mp);
  }
}

const void* kernel(bool spans) {
  return spans ? reinterpret_cast<const void*>(winograd_int8_kernel<true>)
               : reinterpret_cast<const void*>(winograd_int8_kernel<false>);
}

// The blocks of the cooperative grid that the current device holds
// resident with `bytes` of dynamic shared memory, at most kBlocksPerSm an
// SM, after letting the instantiation take that much (the attribute only
// ever grows, so a size allowed once stays allowed); 0 on error. Computed
// once per device, instantiation and size: the served layers alternate
// between two sizes.
int resident_blocks(bool spans, int bytes) {
  constexpr int kSizes = 8;
  static int allowed[64][2] = {};
  static int cache[64][2][kSizes][2] = {};  // [device][spans][slot] = {bytes, blocks}
  static int next[64][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  for (int i = 0; i < kSizes; ++i)
    if (cache[dev][spans][i][0] == bytes) return cache[dev][spans][i][1];
  if (bytes > 48 * 1024 && bytes > allowed[dev][spans]) {
    if (cudaFuncSetAttribute(kernel(spans), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
      return 0;
    allowed[dev][spans] = bytes;
  }
  const int blocks = cooperative_grid(kernel(spans), bytes, kThreads, kBlocksPerSm);
  if (blocks > 0) {
    int* slot = cache[dev][spans][next[dev][spans]++ % kSizes];
    slot[0] = bytes;
    slot[1] = blocks;
  }
  return blocks;
}

}  // namespace

// The host's plan (kernels/quantized.py::winograd_int8_plan): Kp, Cin
// padded to a multiple of s8::kKAlign; `tiles` and `cols`, an item's
// Winograd tiles and output channels (kTiles, kCols); `chunk`, the K an
// item stages at once (Kp itself, or past one span a multiple of kGroup,
// at most kChunk: shared memory stops growing with Cin there); `blocks`,
// the cooperative grid (at most what the device holds resident). stash = 1
// takes the Cout > 128 branch (one scale per row over all of Cin, the JAX
// kernel's quantized V stash), 0 the per-group branch. ws, ws_words 4-byte
// words: the grid barrier at word 0 and M (16, T, Cout) in f32 from word
// kWorkspaceAlign, T = N * ceil(H / 2) * ceil(W / 2).
extern "C" int winograd_int8_conv3x3_bn(const float* x, const int8_t* uq, const float* su,
                                        const float* scale, const float* bias, float* out,
                                        float* ws, long long ws_words, int N, int H, int W,
                                        int Cin, int Cout, int stash, int relu, int Kp, int tiles,
                                        int cols, int chunk, int blocks, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || tiles != kTiles || cols != kCols ||
      Kp != (Cin + s8::kKAlign - 1) / s8::kKAlign * s8::kKAlign || blocks <= 0 || chunk <= 0 ||
      chunk > kChunk || chunk > Kp || chunk < Kp && chunk % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const int cg = Cin % kGroup == 0 ? kGroup : Cin;
  const int groups = stash ? 1 : Cin / cg;
  Args a{x, uq, su, scale, bias, out, ws + kWorkspaceAlign, reinterpret_cast<unsigned int*>(ws),
         N, H, W, Cin, Cout, relu, stash, groups, cg, Kp, tw, th * tw, N * th * tw, 0,
         (Cout + kCols - 1) / kCols,
         Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0,
         Cout % 4 == 0 && reinterpret_cast<uintptr_t>(uq) % 4 == 0};
  a.tile_blocks = (a.T + kTiles - 1) / kTiles;
  if (ws_words < static_cast<long long>(kWorkspaceAlign) + 16LL * a.T * Cout)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = Layout(chunk, groups == 1 ? 1 : chunk / cg).bytes;
  const bool spans = chunk < Kp;
  const int resident = resident_blocks(spans, bytes);
  if (resident <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(a.bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a, &chunk};
  e = cudaLaunchCooperativeKernel(kernel(spans), dim3(blocks), dim3(kThreads), args, bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
