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
// filter take 0.3-0.4 us at 3.35 TB/s: bound by bytes. At N=1 what a launch
// costs is its fixed part: the launch, the first loads, and handing the 16
// positions' M to the inverse.
//
// Design: the 16 positions are 16 independent int8 GEMMs, and a row's scale
// needs only its own position's V. A work item is (a block of kNT tiles, a
// block of kCols = 64 kMB output channels: 8 x 128, 16 x 128 or 32 x 256)
// over all 16 positions, and it is
// one thread-block cluster of kCluster blocks: each block runs two
// positions, one a warpgroup. A warpgroup computes V[p] of its tiles over
// Cin straight from x (the four pixels that position reads, wt::sandwich's
// FP64 FMA chain for that element, so no value differs from the full
// transform's), once; its warps quantize the rows (per group or over the
// whole row) into the B operand of s8 wgmma.mma_async m64nNk32 (N = kNT,
// K-major with the 128-byte swizzle); the item's slice of u_q[p] is the A
// operand (the output channels on wgmma's 64 rows: an item's 8-32 tiles
// fill N, where an m64 tile of Winograd tiles would leave the card empty
// at N=1), turned k-contiguous as it is staged: a thread reads 16 k rows of
// four columns from u_q (the JAX layout, which the wrapper keeps) and
// byte-permutes them into four 16-byte chunks of the swizzled rows, eight
// lanes of a phase on eight distinct chunks (no bank conflict). Stages of
// kBK = 128 of K run on a ring of two slots, the next stage's weights loaded
// and permuted while the tensor cores multiply the last. A stage is one
// quantization group: the group branch dequantizes each stage's int32 sums
// into the f32 sum in group order; the stash keeps one int32 sum over all
// of K. The warpgroup writes M[p] of its item into its shared memory;
// after a cluster barrier the cluster's blocks apply At M At^T, BN and ReLU
// to their share of the item's (tile, channel) pairs, reading the 16
// positions' M from the cluster's shared memory. One launch, no grid
// barrier, no workspace, no memset, no cooperative launch: what the
// mma.sync design (a grid barrier between the items and the inverse, M
// through L2) paid at every launch. Shared memory holds one span of K of
// V (at most kChunk channels); a wider Cin is walked in spans
// (position_item). The host's plan (kernels/quantized.py::
// winograd_int8_plan) sets the item shape, the span and the grid; this
// entry checks them.
// Why the weights are not csrc/wgmma_s8.cuh's TMA boxes: s8 wgmma reads
// both operands K-major, and u_q is Cout-contiguous (the JAX layout the
// wrapper keeps), so a box would land in the wrong order; a first phase
// that transposed u_q would need the grid barrier this design removes.
// The transforms and At run in FP64 and round once, the scale is an IEEE
// division, the dequantization and BN round each multiply and add on its own
// in the plain version's order, and the groups' parts are added in group
// order: the kernel equals kernels/quantized.py::
// conv3x3_bn_winograd_int8_plain to the bit. The row maxima keep a NaN
// (max.NaN): a NaN in x makes the scale, M and outputs of the rows whose
// transform reads it NaN; the transforms skip zero coefficients, as the
// plain version's and the JAX kernel's do, so the NaNs land where theirs do.

#include <stdint.h>

#include "cluster.cuh"
#include "common.cuh"
#include "mma_int8.cuh"
#include "wgmma_tile.cuh"
#include "winograd.cuh"

namespace {

namespace s8 = wt::s8mma;
namespace wg = wt::wg;

constexpr int kCluster = 8;      // blocks an item: its 16 positions, two a block
constexpr int kWarpgroups = 2;   // a block's, one position each
constexpr int kWgThreads = 128;
constexpr int kThreads = kWarpgroups * kWgThreads;
constexpr int kBK = 128;         // K of a stage: one 128-byte swizzled row, one scale group
constexpr int kChunk = 512;      // K an item stages at once, at most (a span)
constexpr int kGroup = 128;      // input channels a row scale covers in the group branch
constexpr int kBatchV = 2;       // V items a thread has in flight at once
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take on an H100
static_assert(kCluster * kWarpgroups == 16, "a cluster holds the 16 positions");
static_assert(kBK == kGroup, "a stage is one scale group");

struct Args {
  const float* x;     // (N, H, W, Cin)
  const int8_t* uq;   // (16, Cin, Cout)
  const float* su;    // (16, Cout)
  const float* scale;
  const float* bias;
  float* out;
  int N, H, W, Cin, Cout, relu, stash;
  int groups, cg;     // the row scales' groups of cg channels (one in the stash)
  int Kp, tw, hw, T, col_blocks;
  bool xvec, uvec;    // x read as float4s; u_q's rows read as words
};

// A warpgroup's shared memory, in bytes from its 1024-aligned base, for
// items of nt tiles and cols channels and spans of `chunk` of K holding
// `gspan` scale groups: the two weight slots (cols x kBK bytes each,
// K-major, swizzled), the quantized rows (a kBK block of K after another,
// nt x kBK bytes each), V of the span in f32 (later M, nt rows of ldm
// floats), the rows' scales. A block holds two and 1024 bytes to align
// them.
struct Layout {
  int w, vq, vf, sc, ldm, wg_bytes, bytes;
  __host__ __device__ Layout(int nt, int cols, int chunk, int gspan) {
    const int kblocks = (chunk + kBK - 1) / kBK;
    const int v_bytes = nt * chunk * 4;
    ldm = cols + 4;  // M's rows: the stores of a warp's fragment hit 32 banks
    const int m_bytes = nt * ldm * 4;
    w = 0;
    vq = 2 * cols * kBK;
    vf = vq + kblocks * nt * kBK;
    sc = vf + ((v_bytes > m_bytes ? v_bytes : m_bytes) + 15) / 16 * 16;
    wg_bytes = (sc + nt * gspan * 4 + 1023) / 1024 * 1024;
    bytes = 1024 + kWarpgroups * wg_bytes;
  }
};

// ---- PTX wrappers -----------------------------------------------------------

template <int kN>
struct S8Acc;  // a warpgroup's m64 x kN int32 accumulator: kN / 2 a thread
template <>
struct S8Acc<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], uint64_t a, uint64_t b, int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(add));
  }
};
template <>
struct S8Acc<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t a, uint64_t b, int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7])
        : "l"(a), "l"(b), "r"(add));
  }
};
template <>
struct S8Acc<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t a, uint64_t b, int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(add));
  }
};

template <int kN>
__device__ __forceinline__ void fence_acc(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The warpgroup's named barrier (1 + its index; 0 is __syncthreads').
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + threadIdx.x / kWgThreads), "n"(kWgThreads)
               : "memory");
}

using wt::cluster_rank;
using wt::cluster_sync;
using wt::load_rank;

// ---- the arithmetic ------------------------------------------------------------

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

// max |v| over m and four values, and the warp's max, NaN where any value
// is NaN: a row with a NaN gets a NaN scale and a NaN M, as torch.amax
// gives the plain version (the same bits as fmaxf on every other input).
__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return wt::max_nan(wt::max_nan(m, wt::max_nan(fabsf(v.x), fabsf(v.y))),
                     wt::max_nan(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = wt::max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The row scale of a row (or group) whose largest |V| is m: the stash's
// (m, or 1 for an all-zero row) / 127, else scale_from_max.
__device__ __forceinline__ float row_scale(const Args& a, float m) {
  return a.stash ? (m == 0.f ? 1.f : m) / 127.f : wt::scale_from_max(m);
}

// V[p] of the span [c0, c0 + len) of K for nt rows from t0 into vf (rows of
// len floats, zero past T and Cin): every (row, four channels) an item, the
// pixels of kBatchV items requested before any is used.
__device__ __forceinline__ void stage_v(const Args& a, const BtRow& rp, const BtRow& cp, int nt,
                                        int t0, int c0, int len, float* vf) {
  const int q4 = len / 4, items = nt * q4;
  for (int v0 = threadIdx.x % kWgThreads; v0 < items; v0 += kBatchV * kWgThreads) {
    float4 d4[kBatchV][2][2];
#pragma unroll
    for (int u = 0; u < kBatchV; ++u) {
      const int i = v0 + u * kWgThreads;
      if (i >= items) break;
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
    for (int u = 0; u < kBatchV; ++u) {
      const int i = v0 + u * kWgThreads;
      if (i >= items) break;
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

// The weights of a stage, kMB units a thread: unit u (u = thread + i *
// kWgThreads) is the 16 k from kb + 16 (u % 8) of output channels co0 + 4
// (u / 8) .. +3, read as 16 words (one a k row, four channels a word; zero
// past Cin and Cout).
template <int kMB>
__device__ __forceinline__ void load_weights(const Args& a, const int8_t* up, int co0, int kb,
                                             unsigned (&r)[kMB][16]) {
#pragma unroll
  for (int i = 0; i < kMB; ++i) {
    const int u = threadIdx.x % kWgThreads + i * kWgThreads;
    const int k = kb + 16 * (u % 8), n = co0 + 4 * (u / 8);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned* w = &r[i][4 * q];
      if (a.uvec)
        s8::rows4<true>(up, a.Cin, a.Cout, k + 4 * q, n, *reinterpret_cast<unsigned(*)[4]>(w));
      else
        s8::rows4<false>(up, a.Cin, a.Cout, k + 4 * q, n, *reinterpret_cast<unsigned(*)[4]>(w));
    }
  }
}

// The units of load_weights as A's rows of the slot: channel o = 4 (u / 8)
// + e's row holds its 16 k as 16-byte chunk u % 8, stored at chunk (u % 8)
// ^ (o % 8) (the 128-byte swizzle). The eight lanes of a store phase hold
// eight distinct chunks.
template <int kMB>
__device__ __forceinline__ void store_weights(int8_t* slot, const unsigned (&r)[kMB][16]) {
#pragma unroll
  for (int i = 0; i < kMB; ++i) {
    const int u = threadIdx.x % kWgThreads + i * kWgThreads;
    const int j = u % 8, o0 = 4 * (u / 8);
    unsigned c[4][4];  // [channel][word of 4 k]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned cw[4];
      s8::transpose4(*reinterpret_cast<const unsigned(*)[4]>(&r[i][4 * q]), cw);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e][q] = cw[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = o0 + e;
      *reinterpret_cast<uint4*>(slot + o * kBK + ((j ^ (o & 7)) << 4)) =
          make_uint4(c[e][0], c[e][1], c[e][2], c[e][3]);
    }
  }
}

// M[p] of the item's kNT tiles from t0 and kCols = 64 kMB output channels
// from co0, into the warpgroup's shared memory (rows of L.ldm floats, at
// L.vf). With kSpans the item walks Kp in spans of `span` (< Kp) holding
// `span_groups` scale groups each, else all of Kp is one span (the served
// widths). Each span's V is staged, its rows quantized into the B operand,
// and its stages of kBK multiplied as their weights arrive. A group of
// kGroup channels is one stage, so the group branch dequantizes each stage's
// sums and adds the groups' parts in group order across spans. A scale
// over the whole row (the stash, or one group of Cin) needs max|V| over
// every span before the first product: past one span the item first walks
// its spans for the maxima alone, then again for the products (V computed
// twice, the same FMA chain each time), and its one int32 sum runs on
// across spans.
template <int kNT, int kMB, bool kSpans>
__device__ __forceinline__ void position_item(const Args& a, const Layout& L, int span,
                                              int span_groups, int p, int t0, int co0,
                                              unsigned char* sm) {
  constexpr int kCols = 64 * kMB;
  constexpr int kRows = kNT / 4;  // rows a warp quantizes
  constexpr int kAcc = kNT / 2;   // a thread's sums of an m64 block
  int8_t* slots = reinterpret_cast<int8_t*>(sm + L.w);
  int8_t* vq = reinterpret_cast<int8_t*>(sm + L.vq);
  float* vf = reinterpret_cast<float*>(sm + L.vf);
  float* sc = reinterpret_cast<float*>(sm + L.sc);
  const int warp = threadIdx.x % kWgThreads / 32, lane = threadIdx.x % 32;
  // 256-channel items (kMB 4) are only taken in the stash (the entry
  // checks it): one scale over all of Cin there.
  const bool whole_row = kMB > 2 || a.stash || a.groups == 1;
  const int chunk = kSpans ? span : a.Kp;
  const int gspan = kSpans ? span_groups : a.groups;
  // The weight scales of the thread's accumulator rows (output channels
  // 64 mb + 16 warp + lane / 4 + 8 h), in flight from here.
  float su[kMB][2];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      su[mb][h] = __ldg(a.su + p * a.Cout +
                        min(co0 + 64 * mb + 16 * warp + lane / 4 + 8 * h, a.Cout - 1));

  const int8_t* up = a.uq + static_cast<size_t>(p) * a.Cin * a.Cout;
  const BtRow rp(p / 4), cp(p % 4);

  // Past one span, a whole-row scale from the maxima of every span.
  float whole[kRows];
  if (kSpans && whole_row) {
    float m[kRows] = {};
    for (int c0 = 0; c0 < a.Kp; c0 += chunk) {
      const int len = min(chunk, a.Kp - c0);
      wg_sync();  // the span before is reduced
      stage_v(a, rp, cp, kNT, t0, c0, len, vf);
      wg_sync();
      for (int j = lane; j < len / 4; j += 32)
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          m[rr] = abs_max4(m[rr], reinterpret_cast<const float4*>(vf)[(warp + rr * 4) *
                                                                           (len / 4) + j]);
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) whole[rr] = row_scale(a, warp_max(m[rr]));
  }

  int acc[kMB][kAcc] = {};
  float out[kMB][kAcc];
  unsigned wr[kMB][16];
  for (int c0 = 0; c0 < a.Kp; c0 += chunk) {
    const int len = min(chunk, a.Kp - c0), q4 = len / 4;
    const int stages = (len + kBK - 1) / kBK;
    load_weights<kMB>(a, up, co0, c0, wr);  // in flight while V is staged
    if (c0 > 0 || kSpans && whole_row) wg_sync();  // the last span is done with smem
    stage_v(a, rp, cp, kNT, t0, c0, len, vf);
    store_weights<kMB>(slots, wr);
    wg_sync();

    // Each row's scale per group (or over the whole row) and its int8
    // values, into the B operand: row r's k at byte k % 16 of chunk
    // (k % kBK / 16) ^ (r % 8) of its kBK block (a warp's lanes on 32
    // distinct words).
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
          for (int rr = 0; rr < kRows; ++rr)
            m[rr] = abs_max4(m[rr], reinterpret_cast<const float4*>(
                                            vf + (warp + rr * 4) * len)[j]);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) s[rr] = row_scale(a, warp_max(m[rr]));
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        if (lane == 0) sc[(warp + rr * 4) * gspan + g] = s[rr];
      for (int j = g * gq + lane; j < (g + 1) * gq; j += 32) {
        const int k = 4 * j;
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int r = warp + rr * 4;
          *reinterpret_cast<unsigned*>(vq + k / kBK * (kNT * kBK) + r * kBK +
                                       ((k % kBK / 16 ^ (r & 7)) << 4) + k % 16) =
              s8::quantize4(reinterpret_cast<const float4*>(vf + r * len)[j], s[rr]);
        }
      }
    }
    wg::fence_proxy_async();
    wg_sync();

    for (int st = 0; st < stages; ++st) {
      const int8_t* sa = slots + (st & 1) * kCols * kBK;
      const int8_t* sb = vq + st * kNT * kBK;
      const int ksteps = min(kBK, len - st * kBK) / 32;
      // The sum restarts at each group, and once in the stash.
      const bool fresh = !whole_row || c0 == 0 && st == 0;
      wg::wgmma_fence();
      for (int ks = 0; ks < ksteps; ++ks) {
        const uint64_t b = wg::desc128(sb + 32 * ks, 16, 1024);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
          S8Acc<kNT>::mma(acc[mb], wg::desc128(sa + mb * 64 * kBK + 32 * ks, 16, 1024), b,
                          !fresh || ks > 0);
      }
      wg::wgmma_commit();
      if (st + 1 < stages) {  // the next stage's weights, while the products run
        load_weights<kMB>(a, up, co0, c0 + (st + 1) * kBK, wr);
        store_weights<kMB>(slots + ((st + 1) & 1) * kCols * kBK, wr);
      }
      wg::wgmma_wait_all();
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) fence_acc(acc[mb]);
      if (!whole_row) {  // the group's part, added in group order
        const bool first = c0 + st * kBK == 0;
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int i = 0; i < kAcc; ++i) {
            const int t = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
            const float part = wt::dequant(acc[mb][i], sc[t * gspan + st], su[mb][i / 2 % 2]);
            out[mb][i] = first ? part : __fadd_rn(out[mb][i], part);
          }
      }
      wg::fence_proxy_async();
      wg_sync();  // the slot read; the next stage's weights stored for all
    }
    if (!kSpans) break;
  }
  if (whole_row)
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int t = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        out[mb][i] = wt::dequant(acc[mb][i], sc[t * gspan], su[mb][i / 2 % 2]);
      }
  // M over V's region: the last span's V was read before its products.
  float* m = vf;
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int t = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      const int o = 64 * mb + 16 * warp + lane / 4 + 8 * (i / 2 % 2);
      m[t * L.ldm + o] = out[mb][i];
    }
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

// Blocks an SM an instantiation's registers are held to: two where its
// shared memory lets two fit and 128 registers a thread hold its sums (the
// 128-channel items of 8 or 16 tiles in one span), else one.
template <int kNT, int kMB, bool kSpans>
constexpr int kMinBlocks = kMB == 2 && kNT <= 16 && !kSpans ? 2 : 1;

// One item a cluster of kCluster blocks: block rank r runs positions 2r and
// 2r + 1, one a warpgroup; then the cluster's blocks take its (tile,
// channel) pairs in turn for the inverse. chunk: the K a span stages (Kp
// itself without kSpans).
template <int kNT, int kMB, bool kSpans>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<kNT, kMB, kSpans>))
    winograd_int8_kernel(Args a, int chunk) {
  constexpr int kCols = 64 * kMB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int gspan = a.groups == 1 ? 1 : chunk / a.cg;
  const Layout L(kNT, kCols, chunk, gspan);
  unsigned char* base = smem + ((1024 - (wt::smem_addr(smem) & 1023)) & 1023);
  const unsigned rank = cluster_rank();
  const int item = blockIdx.x / kCluster;
  const int t0 = item / a.col_blocks * kNT, co0 = item % a.col_blocks * kCols;
  const int wgi = threadIdx.x / kWgThreads;
  position_item<kNT, kMB, kSpans>(a, L, chunk, gspan, 2 * rank + wgi, t0, co0,
                                  base + wgi * L.wg_bytes);
  cluster_sync();  // every position's M is in the cluster's shared memory
  const unsigned m0 = wt::smem_addr(base + L.vf);
  for (int i = rank * kThreads + threadIdx.x; i < kNT * kCols; i += kCluster * kThreads) {
    const int t = i / kCols, o = i % kCols;
    if (t0 + t >= a.T || co0 + o >= a.Cout) continue;
    const unsigned at = m0 + 4u * (t * L.ldm + o);
    float mp[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) mp[p] = load_rank(at + (p % 2) * L.wg_bytes, p / 2);
    inverse(a, t0 + t, co0 + o, mp);
  }
  cluster_sync();  // no block leaves while another reads its M
}

using Kernel = void (*)(Args, int);

template <int kNT, int kMB>
Kernel kernel_of(bool spans) {
  return spans ? winograd_int8_kernel<kNT, kMB, true> : winograd_int8_kernel<kNT, kMB, false>;
}

// The instantiation for items of nt tiles and cols channels; null for a
// shape the kernel was not compiled for. The three shapes are the ones
// that won somewhere among 8, 16 and 32 tiles by 128 and 256 channels
// (tools/chip_split_sweep.py, PERF.md): 8 x 128 at N=1, 16 x 128 past it
// at 28x28x128, 32 x 256 past it at 14x14x256.
Kernel kernel_of(int nt, int cols, bool spans) {
  if (nt == 8 && cols == 128) return kernel_of<8, 2>(spans);
  if (nt == 16 && cols == 128) return kernel_of<16, 2>(spans);
  if (nt == 32 && cols == 256) return kernel_of<32, 4>(spans);
  return nullptr;
}

// Lets `kernel` take `bytes` of dynamic shared memory, once per device and
// size (the attribute only ever grows: a size allowed once stays allowed).
cudaError_t allow_smem(Kernel kernel, int bytes) {
  constexpr int kKernels = 6;
  static Kernel seen[64][kKernels] = {};
  static int allowed[64][kKernels] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int slot = 0;
  while (slot < kKernels && seen[dev][slot] != nullptr && seen[dev][slot] != kernel) ++slot;
  if (slot == kKernels) return cudaErrorInvalidValue;
  seen[dev][slot] = kernel;
  if (bytes <= 48 * 1024 || bytes <= allowed[dev][slot]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed[dev][slot] = bytes;
  return e;
}

}  // namespace

// The host's plan (kernels/quantized.py::winograd_int8_plan): Kp, Cin
// padded to a multiple of s8::kKAlign; `tiles` and `cols`, an item's
// Winograd tiles (wgmma's N) and output channels (two or four m64 A tiles;
// 256 only in the stash): 8 x 128, 16 x 128 or 32 x 256; `chunk`, the K an item stages at
// once (Kp itself, or past one span a multiple of kGroup, at most kChunk);
// `blocks`, the grid: kCluster blocks an item, ceil(T / tiles) *
// ceil(Cout / cols) items, T = N * ceil(H / 2) * ceil(W / 2). stash = 1
// takes the Cout > 128 branch (one scale per row over all of Cin, the JAX
// kernel's quantized V stash), 0 the per-group branch.
extern "C" int winograd_int8_conv3x3_bn(const float* x, const int8_t* uq, const float* su,
                                        const float* scale, const float* bias, float* out, int N,
                                        int H, int W, int Cin, int Cout, int stash, int relu,
                                        int Kp, int tiles, int cols, int chunk, int blocks,
                                        void* stream) {
  const Kernel kernel = kernel_of(tiles, cols, chunk < Kp);
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || kernel == nullptr ||
      cols > 128 && !stash || Kp != (Cin + s8::kKAlign - 1) / s8::kKAlign * s8::kKAlign ||
      chunk <= 0 || chunk > kChunk || chunk > Kp || chunk < Kp && chunk % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const int cg = Cin % kGroup == 0 ? kGroup : Cin;
  const int groups = stash ? 1 : Cin / cg;
  Args a{x, uq, su, scale, bias, out, N, H, W, Cin, Cout, relu, stash, groups, cg, Kp, tw,
         th * tw, N * th * tw, (Cout + cols - 1) / cols,
         Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0,
         Cout % 4 == 0 && reinterpret_cast<uintptr_t>(uq) % 4 == 0};
  const long long items = static_cast<long long>((a.T + tiles - 1) / tiles) * a.col_blocks;
  if (blocks != kCluster * items) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = Layout(tiles, cols, chunk, groups == 1 ? 1 : chunk / cg).bytes;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
