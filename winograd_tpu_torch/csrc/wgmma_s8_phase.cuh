// The folded int8 GEMM phases of the persistent s8 wgmma kernels
// (csrc/stage_int8.cu, csrc/transition_int8.cu, csrc/basic_stage_int8.cu):
// a phase's rows are quantized from row maxima its producers published,
// each block a share of them, and each work item waits only for its own
// row block's counter.
//
// A row's scale needs the max over the whole row, which many blocks of the
// phase before produce; so every producing epilogue publishes its rows'
// max |v| (wgmma_s8.cuh::publish_row_max, one atomicMax of the bits a row
// and tile), and the consuming phase quantizes its rows itself:
// * gemm_phase: each block first quantizes its share of the phase's rows
//   (P / grid rows, every one over all of K, its scales from the published
//   maxima) into the int8 matrix aq and arrives on the counter of each
//   64-row block its share touches (quantize_share); then each of its work
//   items (split, tile) waits only for its own row block's counter (ready)
//   and stages aq. So every value is quantized once, all blocks quantize at
//   once, and no grid barrier stands between the quantization and the
//   product (every block is resident: a cooperative grid). A phase whose
//   tiles are few splits K over items; its exact int32 partial sums are
//   added after a grid barrier, where the epilogue runs once per element
//   and a warp of one row publishes one maximum.
// * The sources of a phase's rows: RowsSrc (rows written earlier in the
//   launch, their maxima published), Im2colSrc<kStride> (the pad-1 3x3
//   im2col rows of a map, each row's max the max of its nine pixels'),
//   XRowsSrc (the launch's input, whose rows no producer saw: a warp a row
//   takes its max first).
// * The first item's weight boxes can be issued before the barrier that
//   ends the phase before (prefetch_phase, then gemm_phase with
//   prefetched): they land while the grid waits.
// The quantization divides only where it can change the result
// (quantize4_fast), and the epilogues round each multiply and add on their
// own, in the plain versions' order: the kernels equal their plain versions
// to the bit.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "gemm_int8.cuh"
#include "wgmma_s8.cuh"

namespace wt {
namespace s8phase {

// ---- the rows a GEMM quantizes -----------------------------------------------

// Rows of a row-major (P, ld) float matrix written earlier in the launch,
// k < K; the scale of group g from the row maxima mx[p * mx_stride + g].
struct RowsSrc {
  const float* x;
  int ld, K;
  const unsigned* mx;
  int mx_stride;
  __device__ __forceinline__ float scale(int p, int g) const {
    return wgs8::scale_of_bits(__ldcg(mx + static_cast<size_t>(p) * mx_stride + g));
  }
  __device__ __forceinline__ int2 yx(int) const { return make_int2(0, 0); }
  __device__ __forceinline__ float4 load(int p, int2, int k) const {
    return k < K ? __ldcg(reinterpret_cast<const float4*>(x + static_cast<size_t>(p) * ld + k))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// The pad-1 3x3 im2col rows of an (N, H, W, C) map written earlier in the
// launch at stride kStride: row p = (n, oy, ox) of the (N, ceil(H /
// kStride), ceil(W / kStride)) output takes the taps (kStride oy + r - 1,
// kStride ox + s - 1), k = (3r + s) * C + c < 9C (stride 2 is the
// transition's SAME 3x3). A row's maximum is the max of its nine pixels'
// (zero for a tap outside the map, as the zero padding gives); yx(p) is
// the row's centre pixel and its (y, x) packed as y << 16 | x. kL1: the
// map's values are read through L1 (ld.ca), where no block of the launch
// reads them before they are written and none writes them after (a
// transition's h1: a tap of it serves up to four rows), else through L2
// only (a stage's h1, rewritten block after block).
template <int kStride, bool kL1 = false>
struct Im2colSrc {
  const float* x;
  int H, W, C;
  const unsigned* mx;  // per pixel
  __device__ __forceinline__ int2 yx(int p) const {
    const int ho = (H + kStride - 1) / kStride, wo = (W + kStride - 1) / kStride;
    const int n = p / (ho * wo), q = p - n * (ho * wo);
    const int y = q / wo * kStride, xx = q % wo * kStride;
    return make_int2((n * H + y) * W + xx, y << 16 | xx);
  }
  __device__ __forceinline__ float scale(int p, int) const {
    const int2 c = yx(p);
    const int y = c.y >> 16, xx = c.y & 0xffff;
    unsigned m = 0u;
#pragma unroll
    for (int rs = 0; rs < 9; ++rs) {
      const int dy = rs / 3 - 1, dx = rs % 3 - 1;
      if (y + dy >= 0 && y + dy < H && xx + dx >= 0 && xx + dx < W)
        m = max(m, __ldcg(mx + c.x + dy * W + dx));
    }
    return wgs8::scale_of_bits(m);
  }
  __device__ __forceinline__ float4 load(int, int2 c, int k) const {
    // the tap: a shift where C is a power of two (every served width)
    const int rs = (C & (C - 1)) == 0 ? k >> (__ffs(C) - 1) : k / C;
    const int dy = rs / 3 - 1, dx = rs % 3 - 1;
    const int y = (c.y >> 16) + dy, xx = (c.y & 0xffff) + dx;
    if (rs >= 9 || y < 0 || y >= H || xx < 0 || xx >= W) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* row = x + static_cast<size_t>(c.x + dy * W + dx) * C;
    const float4* src = reinterpret_cast<const float4*>(row + (k - rs * C));
    return kL1 ? __ldca(src) : __ldcg(src);
  }
};

// The rows of the launch's input x, a row-major (P, ld) float matrix
// (16-byte aligned, ld % 4 == 0), k < K: no producer published their
// maxima, so quantize_rows first takes each row's max itself, a warp a row
// (kSelf; one group over the whole row).
struct XRowsSrc {
  static constexpr bool kSelf = true;
  const float* x;
  int ld, K;
  __device__ __forceinline__ int2 yx(int) const { return make_int2(0, 0); }
  // The max |v| as bits of rows p + u * stride, u < n <= kRows, into m[u]
  // in every lane of the calling warp: the rows' loads in flight together.
  template <int kRows>
  __device__ __forceinline__ void row_max(int p, int stride, int n, unsigned (&m)[kRows]) const {
#pragma unroll
    for (int u = 0; u < kRows; ++u) m[u] = 0u;
#pragma unroll 2
    for (int c4 = threadIdx.x % 32; c4 < K / 4; c4 += 32) {
      float4 v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        v[u] = u < n ? __ldg(reinterpret_cast<const float4*>(
                           x + static_cast<size_t>(p + u * stride) * ld) + c4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        m[u] = max(max(m[u], max(wgs8::abs_bits(v[u].x), wgs8::abs_bits(v[u].y))),
                   max(wgs8::abs_bits(v[u].z), wgs8::abs_bits(v[u].w)));
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) m[u] = __reduce_max_sync(0xffffffffu, m[u]);
  }
  __device__ __forceinline__ float4 load(int p, int2, int k) const {
    return k < K ? __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(p) * ld + k))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// Whether a row source takes its rows' maxima itself (XRowsSrc).
template <class Src, class = void>
struct SelfScaled {
  static constexpr bool value = false;
};
template <class Src>
struct SelfScaled<Src, decltype(void(Src::kSelf))> {
  static constexpr bool value = Src::kSelf;
};

// The IEEE division's quantize of four values, packed, called apart (a
// branch the warps rarely take, not a division predicated into every
// value).
static __device__ __noinline__ unsigned quantize4_exact(float4 v, float s) {
  return static_cast<unsigned>(wt::pack4(wt::quantize(v.x, s), wt::quantize(v.y, s),
                                         wt::quantize(v.z, s), wt::quantize(v.w, s)));
}

// gemm_int8.cuh's quantize(v, s) = clamp(rint(v / s), -127, 127) of four
// values, packed, with the IEEE division only where it can matter: y = v *
// r (r = 1 / s) is within 3e-5 of v / s when |v| is at most the row's max
// (|v / s| <= ~127), so where y lies more than 2^-12 from every half-integer
// both round to the same integer; where one of the four lies nearer, or is
// not finite, the division decides all four. The common path has no
// branch between the values, so their chains interleave.
__device__ __forceinline__ unsigned quantize4_fast(const float4& v, float s, float r) {
  const float y[4] = {__fmul_rn(v.x, r), __fmul_rn(v.y, r), __fmul_rn(v.z, r), __fmul_rn(v.w, r)};
  int q[4];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = rintf(y[i]);
    near |= !(fabsf(fabsf(y[i] - t) - 0.5f) >= 0x1p-12f);
    q[i] = min(127, max(-127, static_cast<int>(t)));
  }
  if (near) return quantize4_exact(v, s);
  return static_cast<unsigned>(wt::pack4(q[0], q[1], q[2], q[3]));
}

// Rows [pb, pe) of `a`, k in [k0, k1) (multiples of 4, the range one group
// or whole groups of cg), quantized (gemm_int8.cuh's arithmetic) into aq
// (row stride Kp), each row's scale of its first group into sx. The rows'
// scales, their reciprocals and their map coordinates go to shared memory
// first (scratch: the first ring's first A region, whose kABytes the
// prefetched B boxes leave alone); then tpr threads a row walk its
// float4s, kLoads a thread in flight.
template <class Src>
__device__ __forceinline__ void quantize_rows(const Src& a, int pb, int pe, int k0, int k1, int Kp,
                                              int cg, int8_t* aq, float* sx, float* scratch) {
  constexpr int kLoads = 8;
  const int rows = pe - pb, ng = (k1 - k0 + cg - 1) / cg, g0 = k0 / cg;
  if (rows <= 0) return;
  float* sc = scratch;                                         // rows x ng scales
  float* rc = scratch + rows * ng;                             // their reciprocals
  int2* yx = reinterpret_cast<int2*>(scratch + (2 * rows * ng + 1) / 2 * 2);  // rows' (y, x)
  if constexpr (SelfScaled<Src>::value) {  // one group: a warp a row takes its max
    constexpr int kWarps = wgs8::kThreads / 32, kRows = 4;  // rows a warp has in flight
    for (int r0 = threadIdx.x / 32; r0 < rows; r0 += kWarps * kRows) {
      unsigned m[kRows];
      a.row_max(pb + r0, kWarps, min(kRows, (rows - r0 + kWarps - 1) / kWarps), m);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = r0 + u * kWarps;
        if (threadIdx.x % 32 == 0 && r < rows) {
          sc[r] = wgs8::scale_of_bits(m[u]);
          rc[r] = 1.f / sc[r];
          sx[pb + r] = sc[r];
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * ng; e += wgs8::kThreads) {
      const int r = e / ng, g = e - r * ng;
      sc[e] = a.scale(pb + r, g0 + g);
      rc[e] = 1.f / sc[e];
      if (g == 0) sx[pb + r] = sc[e];
    }
  }
  for (int r = threadIdx.x; r < rows; r += wgs8::kThreads) yx[r] = a.yx(pb + r);
  __syncthreads();
  const int kq = (k1 - k0) / 4;
  const int tpr = kq < wgs8::kThreads ? kq : wgs8::kThreads;  // threads a row
  const int rstep = wgs8::kThreads / tpr, c0 = threadIdx.x % tpr;
  int r = threadIdx.x / tpr, c = c0;
  if (threadIdx.x >= rstep * tpr) return;
  while (r < rows) {
    float4 v[kLoads];
    int rr[kLoads], cc[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      rr[u] = r;
      cc[u] = c;
      v[u] = r < rows ? a.load(pb + r, yx[r], k0 + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
      c += tpr;
      if (c >= kq) {
        c = c0;
        r += rstep;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (rr[u] >= rows) break;
      const int k = k0 + 4 * cc[u], i = ng == 1 ? rr[u] : rr[u] * ng + (k - k0) / cg;
      *reinterpret_cast<unsigned*>(aq + static_cast<size_t>(pb + rr[u]) * Kp + k) =
          quantize4_fast(v[u], sc[i], rc[i]);
    }
  }
}

// Rows [pb, pe) of a self-scaled source (XRowsSrc) quantized in one pass
// over x where a row's float4s fit kSlots a lane: a warp a row (several
// rows in flight where they are short), the values kept in registers
// between the row's maximum and its quantization. Returns false, doing
// nothing, where a row is longer (quantize_rows then reads it twice).
template <class Src>
__device__ __forceinline__ bool quantize_rows_once(const Src& a, int pb, int pe, int Kp,
                                                   int8_t* aq, float* sx) {
  constexpr int kWarps = wgs8::kThreads / 32, kSlots = 8;
  const int kq = a.K / 4, kpq = Kp / 4;  // float4s of x, and words of aq, a row
  const int per_row = (kpq + 31) / 32;   // a lane's float4s of a row
  if (per_row > kSlots) return false;
  const int in_flight = kSlots / per_row, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r0 = pb + warp; r0 < pe; r0 += kWarps * in_flight) {
    float4 v[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int u = s / per_row, c = lane + 32 * (s - u * per_row), p = r0 + u * kWarps;
      v[s] = u < in_flight && p < pe && c < kq ? a.load(p, int2{}, 4 * c)
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    unsigned m[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) m[u] = 0u;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int u = s / per_row;
      m[u] = max(m[u], max(max(wgs8::abs_bits(v[s].x), wgs8::abs_bits(v[s].y)),
                           max(wgs8::abs_bits(v[s].z), wgs8::abs_bits(v[s].w))));
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) m[u] = __reduce_max_sync(0xffffffffu, m[u]);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int u = s / per_row, c = lane + 32 * (s - u * per_row), p = r0 + u * kWarps;
      if (u >= in_flight || p >= pe || c >= kpq) continue;
      const float sc = wgs8::scale_of_bits(m[u]), rc = 1.f / sc;
      *reinterpret_cast<unsigned*>(aq + static_cast<size_t>(p) * Kp + 4 * c) =
          quantize4_fast(v[s], sc, rc);
      if (c == lane && lane == 0) sx[p] = sc;  // the row's first float4, lane 0
    }
  }
  return true;
}

// This block's share of a phase's rows, [pb, pe), quantized over all Kp by
// quantize_rows in pieces (a self-scaled source's in one pass where it
// can: quantize_rows_once), then one arrival on the
// counter of each 64-row block (kBM) the share touches. Every thread's writes
// before it are seen after ready() in any block (grid_sync.cuh's fences).
template <class Src>
__device__ __forceinline__ void quantize_share(const Src& a, int P, int Kp, int cg, int8_t* aq,
                                               float* sx, unsigned* cnt, float* scratch) {
  const int rows = (P + gridDim.x - 1) / gridDim.x;
  const int pb = blockIdx.x * rows, pe = min(P, pb + rows);
  bool once = false;
  if constexpr (SelfScaled<Src>::value) once = quantize_rows_once(a, pb, pe, Kp, aq, sx);
  // Pieces whose scales and coordinates fit the ring's first A region.
  const int ng = (Kp + cg - 1) / cg;
  const int piece = min(wgs8::kBM, (wgs8::kABytes / 4 - 16) / (2 * ng + 2));
  for (int b = pb; b < pe && !once; b += piece) {
    quantize_rows(a, b, min(pe, b + piece), 0, Kp, Kp, cg, aq, sx, scratch);
    __syncthreads();  // the scratch is rewritten by the next piece
  }
  if (once) __syncthreads();
  if (pb < pe && threadIdx.x == 0) {
    __threadfence();
    for (int rb = pb / wgs8::kBM; rb <= (pe - 1) / wgs8::kBM; ++rb) atomicAdd(cnt + rb, 1u);
  }
}

// Waits, in the calling warpgroup, until every block whose share touches
// row block rb has arrived.
__device__ __forceinline__ void ready(const unsigned* cnt, int rb, int P) {
  if (wgs8::wg_thread() == 0) {
    const int rows = (P + gridDim.x - 1) / gridDim.x;
    const int first = rb * wgs8::kBM / rows, last = (min(P, (rb + 1) * wgs8::kBM) - 1) / rows;
    const volatile unsigned* c = cnt + rb;
    while (*c < static_cast<unsigned>(last - first + 1)) __nanosleep(32);
    __threadfence();
  }
  wgs8::wg_sync();
}

// ---- epilogues -----------------------------------------------------------------

// relu(float(acc) * (sx * sw[n]) * scale[n] + bias[n]) into out[p, n] (row
// stride N); returns it.
struct BnEpi {
  const float* __restrict__ sw;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  float* out;
  int N;
  __device__ __forceinline__ float operator()(int p, int n, int acc, float sx) const {
    const float y = wt::relu(wt::bn_rn(wt::dequant(acc, sx, sw[n]), scale[n], bias[n]));
    out[static_cast<size_t>(p) * N + n] = y;
    return y;
  }
};

// The expand's: out[p, n] = relu(deq * scale[n] + bias[n] + res[p, n]), deq
// the dequantized product, each multiply and add rounded on its own; res
// may be out (each element is read only by the thread that overwrites it);
// returns it.
struct ResEpi {
  const float* __restrict__ sw;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  const float* res;
  float* out;
  int N;
  __device__ __forceinline__ float store(int p, int n, float deq) const {
    const size_t i = static_cast<size_t>(p) * N + n;
    const float y = wt::relu(__fadd_rn(wt::bn_rn(deq, scale[n], bias[n]), __ldcg(res + i)));
    out[i] = y;
    return y;
  }
  __device__ __forceinline__ float operator()(int p, int n, int acc, float sx) const {
    return store(p, n, wt::dequant(acc, sx, sw[n]));
  }
};

struct NoFin {
  __device__ __forceinline__ void operator()(int, wgs8::Acc&) const {}
};

// v[i] = 0 for i < n, over the grid.
__device__ __forceinline__ void zero(unsigned* v, size_t n) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    v[i] = 0u;
}

// The thread's two accumulator rows of the tile (h = 0, 1), relative to
// its corner, and f(row, h) over them, then each row's maximum m published.
template <class F>
__device__ __forceinline__ void for_each_row(int p0, int P, unsigned* mx, const F& f) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + warp * 16 + lane / 4 + 8 * h;
    wgs8::publish_row_max(p < P ? f(p, h) : 0u, mx, p, P);
  }
}

// One split's tile through epi: each row's outputs, and max |y| into mx.
template <class Epi>
__device__ __forceinline__ void tile_epilogue(const wgs8::Acc& acc, int P, int N, int p0, int n0,
                                              const float* sx, const Epi& epi, unsigned* mx) {
  for_each_row(p0, P, mx, [&](int p, int h) {
    const float s = __ldcg(sx + p);
    unsigned m = 0u;
#pragma unroll
    for (int j = 0; j < wgs8::kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + threadIdx.x % 4 * 2 + e;
        if (n < N) m = max(m, wgs8::abs_bits(epi(p, n, acc[4 * j + 2 * h + e], s)));
      }
    return m;
  });
}

// An item of a phase with `tiles_n` column tiles: its split, row block,
// its tile's corner and its K range.
struct Item {
  int split, rb, p0, n0, k0, k1;
};

__device__ __forceinline__ Item item_of(const wt::GemmPhase& g, int item, int tiles_n) {
  const int tiles = (g.P + wgs8::kBM - 1) / wgs8::kBM * tiles_n;
  const int split = item / tiles, t = item - split * tiles;
  const int rb = t / tiles_n, k0 = split * g.chunk;
  return Item{split, rb, rb * wgs8::kBM, t % tiles_n * wgs8::kBN, k0, min(g.K, k0 + g.chunk)};
}

// The B boxes of the warpgroup's first item of phase g into its ring (the
// ring idle; its first A region is left to quantize_share's scratch).
__device__ __forceinline__ void prefetch_phase(const wt::GemmPhase& g, const wgs8::Weights& w,
                                               wgs8::Ring& ring) {
  const int tiles_n = (g.N + wgs8::kBN - 1) / wgs8::kBN;
  const int items = (g.P + wgs8::kBM - 1) / wgs8::kBM * tiles_n * g.splits;
  const int first = blockIdx.x * wgs8::kWarpgroups + wgs8::wg_index();
  if (first < items) {
    const Item it = item_of(g, first, tiles_n);
    wgs8::prefetch_b(ring, w, it.n0, it.k0, it.k1);
  }
}

// This block's items of the product of phase g, each warpgroup walking its
// own. First the block quantizes its share of the phase's rows from `a`
// (group width cg; scratch: the first ring's first A region) into aq; then
// each item waits for its row block's quantized rows (no grid barrier: the
// row block's counter) and multiplies them by the
// k-contiguous weights w; each output through epi and its row maxima into
// mx, at one split; past one, the items' int32 partial tiles into part
// (splits x P x N), then after a grid barrier the blocks add the splits and
// run epi once per element (a warp whose 32 elements lie in one row
// publishes one maximum; mx null: none published). cnt: the phase's zeroed
// row-block counters.
// prefetched: prefetch_phase issued the first item's weights (before the
// barrier ahead of the phase); else they are issued here, to land during
// the quantization. The caller places the barrier that ends the phase.
template <class Src, class Epi>
__device__ __forceinline__ void gemm_phase(const wt::GemmPhase& g, const Src& a, int cg,
                                           const wgs8::Weights& w, const Epi& epi, unsigned* mx,
                                           int8_t* aq, float* sx, unsigned* cnt, int* part,
                                           unsigned int* bar, wgs8::Ring& ring, float* scratch,
                                           bool prefetched = false) {
  const int tiles_n = (g.N + wgs8::kBN - 1) / wgs8::kBN;
  const int rbs = (g.P + wgs8::kBM - 1) / wgs8::kBM;
  const int items = rbs * tiles_n * g.splits;
  const int first = blockIdx.x * wgs8::kWarpgroups + wgs8::wg_index();  // the warpgroup's items
  if (!prefetched) prefetch_phase(g, w, ring);  // the first item's weights meanwhile
  quantize_share(a, g.P, g.K, cg, aq, sx, cnt, scratch);
  for (int item = first; item < items; item += gridDim.x * wgs8::kWarpgroups) {
    const Item it = item_of(g, item, tiles_n);
    if (item != first) wgs8::prefetch_b(ring, w, it.n0, it.k0, it.k1);
    ready(cnt, it.rb, g.P);
    wgs8::Acc acc;
    wgs8::tile<false>(aq, g.P, g.K, w, it.p0, it.n0, it.k0, it.k1, ring, true, acc, NoFin{});
    if (g.splits == 1) {
      tile_epilogue(acc, g.P, g.N, it.p0, it.n0, sx, epi, mx);
      continue;
    }
    int* sp = part + static_cast<size_t>(it.split) * g.P * g.N;
    wgs8::for_each_acc([&](int r, int c, int i) {
      const int p = it.p0 + r, n = it.n0 + c;
      if (p < g.P && n < g.N) sp[static_cast<size_t>(p) * g.N + n] = acc[i];
    });
  }
  if (g.splits == 1) return;
  wt::grid_sync(bar);
  const size_t pn = static_cast<size_t>(g.P) * g.N;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t end = (pn + 31) / 32 * 32;  // whole warps, for the row reduction
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < end;
       i += stride) {
    const bool live = i < pn;
    const int p = live ? static_cast<int>(i / g.N) : -1;
    unsigned m = 0u;
    if (live) {
      int s = 0;
      for (int k0 = 0; k0 < g.splits; k0 += 8) {  // eight splits' loads in flight
        int v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = k0 + u < g.splits ? __ldcg(part + (k0 + u) * pn + i) : 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) s += v[u];
      }
      m = wgs8::abs_bits(epi(p, static_cast<int>(i % g.N), s, __ldcg(sx + p)));
    }
    const int p_first = __shfl_sync(0xffffffffu, p, 0);
    if (__all_sync(0xffffffffu, p == p_first)) {
      m = __reduce_max_sync(0xffffffffu, m);
      if (threadIdx.x % 32 == 0 && p_first >= 0 && m != 0u && mx != nullptr)
        atomicMax(mx + p_first, m);
    } else if (live && m != 0u && mx != nullptr) {
      atomicMax(mx + p, m);
    }
  }
}

}  // namespace s8phase
}  // namespace wt
