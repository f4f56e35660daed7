// The int8 tier's GEMM on the int8 tensor cores, in the phases of a
// persistent cooperative kernel: quantize the activation rows once, lay the
// weights out k-contiguous, then multiply with split K and add the splits.
//
// The arithmetic is gemm_int8.cuh's (per-row scale s = max|row| / 127 by
// IEEE division, 1 for a zero row; q = clamp(rint(a / s), -127, 127); the
// product summed exactly in int32; the epilogue's multiplies and adds
// rounded one by one), so a kernel built on it agrees with the plain twins
// of kernels/quantized.py to the bit. What differs is where the work is
// done:
// * quantize_rows_phase: each row's scale and int8 values are computed once,
//   by a group of 1-8 warps that walks the row in float4s through a loader
//   (Im2colRows: csrc/direct_int8.cu's), and stored as a (P, Kp) int8 matrix (Kp = K
//   rounded up to kKAlign, zero past K) with the scales beside it.
// * transpose_phase: mma.sync's B operand is k-contiguous per column, the
//   weights are (K, N) n-contiguous; each launch writes them once as an
//   (N, Kp) int8 matrix, zero past K (2.4 MB at 7x7x512, L2-resident for
//   the product that follows).
// * gemm_phase: 64 x 64 tiles, 8 warps of 32 x 16 outputs, each k step of
//   32 one mma.sync.m16n8k32.row.col.s32.s8.s8.s32 per 16 x 8 fragment; A
//   and B arrive by 16-byte cp.async copies in a kStages-deep ring of
//   kBK-byte stages (rows padded to kLd bytes: a warp's fragment loads hit
//   32 distinct banks). Work items are (split, tile) pairs dealt to the
//   blocks; with several splits each item writes int32 partial sums and,
//   after a grid barrier, the blocks add them (exact in any order) and
//   apply the epilogue once per element.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "gemm_int8.cuh"

namespace wt {
namespace s8mma {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;      // bytes of k per stage: two mma k steps
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kLd = kBK + 16;
constexpr int kStageBytes = (kBM + kBN) * kLd;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kKAlign = 32;  // K of the quantized operands is padded to this

using Acc = int[2][2][4];

__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Four values quantized by scale s, packed four k to a word.
__device__ __forceinline__ unsigned quantize4(const float4& v, float s) {
  return static_cast<unsigned>(
      pack4(quantize(v.x, s), quantize(v.y, s), quantize(v.z, s), quantize(v.w, s)));
}

// Four rows' words (word i: columns c = 0..3 of row i, one byte each) as
// four columns' words (word c: rows i = 0..3 of column c): the k-contiguous
// layout of __dp4a's and mma.sync's B operand.
__device__ __forceinline__ void transpose4(const unsigned (&r)[4], unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// Rows k .. k+3 of a row-major (K, N) int8 matrix w at columns n .. n+3,
// one word a row, zero past K and N; kVec: N % 4 == 0 and w 4-byte aligned.
template <bool kVec>
__device__ __forceinline__ void rows4(const int8_t* __restrict__ w, int K, int N, int k, int n,
                                      unsigned (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int8_t* row = w + static_cast<size_t>(k + i) * N + n;
    r[i] = 0u;
    if (k + i >= K) continue;
    if (kVec) {
      if (n < N) r[i] = __ldg(reinterpret_cast<const unsigned*>(row));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + c < N)
          r[i] |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(row + c))) << (8 * c);
    }
  }
}

// mma.sync's m16n8k32 fragments from shared memory (rows of ld bytes, k
// from byte ks): A of rows r0 .. r0+15, B of columns (k-contiguous rows of
// sb) n0 .. n0+7.
__device__ __forceinline__ void frag_a(const int8_t* sa, int ld, int r0, int ks, unsigned (&a)[4]) {
  const int lane = threadIdx.x % 32;
  const int8_t* r = sa + (r0 + lane / 4) * ld + ks + 4 * (lane % 4);
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * ld);
  a[2] = ld32(r + 16);
  a[3] = ld32(r + 8 * ld + 16);
}

__device__ __forceinline__ void frag_b(const int8_t* sb, int ld, int n0, int ks, unsigned (&b)[2]) {
  const int lane = threadIdx.x % 32;
  const int8_t* c = sb + (n0 + lane / 4) * ld + ks + 4 * (lane % 4);
  b[0] = ld32(c);
  b[1] = ld32(c + 16);
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// Four floats from src through the read-only path: one 16-byte load where
// kVec (src 16-byte aligned), else four.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* src) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(src));
  return make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
}

// The loader for quantize_rows_phase: the pad-1 stride-1 3x3 im2col rows of
// the launch's input, an (N, H, W, 4 * C4) map, four channels at a time:
// row p = (n, y, x) takes the taps (y + r - 1, x + s - 1), zero outside
// the map. kVec: x is 16-byte aligned. A walk over a row's float4s goes
// window by window (rs = 3r + s): it holds the float4 c4 within the window
// and the window's source pixel, worked out when the walk enters the
// window (null where the window leaves the map).
template <bool kVec>
struct Im2colRows {
  const float* x;
  int H, W, C4;
  struct Row {
    int n, y, x;
  };
  struct Walk {
    const float* px;
    int rs, c4;
  };
  __device__ __forceinline__ Row row(int p) const {
    const int hw = H * W;
    const int n = p / hw, q = p - n * hw;
    return Row{n, q / W, q % W};
  }
  __device__ __forceinline__ const float* window(const Row& r, int rs) const {
    if (rs >= 9) return nullptr;
    const int y = r.y + rs / 3 - 1, xx = r.x + rs % 3 - 1;
    if (y < 0 || y >= H || xx < 0 || xx >= W) return nullptr;
    return x + (static_cast<size_t>(r.n * H + y) * W + xx) * (4 * C4);
  }
  // The walk at float4 j of the row (one division a walk).
  __device__ __forceinline__ Walk walk(const Row& r, int j) const {
    const int rs = j / C4;
    return Walk{window(r, rs), rs, j - rs * C4};
  }
  __device__ __forceinline__ void next(const Row& r, Walk& it, int step) const {
    it.c4 += step;
    if (it.c4 < C4) return;
    do {
      it.c4 -= C4;
      ++it.rs;
    } while (it.c4 >= C4);
    it.px = window(r, it.rs);
  }
  __device__ __forceinline__ float4 load(const Walk& it) const {
    if (it.px == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
    return load4<kVec>(it.px + 4 * it.c4);
  }
};

// Quantize rows p < P of a (P, K) float matrix, K % 4 == 0, read through
// `a` (a.row(p) once per row; a.walk(row, j) a walk at float4 j, k = 4j;
// a.load(walk) its four values; a.next(row, walk, step) on by `step`
// float4s), into aq (P, Kp) int8 (zero for K <= k < Kp) and their scales
// into sx[p]. Rows are dealt to groups of warps across the grid, enough
// warps a row that a lane holds at most kRowVecs float4s of it; a lane
// issues its loads together and keeps the values in registers for the
// quantizing pass (a row longer than 8 warps' registers reloads the rest).
// `red`: kThreads / 32 floats of shared memory. The caller places the
// barrier.
constexpr int kRowVecs = 8;

template <class Loader>
__device__ __forceinline__ void quantize_rows_phase(const Loader& a, int P, int K, int Kp,
                                                    int8_t* aq, float* sx, float* red) {
  const int k4 = K / 4, kp4 = Kp / 4;
  int wpr = 1;  // warps a row
  while (wpr < kThreads / 32 && k4 > kRowVecs * 32 * wpr) wpr *= 2;
  const int rows = kThreads / 32 / wpr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = warp / wpr * wpr, gi = (warp - first) * 32 + lane, gn = 32 * wpr;
  for (int base = blockIdx.x * rows; base < P; base += gridDim.x * rows) {
    const int p = base + warp / wpr;
    float4 v[kRowVecs];
    float m = 0.f;
    if (p < P) {
      const auto row = a.row(p);
      auto it = a.walk(row, gi);
#pragma unroll
      for (int i = 0; i < kRowVecs; ++i, a.next(row, it, gn))
        v[i] = gi + i * gn < k4 ? a.load(it) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < kRowVecs; ++i) m = abs_max4(m, v[i]);
      for (int j = gi + kRowVecs * gn; j < k4; j += gn, a.next(row, it, gn))
        m = abs_max4(m, a.load(it));
    }
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    for (int w = first; w < first + wpr; ++w) m = fmaxf(m, red[w]);
    const float s = scale_from_max(m);
    if (p < P) {
      unsigned* dst = reinterpret_cast<unsigned*>(aq + static_cast<size_t>(p) * Kp);
#pragma unroll
      for (int i = 0; i < kRowVecs; ++i)
        if (gi + i * gn < k4) dst[gi + i * gn] = quantize4(v[i], s);
      if (gi + kRowVecs * gn < k4) {
        const auto row = a.row(p);
        auto it = a.walk(row, gi + kRowVecs * gn);
        for (int j = gi + kRowVecs * gn; j < k4; j += gn, a.next(row, it, gn))
          dst[j] = quantize4(a.load(it), s);
      }
      for (int j = k4 + gi; j < kp4; j += gn) dst[j] = 0u;
      if (gi == 0) sx[p] = s;
    }
    __syncthreads();  // red is reused by the next rows
  }
}

// The transpose of (K, N) int8 weights b into bt (N, Kp), k-contiguous, zero
// for K <= k < Kp, cut into items of sixteen k: of four columns each, one
// 4-byte load a k, where N % 4 == 0 and b is 4-byte aligned (vec), else of
// one column.
struct Transpose {
  const int8_t* __restrict__ b;
  int K, N, Kp;
  int8_t* bt;
  __device__ __forceinline__ bool vec() const {
    return N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  }
  __device__ __forceinline__ long long items() const {
    return static_cast<long long>(Kp / 16) * (vec() ? N / 4 : N);
  }
  __device__ __forceinline__ void item(long long i) const {
    if (vec()) {
      const int n4s = N / 4;
      const int kg = static_cast<int>(i / n4s), n4 = static_cast<int>(i % n4s);
      unsigned w[4][4] = {};  // [column][word]
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = kg * 16 + j;
        const unsigned v =
            k < K ? __ldg(reinterpret_cast<const unsigned*>(b + static_cast<size_t>(k) * N) + n4)
                  : 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c][j / 4] |= ((v >> (8 * c)) & 0xffu) << (8 * (j % 4));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint4*>(bt + static_cast<size_t>(4 * n4 + c) * Kp + kg * 16) =
            make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
      return;
    }
    const int kg = static_cast<int>(i / N), n = static_cast<int>(i % N);
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = kg * 16 + j;
      const unsigned v =
          k < K ? static_cast<unsigned char>(__ldg(b + static_cast<size_t>(k) * N + n)) : 0u;
      w[j / 4] |= v << (8 * (j % 4));
    }
    *reinterpret_cast<uint4*>(bt + static_cast<size_t>(n) * Kp + kg * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Every item of one transpose, dealt to the whole grid. The caller places
// the barrier.
__device__ __forceinline__ void transpose_phase(const int8_t* __restrict__ b, int K, int N,
                                                int Kp, int8_t* bt) {
  const Transpose t{b, K, N, Kp, bt};
  const long long items = t.items();
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < items;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    t.item(i);
}

// One stage: aq[p0 .. p0+63, kb .. kb+63] and bt[n0 .. n0+63, kb .. kb+63],
// one 16-byte copy of each a thread.
__device__ __forceinline__ void load_stage(int8_t* sa, int8_t* sb, const int8_t* aq,
                                           const int8_t* bt, int P, int N, int Kp, int p0,
                                           int n0, int kb, int k1) {
  const int r = threadIdx.x / 4, c = threadIdx.x % 4 * 16;
  const int k = kb + c;
  bool ok = p0 + r < P && k < k1;
  cp_async16(sa + r * kLd + c, ok ? aq + static_cast<size_t>(p0 + r) * Kp + k : aq, ok);
  ok = n0 + r < N && k < k1;
  cp_async16(sb + r * kLd + c, ok ? bt + static_cast<size_t>(n0 + r) * Kp + k : bt, ok);
}

// The warp (wm, wn) multiplies its 32 x 16 outputs over the 32 k from byte
// ks of the rows of sa and sb (shared memory, rows of ld bytes).
__device__ __forceinline__ void mma_k32(const int8_t* sa, const int8_t* sb, int ld, int ks,
                                        Acc& acc, int wm, int wn) {
  unsigned a[2][4], b[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) frag_a(sa, ld, wm * 32 + mi * 16, ks, a[mi]);
#pragma unroll
  for (int ni = 0; ni < 2; ++ni) frag_b(sb, ld, wn * 16 + ni * 8, ks, b[ni]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) mma(acc[mi][ni], a[mi], b[ni]);
}

// One ring stage (kBK bytes of k, rows of kLd bytes).
__device__ __forceinline__ void mma_stage(const int8_t* sa, const int8_t* sb, Acc& acc, int wm,
                                          int wn) {
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 32) mma_k32(sa, sb, kLd, ks, acc, wm, wn);
}

// acc = aq[p0.., k0:k1] x bt[n0.., k0:k1]^T for the 64 x 64 tile; smem:
// kSmemBytes, 16-byte aligned. Ends with every copy landed and a
// __syncthreads, so the caller may reuse the ring.
__device__ __forceinline__ void tile(const int8_t* aq, const int8_t* bt, int P, int N, int Kp,
                                     int p0, int n0, int k0, int k1, int8_t* smem, Acc& acc) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int steps = (k1 - k0 + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      int8_t* st = smem + s * kStageBytes;
      load_stage(st, st + kBM * kLd, aq, bt, P, N, Kp, p0, n0, k0 + s * kBK, k1);
    }
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed for all; slot (it - 1) is free
    const int next = it + kStages - 1;
    if (next < steps) {
      int8_t* st = smem + (next % kStages) * kStageBytes;
      load_stage(st, st + kBM * kLd, aq, bt, P, N, Kp, p0, n0, k0 + next * kBK, k1);
    }
    cp_async_commit();
    const int8_t* st = smem + (it % kStages) * kStageBytes;
    mma_stage(st, st + kBM * kLd, acc, wm, wn);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The row and column, relative to the tile's corner, of this thread's
// accumulator acc[mi][ni][e].
__device__ __forceinline__ int acc_row(int mi, int e) {
  return threadIdx.x / 32 / 4 * 32 + threadIdx.x % 32 / 4 + mi * 16 + e / 2 * 8;
}
__device__ __forceinline__ int acc_col(int ni, int e) {
  return threadIdx.x / 32 % 4 * 16 + threadIdx.x % 4 * 2 + ni * 8 + e % 2;
}

// Calls f(row, col, value) for each of the thread's 16 accumulators.
template <class F>
__device__ __forceinline__ void for_each_acc(const Acc& acc, const F& f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) f(acc_row(mi, e), acc_col(ni, e), acc[mi][ni][e]);
}

// C = aq x bt^T over the whole phase, every output through
// epi(p, n, acc, sx[p]); aq, bt and sx were written before a barrier. K
// (Kp bytes) in `splits` ranges of `chunk` (a multiple of kBK when
// splits > 1); with several, int32 partial sums go to part (splits x P x
// N), and after a barrier the blocks add them and apply the epilogue. The
// caller places the barrier that ends the phase.
template <class Epilogue>
__device__ __forceinline__ void gemm_phase(const int8_t* aq, const int8_t* bt, const float* sx,
                                           int P, int N, int Kp, int splits, int chunk,
                                           const Epilogue& epi, int* part, unsigned int* bar,
                                           int8_t* smem) {
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = (P + kBM - 1) / kBM * tiles_n;
  for (int item = blockIdx.x; item < tiles * splits; item += gridDim.x) {
    const int split = item / tiles, t = item - split * tiles;
    const int p0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
    const int k0 = split * chunk, k1 = min(Kp, k0 + chunk);
    Acc acc;
    tile(aq, bt, P, N, Kp, p0, n0, k0, k1, smem, acc);
    int* sp = splits == 1 ? nullptr : part + static_cast<size_t>(split) * P * N;
    for_each_acc(acc, [&](int r, int c, int v) {
      const int p = p0 + r, n = n0 + c;
      if (p >= P || n >= N) return;
      if (splits == 1)
        epi(p, n, v, __ldcg(sx + p));
      else
        sp[static_cast<size_t>(p) * N + n] = v;
    });
  }
  if (splits == 1) return;
  grid_sync(bar);
  const size_t pn = static_cast<size_t>(P) * N;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < pn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int s = 0;
    for (int k0 = 0; k0 < splits; k0 += 8) {  // eight splits' loads in flight
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = k0 + u < splits ? __ldcg(part + (k0 + u) * pn + i) : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    const int p = static_cast<int>(i / N);
    epi(p, static_cast<int>(i % N), s, __ldcg(sx + p));
  }
}

}  // namespace s8mma
}  // namespace wt
