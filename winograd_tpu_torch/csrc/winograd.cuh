// The Winograd F(m,3) matrices (Wino<M>, m = 2 or 4), the sandwich T in T^T
// of their nonzero entries, and the FP64 F(2,3) tile of the routes that
// must match a float64 plain version to the bit.
//
// wino_f64_tile: one work item computes kF64Tiles (16) Winograd tiles x CB
// output channels of a 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) on
// a bf16 filter, for all 16 tile positions, with the whole chain on chip:
//   V = Bt d Bt^T per 4x4 input tile and channel,
//   M[p] = V[p] U[p] per tile position p,
//   Y = At M At^T, then y = Y * scale + bias (+ ReLU), stored clipped at the
//   right and bottom edges when 2 does not divide the map.
// The transforms, the products and their sums run in FP64, and each output
// is rounded to float once, before a BN whose multiply and add round
// separately. A bf16 U widened to double is exact, a product of U and V
// fits in 53 bits, so the result does not depend on the order of the sums
// (to a last-bit tie in FP64): a plain version computing the same algebra
// in float64 matches it to the bit. The int8 tier needs that, because its
// next layer's quantization turns any last-bit difference into a whole
// quantization step.
//
// Used by csrc/winograd.cu's F(2,3) on bf16 filters (the int8 tier's
// bf16-filter 3x3) and by the int8 stage's winograd2 mid-layer
// (csrc/stage_int8.cu), each a block of kF64Threads (256) threads walking
// items cut by the host's plan (kernels/winograd.py::winograd_fp64_plan:
// CB, the item's Cout block, 8, 16 or 32). Design, for Hopper's FP64
// tensor cores (mma_f64.cuh, 67 TFLOP/s where FP64 FMAs run at 34):
// * the item is the MMA fragment's M: its 16 tiles are the rows of every
//   position's (16 x Cin) . (Cin x CB) product; each of the 8 warps owns 2
//   positions and keeps their 16 x CB sums in FP64 accumulators;
// * Cin is walked in stages of kF64KC (16) channels, double-buffered: all
//   256 threads transform one (tile, channel) each (sandwich<2, 4> in
//   FP64, the input read through the functor `Load`, `float ld(const
//   float* p)`, so a kernel that produced it in the same launch can bypass
//   L1) and stage V in shared memory as doubles, while the filter's slice,
//   raw bf16, arrives by cp.async in 16-byte copies (the hosts pad Cout to
//   a multiple of 8); the next stage's input loads and copies are issued
//   before this stage's MMAs, so one barrier a stage remains; U is widened
//   to double exactly as each B fragment is loaded;
// * at the end the item's M goes through shared memory in FP64 (over V),
//   and one thread per (tile, channel) applies At M At^T, rounds to float
//   once and applies BN with __fmul_rn / __fadd_rn and wt::relu.
// No Cin split: every item walks all of Cin, and its products are summed
// in one accumulator before the single rounding. The f32 Winograd
// (csrc/wino_tf32.cuh) shares only the matrices and the sandwich.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "cp_async.cuh"
#include "mma_f64.cuh"

namespace wt {

template <int M>
struct Wino;

template <>
struct Wino<2> {
  __host__ __device__ static constexpr float bt(int i, int k) {
    constexpr float m[4][4] = {
        {1, 0, -1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, 1, 0, -1}};
    return m[i][k];
  }
  __host__ __device__ static constexpr float at(int i, int k) {
    constexpr float m[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};
    return m[i][k];
  }
};

template <>
struct Wino<4> {
  __host__ __device__ static constexpr float bt(int i, int k) {
    constexpr float m[6][6] = {
        {4, 0, -5, 0, 1, 0},  {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},
        {0, -2, -1, 2, 1, 0}, {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}};
    return m[i][k];
  }
  __host__ __device__ static constexpr float at(int i, int k) {
    constexpr float m[4][6] = {{1, 1, 1, 1, 1, 0},
                               {0, 1, -1, 2, -2, 0},
                               {0, 1, 1, 4, 4, 0},
                               {0, 1, -1, 8, -8, 1}};
    return m[i][k];
  }
};

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

// out = T in T^T for a constant R x C matrix T (C = M + 2), zero terms
// skipped at compile time. `T(i, k)` is Wino<M>::bt or ::at.
template <int M, int R, bool kInverse, class T>
__device__ __forceinline__ void sandwich(const T (&in)[M + 2][M + 2], T (&out)[R][R]) {
  constexpr int A = M + 2;
  T t[R][A];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < A; ++j) {
      T s = 0;
#pragma unroll
      for (int k = 0; k < A; ++k) {
        const float c = kInverse ? Wino<M>::at(i, k) : Wino<M>::bt(i, k);
        if (c != 0.f) s = mul_add(T(c), in[k][j], s);
      }
      t[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T s = 0;
#pragma unroll
      for (int k = 0; k < A; ++k) {
        const float c = kInverse ? Wino<M>::at(j, k) : Wino<M>::bt(j, k);
        if (c != 0.f) s = mul_add(T(c), t[i][k], s);
      }
      out[i][j] = s;
    }
}

struct PlainLoad {
  __device__ __forceinline__ float operator()(const float* p) const { return *p; }
};

// The FP64 F(2,3) tile's geometry. kF64K is the MMA's depth (mma_f64.cuh:
// m16n8k4, k8 and k16 take the same operands in 2, 4 and 8 doubles of A a
// lane; tools/chip_fp64_tile.py times the three).
constexpr int kF64Tiles = 16;                 // an item's tiles: the fragment's rows
constexpr int kF64Positions = 16;             // F(2,3)'s 4 x 4 tile positions
constexpr int kF64Threads = 256;              // a block's
constexpr int kF64Warps = kF64Threads / 32;
constexpr int kF64PosPerWarp = kF64Positions / kF64Warps;
constexpr int kF64KC = 16;                    // input channels a stage
constexpr int kF64K = 4;                      // the MMA's depth
constexpr int kF64VLd = kF64KC + 4;           // doubles a staged V row (a tile's channels)
static_assert(kF64Tiles * kF64KC == kF64Threads, "one (tile, channel) transform a thread");
static_assert(kF64KC % kF64K == 0 && kF64Positions % kF64Warps == 0, "the stage's MMAs");

// Shared memory of wino_f64_tile with a Cout block of CB: two stages of V
// (doubles, [position][tile][channel], rows of kF64VLd so that the A
// fragments' loads are conflict-free) and of U (raw bf16, [position]
// [channel][column], rows of CB + 8 for the B fragments, 16-byte aligned
// for cp.async), then M (doubles, [position][tile][column], rows of CB | 8
// for the accumulators' 16-byte stores) over V.
template <int CB>
struct F64Smem {
  static constexpr int kULd = CB + 8;
  static constexpr int kMLd = CB | 8;
  static constexpr int kVBytes = 2 * kF64Positions * kF64Tiles * kF64VLd * 8;
  static constexpr int kUBytes = 2 * kF64Positions * kF64KC * kULd * 2;
  static constexpr int kMBytes = kF64Positions * kF64Tiles * kMLd * 8;
  static constexpr int kBytes = kVBytes + kUBytes;
  static_assert(kMBytes <= kVBytes && kVBytes % 16 == 0, "M lies over V; U 16-byte aligned");
};

// Items of 16 tiles over an (N, H, W) map's F(2,3) tiles.
__host__ __device__ __forceinline__ int f64_tile_groups(int N, int H, int W) {
  return (N * ((H + 1) / 2) * ((W + 1) / 2) + kF64Tiles - 1) / kF64Tiles;
}

// wino_f64_tile's default observer of its outputs: none.
struct NoRowMax {
  static constexpr bool kOn = false;
  __device__ __forceinline__ void operator()(int, int, unsigned) const {}
};

// Tiles t0 .. t0 + 15 (row-major over N x ceil(H/2) x ceil(W/2)) and output
// channels co0 .. co0 + CB - 1 of the item, by the block's kF64Threads
// threads; smem holds F64Smem<CB>::kBytes, 16-byte aligned; u is (16, Cin,
// Cout) bf16, 16-byte aligned, Cout a multiple of 8 (the filter's 16-byte
// copies). Every thread of the block calls it; it ends in
// a barrier, so the block's next item may reuse smem. An observer with kOn
// (the int8 stage's) is called once per output pixel, by the thread of
// the pixel's tile and the item's first channel, as obs(pixel, co0, m), m
// the bits of the largest |value| the item stored at that pixel (as an
// unsigned int, a NaN above every number); the arithmetic is the same
// either way.
template <int CB, class Load, class Obs = NoRowMax>
__device__ __forceinline__ void wino_f64_tile(
    const Load& ld, const float* x, const __nv_bfloat16* __restrict__ u,
    const float* __restrict__ scale, const float* __restrict__ bias, float* out, int N, int H,
    int W, int Cin, int Cout, int relu, int t0, int co0, void* smem, const Obs& obs = Obs{}) {
  static_assert(CB == 8 || CB == 16 || CB == 32, "a Cout block of 1, 2 or 4 n8 fragments");
  using S = F64Smem<CB>;
  constexpr int kNF = CB / 8;
  constexpr int kKA = kF64K / 2;  // A doubles a lane
  constexpr int kKB = kF64K / 4;  // B doubles a lane
  auto Vs = static_cast<double(*)[kF64Positions][kF64Tiles][kF64VLd]>(smem);
  auto Us = reinterpret_cast<__nv_bfloat16(*)[kF64Positions][kF64KC][S::kULd]>(
      static_cast<char*>(smem) + S::kVBytes);
  auto Ms = static_cast<double(*)[kF64Tiles][S::kMLd]>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const int nt = N * th * tw;

  // The thread's (tile, channel) of every stage's input transform, and the
  // stage's 4 x 4 input patch, loaded a stage ahead.
  const int lt = tid / kF64KC, lc = tid % kF64KC;
  const bool tile_live = t0 + lt < nt;
  int n = 0, y0 = 0, x0 = 0;
  if (tile_live) {
    n = (t0 + lt) / (th * tw);
    const int r = t0 + lt - n * th * tw;
    y0 = (r / tw) * 2 - 1;
    x0 = (r % tw) * 2 - 1;
  }
  float d[4][4];
  const auto load_x = [&](int c0) {
    const int c = c0 + lc;
    const bool live = tile_live && c < Cin;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int yy = y0 + i, xx = x0 + j;
        d[i][j] = (live && yy >= 0 && yy < H && xx >= 0 && xx < W)
                      ? ld(&x[(static_cast<size_t>(n * H + yy) * W + xx) * Cin + c])
                      : 0.f;
      }
  };
  // The stage's slice of U, (16 positions x kF64KC channels) x CB columns:
  // one row a thread.
  const auto stage_u = [&](int c0, int buf) {
    const int p = tid / kF64KC, c = tid % kF64KC;
    const bool row = c0 + c < Cin;
    const size_t at = (static_cast<size_t>(p) * Cin + c0 + c) * Cout + co0;
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
      const bool valid = row && co0 + 8 * j < Cout;
      cp_async16(&Us[buf][p][c][8 * j], valid ? u + at + 8 * j : u, valid);
    }
    cp_async_commit();
  };

  double acc[kF64PosPerWarp][kNF][4];
#pragma unroll
  for (int q = 0; q < kF64PosPerWarp; ++q)
#pragma unroll
    for (int f = 0; f < kNF; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][f][i] = 0.0;

  const int stages = (Cin + kF64KC - 1) / kF64KC;
  load_x(0);
  stage_u(0, 0);
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    {
      double dd[4][4], v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dd[i][j] = d[i][j];
      sandwich<2, 4, false>(dd, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Vs[buf][i * 4 + j][lt][lc] = v[i][j];
    }
    cp_async_wait<0>();
    __syncthreads();  // this stage's V and U in; the other buffers' readers done
    if (s + 1 < stages) {
      load_x((s + 1) * kF64KC);
      stage_u((s + 1) * kF64KC, buf ^ 1);
    }
#pragma unroll
    for (int k0 = 0; k0 < kF64KC; k0 += kF64K)
#pragma unroll
      for (int q = 0; q < kF64PosPerWarp; ++q) {
        const int p = warp * kF64PosPerWarp + q;
        double a[kKA];
#pragma unroll
        for (int i = 0; i < kKA; ++i) a[i] = Vs[buf][p][g + 8 * (i % 2)][k0 + t + 4 * (i / 2)];
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          double b[kKB];
#pragma unroll
          for (int j = 0; j < kKB; ++j) b[j] = __bfloat162float(Us[buf][p][k0 + t + 4 * j][8 * f + g]);
          dmma(acc[q][f], a, b);
        }
      }
  }
  __syncthreads();  // every warp's last products read before M goes over V

#pragma unroll
  for (int q = 0; q < kF64PosPerWarp; ++q) {
    const int p = warp * kF64PosPerWarp + q;
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      *reinterpret_cast<double2*>(&Ms[p][g][8 * f + 2 * t]) = make_double2(acc[q][f][0], acc[q][f][1]);
      *reinterpret_cast<double2*>(&Ms[p][g + 8][8 * f + 2 * t]) =
          make_double2(acc[q][f][2], acc[q][f][3]);
    }
  }
  __syncthreads();

  // The inverse, one thread per (tile, channel): CB consecutive lanes hold
  // a tile's channels (CB divides the warp), so the observer's maximum is
  // a shuffle over them. Whole warps take each round.
  for (int e = tid; e < kF64Tiles * CB; e += kF64Threads) {
    const int et = e / CB, ch = e % CB;
    const int gt = t0 + et, co = co0 + ch;
    const bool live = gt < nt;
    const int on = gt / (th * tw);
    const int r = gt - on * th * tw;
    const int oy0 = (r / tw) * 2, ox0 = (r % tw) * 2;
    double mm[4][4];
#pragma unroll
    for (int p = 0; p < kF64Positions; ++p) mm[p / 4][p % 4] = Ms[p][et][ch];
    double y[2][2];
    sandwich<2, 2, true>(mm, y);
    unsigned amax[2][2] = {{0u, 0u}, {0u, 0u}};
    if (co < Cout) {
      const float sc = scale[co];
      const float bi = bias[co];
#pragma unroll
      for (int oi = 0; oi < 2; ++oi)
#pragma unroll
        for (int oj = 0; oj < 2; ++oj) {
          const int oy = oy0 + oi, ox = ox0 + oj;
          if (live && oy < H && ox < W) {
            float val = __fadd_rn(__fmul_rn(static_cast<float>(y[oi][oj]), sc), bi);
            if (relu) val = wt::relu(val);
            out[(static_cast<size_t>(on * H + oy) * W + ox) * Cout + co] = val;
            if (Obs::kOn) amax[oi][oj] = __float_as_uint(val) & 0x7fffffffu;
          }
        }
    }
    if constexpr (Obs::kOn) {
#pragma unroll
      for (int oi = 0; oi < 2; ++oi)
#pragma unroll
        for (int oj = 0; oj < 2; ++oj) {
          unsigned m = amax[oi][oj];
#pragma unroll
          for (int o = 1; o < CB; o <<= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
          const int oy = oy0 + oi, ox = ox0 + oj;
          if (ch == 0 && live && oy < H && ox < W) obs((on * H + oy) * W + ox, co0, m);
        }
    }
  }
  __syncthreads();  // M read before the next item's stages go over it
}

}  // namespace wt
