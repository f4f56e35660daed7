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
// Design: a row's scale needs all of its channels, and the TPU kernel holds
// them in VMEM. Here one block owns 8 tiles and all of Cin (and 64 output
// channels), so it finds its rows' scales itself and needs no grid barrier:
// pass 1 transforms its tiles' input channel by channel (one warp per tile,
// a lane per channel) and reduces |V| per row with warp shuffles; pass 2
// transforms again in stages of 32 channels, quantizes, packs four
// channels to a word in shared memory beside the stage's slice of u_q, and
// each thread runs __dp4a into int32 for one tile, four output channels
// and all 16 positions. The transforms and At run in FP64 and round once:
// V is quantized, and a last-bit difference from the plain version would
// move a value across a rounding step (as in csrc/stage_int8.cu); the
// dequantization and BN round each multiply and add on its own in the
// plain version's order, so the two agree to the bit. Blocks that share
// tiles (the output-channel tiles) transform their input again rather than
// exchange it.

#include <stdint.h>

#include "common.cuh"
#include "gemm_int8.cuh"
#include "winograd.cuh"

namespace {

constexpr int kTT = 8;                // tiles per block (one per warp in pass 1, 2 passes)
constexpr int kTX = 16;               // output-channel groups per block
constexpr int kCPT = 4;               // output channels per thread
constexpr int kCOB = kTX * kCPT;      // output channels per block
constexpr int kThreads = kTT * kTX;   // 128
constexpr int kCK = 32;               // input channels per shared-memory stage
constexpr int kWK = kCK / 4;          // packed words per stage
constexpr int kSmemWords = 16 * kWK * kTT + 16 * kWK * kCOB;

// The 16 values of V for channel c of tile g (row-major over N x th x tw),
// each rounded to float once; zeros past the map.
__device__ __forceinline__ void tile_v(const float* __restrict__ x, int g, int c, int H, int W,
                                       int Cin, int th, int tw, float (&v)[16]) {
  const int n = g / (th * tw);
  const int r = g - n * th * tw;
  const int y0 = (r / tw) * 2 - 1;
  const int x0 = (r % tw) * 2 - 1;
  double d[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int yy = y0 + i, xx = x0 + j;
      d[i][j] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                    ? x[(static_cast<size_t>(n * H + yy) * W + xx) * Cin + c]
                    : 0.0;
    }
  double vv[4][4];
  wt::sandwich<2, 4, false>(d, vv);
#pragma unroll
  for (int p = 0; p < 16; ++p) v[p] = static_cast<float>(vv[p / 4][p % 4]);
}

// kStash: the Cout > 128 branch (one scale per row over all of Cin).
template <bool kStash>
__global__ void __launch_bounds__(kThreads) winograd_int8_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ uq, const float* __restrict__ su,
    const float* __restrict__ scale, const float* __restrict__ bias, float* __restrict__ out,
    int N, int H, int W, int Cin, int Cout, int cg, int relu) {
  extern __shared__ __align__(16) int smem[];
  int(*Vq)[kWK][kTT] = reinterpret_cast<int(*)[kWK][kTT]>(smem);
  int(*Uq)[kWK][kCOB] = reinterpret_cast<int(*)[kWK][kCOB]>(smem + 16 * kWK * kTT);
  float* sv = reinterpret_cast<float*>(smem + kSmemWords);  // [kTT][16][groups]

  const int groups = kStash ? 1 : Cin / cg;
  const int glen = kStash ? Cin : cg;
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int lane = tid % 32, warp = tid / 32;
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const int nt = N * th * tw;
  const int t0 = blockIdx.x * kTT;
  const int co0 = blockIdx.y * kCOB;

  // Pass 1: every row's scale, a warp per tile, a lane per channel.
  for (int lt = warp; lt < kTT; lt += kThreads / 32) {
    const int g = t0 + lt;
    if (g >= nt) continue;
    for (int grp = 0; grp < groups; ++grp) {
      float m[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) m[p] = 0.f;
      for (int c = grp * glen + lane; c < (grp + 1) * glen; c += 32) {
        float v[16];
        tile_v(x, g, c, H, W, Cin, th, tw, v);
#pragma unroll
        for (int p = 0; p < 16; ++p) m[p] = fmaxf(m[p], fabsf(v[p]));
      }
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const float mx = wt::warp_max(m[p]);
        if (lane == 0)
          sv[(lt * 16 + p) * groups + grp] =
              kStash ? (mx == 0.f ? 1.f : mx) / 127.f : wt::scale_from_max(mx);
      }
    }
  }
  __syncthreads();

  // Pass 2: quantized products, int32 per group; f32 per row over groups.
  int acc[16][kCPT];
  float mm[16][kCPT];
#pragma unroll
  for (int p = 0; p < 16; ++p)
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      acc[p][j] = 0;
      mm[p][j] = 0.f;
    }
  const int gt = t0 + ty;  // this thread's tile
  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    const int grp = kStash ? 0 : c0 / cg;
    // V of the stage, quantized, four channels to a word.
    for (int idx = tid; idx < kTT * kWK; idx += kThreads) {
      const int lt = idx / kWK;
      const int w = idx - lt * kWK;
      const int g = t0 + lt;
      unsigned int word[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) word[p] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * w + e;
        if (g < nt && c < Cin) {
          float v[16];
          tile_v(x, g, c, H, W, Cin, th, tw, v);
#pragma unroll
          for (int p = 0; p < 16; ++p) {
            const int q = wt::quantize(v[p], sv[(lt * 16 + p) * groups + grp]);
            word[p] |= static_cast<unsigned int>(q & 0xff) << (8 * e);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 16; ++p) Vq[p][w][lt] = static_cast<int>(word[p]);
    }
    // The stage's slice of u_q; neighbouring threads take neighbouring
    // output channels.
    for (int idx = tid; idx < 16 * kWK * kCOB; idx += kThreads) {
      const int p = idx / (kWK * kCOB);
      const int rem = idx - p * (kWK * kCOB);
      const int w = rem / kCOB;
      const int co = co0 + rem - w * kCOB;
      int q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * w + e;
        q[e] = (c < Cin && co < Cout)
                   ? static_cast<int>(uq[(static_cast<size_t>(p) * Cin + c) * Cout + co])
                   : 0;
      }
      Uq[p][w][rem - w * kCOB] = wt::pack4(q[0], q[1], q[2], q[3]);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWK; ++w)
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const int a = Vq[p][w][ty];
        const int4 b = *reinterpret_cast<const int4*>(&Uq[p][w][tx * kCPT]);
        acc[p][0] = __dp4a(a, b.x, acc[p][0]);
        acc[p][1] = __dp4a(a, b.y, acc[p][1]);
        acc[p][2] = __dp4a(a, b.z, acc[p][2]);
        acc[p][3] = __dp4a(a, b.w, acc[p][3]);
      }
    __syncthreads();
    if (!kStash && gt < nt && (c0 + kCK >= Cin || (c0 + kCK) % cg == 0)) {
      // The group ends here: dequantize its product and add it in group order.
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const float s = sv[(ty * 16 + p) * groups + grp];
#pragma unroll
        for (int j = 0; j < kCPT; ++j) {
          const int co = min(co0 + tx * kCPT + j, Cout - 1);
          const float part = wt::dequant(acc[p][j], s, su[p * Cout + co]);
          mm[p][j] = grp == 0 ? part : __fadd_rn(mm[p][j], part);
          acc[p][j] = 0;
        }
      }
    }
  }

  if (gt >= nt) return;
  const int n = gt / (th * tw);
  const int r = gt - n * th * tw;
  const int oy0 = (r / tw) * 2;
  const int ox0 = (r % tw) * 2;
#pragma unroll
  for (int j = 0; j < kCPT; ++j) {
    const int co = co0 + tx * kCPT + j;
    if (co >= Cout) continue;
    double md[4][4];
#pragma unroll
    for (int p = 0; p < 16; ++p)
      md[p / 4][p % 4] = kStash ? wt::dequant(acc[p][j], sv[ty * 16 + p], su[p * Cout + co])
                                : mm[p][j];
    double y[2][2];
    wt::sandwich<2, 2, true>(md, y);
#pragma unroll
    for (int oi = 0; oi < 2; ++oi)
#pragma unroll
      for (int oj = 0; oj < 2; ++oj) {
        const int oy = oy0 + oi, ox = ox0 + oj;
        if (oy < H && ox < W) {
          float val = wt::bn_rn(static_cast<float>(y[oi][oj]), scale[co], bias[co]);
          if (relu) val = fmaxf(val, 0.f);
          out[(static_cast<size_t>(n * H + oy) * W + ox) * Cout + co] = val;
        }
      }
  }
}

template <bool kStash>
int launch(const float* x, const int8_t* uq, const float* su, const float* scale,
           const float* bias, float* out, int N, int H, int W, int Cin, int Cout, int cg,
           int relu, cudaStream_t stream) {
  const int groups = kStash ? 1 : Cin / cg;
  const size_t smem = 4 * (static_cast<size_t>(kSmemWords) + static_cast<size_t>(kTT) * 16 * groups);
  const void* fn = reinterpret_cast<const void*>(winograd_int8_kernel<kStash>);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int nt = N * ((H + 1) / 2) * ((W + 1) / 2);
  const dim3 grid((nt + kTT - 1) / kTT, (Cout + kCOB - 1) / kCOB);
  winograd_int8_kernel<kStash><<<grid, kThreads, smem, stream>>>(x, uq, su, scale, bias, out, N,
                                                                 H, W, Cin, Cout, cg, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stash = 1 takes the Cout > 128 branch (one scale per row over all of Cin,
// the JAX kernel's quantized V stash), 0 the per-group branch.
extern "C" int winograd_int8_conv3x3_bn(const float* x, const int8_t* uq, const float* su,
                                        const float* scale, const float* bias, float* out,
                                        int N, int H, int W, int Cin, int Cout, int stash,
                                        int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int cg = Cin % 128 == 0 ? 128 : Cin;
  if (stash) return launch<true>(x, uq, su, scale, bias, out, N, H, W, Cin, Cout, cg, relu, s);
  return launch<false>(x, uq, su, scale, bias, out, N, H, W, Cin, Cout, cg, relu, s);
}
