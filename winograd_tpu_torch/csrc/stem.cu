// Fused ResNet stem: 7x7/2 conv (pad 3) + folded BN + ReLU + 3x3/2 maxpool
// (pad 1 top/left, ceil-mode output), NHWC image -> pooled NHWC map, at
// precision "f32", "bf16" or "bf16w". "bf16" is the int8 serving tier's
// stem: the image and the weights are rounded to bf16 (round to nearest
// even) as they are staged. "bf16w" is the bf16w tier's: the image stays
// f32 and w192 is bf16 in device memory (half its bytes). At every
// precision the products run on the FP64 tensor cores (mma.sync m16n8k4
// .f64): a product of two bf16, of two f32 or of an f32 and a bf16 value is
// exact in FP64, the 49 * Cin products of a conv output are summed in FP64
// and rounded to float once, then BN's multiply and add round separately.
// At "bf16" the sum is then independent of its order, so the plain version
// (a float64 matmul of the same bf16 values) matches the kernel to the bit,
// which the int8 layers after the stem need (csrc/stage_int8.cu says why);
// at "bf16w" the plain version is the same float64 matmul of the f32 image
// and the bf16 weights (the JAX kernel's hi/lo split of the image differs
// from exact products by ~2^-17 relative); at "f32" the sum rounded once is
// within the f32 bar of the plain float32 matmul.
//
// Replaces: winograd_tpu/kernels/stem.py::_stem_kernel (stem_fused_pallas,
// stem_fused_pallas_pre). The TPU kernel consumes a space-to-depth operand
// built outside it, a relayout that exists for the TPU's 128-lane tiling;
// this kernel takes the same w192 weight operand (rows ordered (a, b, u, v,
// c), tap (r, s) = (2a+u, 2b+v), see models/resnet50.py::stem_filter_s2d),
// mapping each tap to its row itself, and reads its image in one of two
// forms. stem_conv7x7_bn_relu_maxpool reads the raw NHWC image, masking
// each load at the borders. stem_pre_conv7x7_bn_relu_maxpool (the prepared-
// input contract, stem_fused_pallas_pre's counterpart) reads the operand
// kernels/stem.py::stem_prepare_input builds on the host: the image
// zero-padded by 3 on every side and its channels zero-padded to a multiple
// of 4, (N, H + 6, W + 6, C4). Each pixel is then C4 / 4 aligned 16-byte
// loads with one bounds check a pixel (the tiles' halos pass the padded
// image only at its borders), and no division by Cin. The staged patch is
// the same as the raw route's, so the two entries agree to the bit.
//
// Bound on the H100: at 224x224x3 -> 112x112x64 the conv is 236 MFLOP on
// 0.6 MB of image and 0.8 MB of pooled output: bound by operations, 3.5 us
// at the FP64 tensor cores' 67 TFLOP/s (the products the tile computes,
// with the pool windows' shared borders and K padded to 148, are 1.26x
// that).
//
// Design: an implicit GEMM per block. A block owns a 4 x 8 tile of pooled
// outputs and kCB = 32 output channels (C = 64 gives two channel blocks,
// 196 blocks at N=1 for 132 SMs, all resident at two an SM). M is the tile's 9 x
// 17 conv positions (the pool windows need them; 20% are recomputed at the
// tile borders), padded to 160; N its 32 channels; K = 49 * Cin, padded to
// the MMA depth 4 (148 at Cin = 3, the pad's weights zero). The block
// stages its 23 x 39 x Cin input patch and its K x 32 weights in shared
// memory as doubles (rounded to bf16 first at "bf16"; four loads in flight
// a thread, since a block's first touch of its operands is latency bound,
// and the launch is little more than one wave at N=1), and a table of each
// k's patch offset, so the K loop holds no division: A[m][k] is
// patch[moff[m] + koff[k]]. Ten warps each own 32 x 16 outputs (two m16
// by two n8 fragments), so every A value loaded from shared memory feeds
// two MMAs and every B value two. m16n8k4 ran 21% faster than m8n8k4 on
// eight warps of 40 x 16 at N=1, 5% at N=8 (tools/chip_split_sweep.py
// --ab, PERF.md); without the MMAs the kernel takes half its time at N=1
// and N=8, so staging, the operands' shared-memory loads, the epilogue and
// the pool are the other half. After the products the conv tile
// goes through BN and ReLU into shared memory (over the staged operands),
// and the pool reads it from there, its stores coalesced over channels.
// Conv positions outside the conv map (the pool's top/left pad, ceil-mode
// overhang) are stored as 0: after the ReLU every value is >= 0 and every
// pool window holds a real position, so max with 0 is exact.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kPY = 4;                 // pooled rows per block
constexpr int kPX = 8;                 // pooled columns per block
constexpr int kCR = 2 * kPY + 1;       // conv rows per block
constexpr int kCC = 2 * kPX + 1;       // conv columns per block
constexpr int kIR = 2 * (kCR - 1) + 7; // input rows per block
constexpr int kIC = 2 * (kCC - 1) + 7; // input columns per block
constexpr int kCB = 32;                // output channels per block
constexpr int kWarpsM = 5;             // warps along M
constexpr int kWarpsN = 2;             // warps along N
constexpr int kFragsM = 2;             // m16 fragments per warp
constexpr int kFragsN = 2;             // n8 fragments per warp
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kM = kCR * kCC;          // conv positions per block
constexpr int kLdB = kCB + 4;          // doubles per staged weight row (conflict-free B loads)
constexpr int kLdC = kCB + 1;          // floats per conv-tile row
static_assert(kWarpsM * kFragsM * 16 >= kM, "the warps' fragments cover the conv tile");
static_assert(kWarpsN * kFragsN * 8 == kCB, "the warps' fragments cover the channel block");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The precisions of the C entry, kernels/stem.py::PRECISIONS in order.
constexpr int kF32 = 0, kBf16 = 1, kBf16w = 2;

// d += a * b on one 16x8x4 fragment: a at (rows lane / 4 and lane / 4 + 8,
// k lane % 4), b at (k lane % 4, column lane / 4), d at (rows lane / 4 and
// lane / 4 + 8, columns 2 (lane % 4) and 2 (lane % 4) + 1).
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2], double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// K (49 * Cin) padded to the MMA depth.
__host__ __device__ __forceinline__ int padded_k(int Cin) { return (49 * Cin + 3) / 4 * 4; }

__host__ __device__ __forceinline__ size_t smem_bytes(int Cin) {
  const size_t staged = sizeof(double) * (padded_k(Cin) * kLdB + kIR * kIC * Cin) +
                        sizeof(int) * padded_k(Cin);
  const size_t conv = sizeof(float) * kM * kLdC;
  return staged > conv ? staged : conv;
}

// Stages `count` values into shared memory with kBatch loads in flight a
// thread (a block's first touch of its operands is latency bound): at(idx)
// reads value idx (a float, or a float4 of the prepared operand), put(idx,
// v) stores it.
template <class At, class Put>
__device__ __forceinline__ void stage(int count, const At& at, const Put& put) {
  using V = decltype(at(0));
  constexpr int kBatch = 4;
  for (int base = threadIdx.x; base < count; base += kBatch * kThreads) {
    V v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      v[u] = idx < count ? at(idx) : V{};
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (base + u * kThreads < count) put(base + u * kThreads, v[u]);
  }
}

// kRound: round the image and the weights to bf16 as they are staged
// ("bf16"); kPre: x is the prepared operand (N, H + 6, W + 6, C4), else the
// raw image (N, H, W, Cin); WT: w192's element type (__nv_bfloat16 at
// "bf16w").
template <bool kRound, bool kPre, class WT>
__global__ void __launch_bounds__(kThreads, 2) stem_kernel(
    const float* __restrict__ x, const WT* __restrict__ w192,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int H, int W, int Cin, int C) {
  extern __shared__ __align__(16) double smem[];
  const int kp = padded_k(Cin);
  double* ws = smem;                                              // [kp][kLdB]
  double* xs = ws + kp * kLdB;                                    // [kIR][kIC][Cin]
  int* koff = reinterpret_cast<int*>(xs + kIR * kIC * Cin);       // [kp]
  float* cs = reinterpret_cast<float*>(smem);                     // [kM][kLdC], after the products

  const int tid = threadIdx.x;
  const int ho = (H + 1) / 2;
  const int wo = (W + 1) / 2;
  const int po = (ho + 1) / 2;
  const int qo = (wo + 1) / 2;
  const int cblocks = (C + kCB - 1) / kCB;
  const int n = blockIdx.z / cblocks;
  const int c0 = (blockIdx.z - n * cblocks) * kCB;
  const int py0 = blockIdx.y * kPY;
  const int px0 = blockIdx.x * kPX;

  // Weights, k = (7r + s) * Cin + ci, and each k's offset in the patch.
  stage(
      kp * kCB,
      [&](int idx) {
        const int j = idx % kCB;
        const int k = idx / kCB;
        if (k >= 49 * Cin || c0 + j >= C) return 0.f;
        const int ci = k % Cin;
        const int rs = k / Cin;
        const int r = rs / 7;
        const int s = rs % 7;
        const int row = (((r / 2) * 4 + s / 2) * 4 + (r % 2) * 2 + s % 2) * Cin + ci;
        return widen(w192[static_cast<size_t>(row) * C + c0 + j]);
      },
      [&](int idx, float v) { ws[idx / kCB * kLdB + idx % kCB] = kRound ? round_bf16(v) : v; });
  for (int k = tid; k < kp; k += kThreads) {
    const int rs = k / Cin;
    koff[k] = k < 49 * Cin ? ((rs / 7) * kIC + rs % 7) * Cin + k % Cin : 0;
  }
  // Conv row cy reads input rows 2*cy - 3 .. 2*cy + 3; this block's first
  // conv row is 2*py0 - 1.
  const int iy0 = 4 * py0 - 5;
  const int ix0 = 4 * px0 - 5;
  if constexpr (kPre) {
    // Padded row iy0 + 3 + t / kIC, column ix0 + 3 + t % kIC; item idx is
    // the 4-channel group idx % g4 of patch pixel t = idx / g4.
    const int hp = H + 6, wp = W + 6, c4 = (Cin + 3) / 4 * 4, g4 = c4 / 4;
    stage(
        kIR * kIC * g4,
        [&](int idx) {
          const int t = idx / g4;
          const int yy = iy0 + 3 + t / kIC;
          const int xx = ix0 + 3 + t % kIC;
          if (yy < 0 || yy >= hp || xx < 0 || xx >= wp) return make_float4(0.f, 0.f, 0.f, 0.f);
          return __ldg(reinterpret_cast<const float4*>(
              x + (static_cast<size_t>(n * hp + yy) * wp + xx) * c4 + 4 * (idx % g4)));
        },
        [&](int idx, float4 v) {
          const int t = idx / g4;
          const int c0 = 4 * (idx % g4);
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + j < Cin) xs[t * Cin + c0 + j] = kRound ? round_bf16(e[j]) : e[j];
        });
  } else {
    stage(
        kIR * kIC * Cin,
        [&](int idx) {
          const int ci = idx % Cin;
          const int t = idx / Cin;
          const int yy = iy0 + t / kIC;
          const int xx = ix0 + t % kIC;
          if (yy < 0 || yy >= H || xx < 0 || xx >= W) return 0.f;
          return x[(static_cast<size_t>(n * H + yy) * W + xx) * Cin + ci];
        },
        [&](int idx, float v) { xs[idx] = kRound ? round_bf16(v) : v; });
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = (warp % kWarpsM) * kFragsM * 16;
  const int nb = (warp / kWarpsM) * kFragsN * 8;
  int moff[kFragsM][2];
#pragma unroll
  for (int i = 0; i < kFragsM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + i * 16 + h * 8 + g;
      moff[i][h] = m < kM ? (2 * (m / kCC) * kIC + 2 * (m % kCC)) * Cin : 0;
    }
  double acc[kFragsM][kFragsN][4] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < kp; k0 += 4) {
    const int k = k0 + t4;
    const int ko = koff[k];
    double a[kFragsM][2], b[kFragsN];
#pragma unroll
    for (int i = 0; i < kFragsM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[i][h] = xs[moff[i][h] + ko];
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) b[j] = ws[k * kLdB + nb + j * 8 + g];
#pragma unroll
    for (int i = 0; i < kFragsM; ++i)
#pragma unroll
      for (int j = 0; j < kFragsN; ++j) dmma(acc[i][j], a[i], b[j]);
  }
  __syncthreads();  // the conv tile overwrites the staged operands

#pragma unroll
  for (int i = 0; i < kFragsM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + i * 16 + h * 8 + g;
      if (m >= kM) continue;
      const int cy = 2 * py0 - 1 + m / kCC;
      const int cx = 2 * px0 - 1 + m % kCC;
      const bool live = cy >= 0 && cy < ho && cx >= 0 && cx < wo;
#pragma unroll
      for (int j = 0; j < kFragsN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nb + j * 8 + 2 * t4 + e;
          const float conv = static_cast<float>(acc[i][j][2 * h + e]);
          cs[m * kLdC + c] =
              live && c0 + c < C
                  ? fmaxf(__fadd_rn(__fmul_rn(conv, scale[c0 + c]), bias[c0 + c]), 0.f)
                  : 0.f;
        }
    }
  __syncthreads();

  for (int idx = tid; idx < kPY * kPX * kCB; idx += kThreads) {
    const int c = idx % kCB;
    const int t = idx / kCB;
    const int lx = t % kPX;
    const int ly = t / kPX;
    const int py = py0 + ly;
    const int px = px0 + lx;
    if (py >= po || px >= qo || c0 + c >= C) continue;
    float mx = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        mx = fmaxf(mx, cs[((2 * ly + dr) * kCC + 2 * lx + dc) * kLdC + c]);
    out[(static_cast<size_t>(n * po + py) * qo + px) * C + c0 + c] = mx;
  }
}

template <bool kRound, bool kPre, class WT>
int launch(const float* x, const WT* w192, const float* scale, const float* bias, float* out,
           int N, int H, int W, int Cin, int C, cudaStream_t stream) {
  const long long cblocks = (C + kCB - 1) / kCB;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || C <= 0 || N * cblocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Cin);
  const auto kernel = &stem_kernel<kRound, kPre, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int po = ((H + 1) / 2 + 1) / 2;
  const int qo = ((W + 1) / 2 + 1) / 2;
  const dim3 grid((qo + kPX - 1) / kPX, (po + kPY - 1) / kPY, static_cast<unsigned>(N * cblocks));
  kernel<<<grid, kThreads, smem, stream>>>(x, w192, scale, bias, out, H, W, Cin, C);
  return static_cast<int>(cudaGetLastError());
}

// precision: kF32, kBf16 (w192 f32, rounded to bf16 as it is staged) or
// kBf16w (w192 bf16 in device memory).
template <bool kPre>
int dispatch(const float* x, const void* w192, const float* scale, const float* bias,
             float* out, int N, int H, int W, int Cin, int C, int precision, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w192);
  switch (precision) {
    case kF32:
      return launch<false, kPre>(x, wf, scale, bias, out, N, H, W, Cin, C, s);
    case kBf16:
      return launch<true, kPre>(x, wf, scale, bias, out, N, H, W, Cin, C, s);
    case kBf16w:
      return launch<false, kPre>(x, static_cast<const __nv_bfloat16*>(w192), scale, bias, out,
                                 N, H, W, Cin, C, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: the raw image (N, H, W, Cin).
extern "C" int stem_conv7x7_bn_relu_maxpool(const float* x, const void* w192,
                                            const float* scale,
                                            const float* bias, float* out,
                                            int N, int H, int W, int Cin,
                                            int C, int precision, void* stream) {
  return dispatch<false>(x, w192, scale, bias, out, N, H, W, Cin, C, precision, stream);
}

// xb: the prepared operand (N, H + 6, W + 6, C4) of an H x W image with Cin
// channels, C4 = Cin rounded up to a multiple of 4 (kernels/stem.py::
// stem_prepare_input), 16-byte aligned.
extern "C" int stem_pre_conv7x7_bn_relu_maxpool(const float* xb, const void* w192,
                                                const float* scale, const float* bias,
                                                float* out, int N, int H, int W, int Cin,
                                                int C, int precision, void* stream) {
  return dispatch<true>(xb, w192, scale, bias, out, N, H, W, Cin, C, precision, stream);
}
