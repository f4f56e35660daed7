// Fused 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) by Winograd F(m,3),
// m = 2 or 4, in one launch:
//   V = Bt d Bt^T per (m+2)^2 input tile and channel,
//   M[p] = V[p] U[p] per tile position p (a (tiles, Cin) x (Cin, Cout) product),
//   Y = At M At^T, then y = Y * scale + bias (+ ReLU), stored clipped at the
//   right and bottom edges when m does not divide the map.
//
// Replaces: winograd_tpu/kernels/winograd.py::_winograd_kernel and
// ::_winograd_kernel_p64 (conv3x3_bn_winograd_pallas). The p64 variant packs
// two 64-channel tile columns into the TPU's 128 lanes; on Hopper the same
// kernel serves every channel count, so one kernel covers both. On the
// served ResNet-50 path it runs the projection block's 3x3 and the conv2_x
// identity blocks at 56x56x64, and the conv3_x identity blocks at 28x28x128,
// all F(2,3).
//
// Bound on the H100: F(2,3) does 16 products of (tiles x Cin x Cout) per
// 4 outputs; at 56x56x64 that is 103 MFLOP on 1.9 MB, at 28x28x128 103 MFLOP
// on 1.9 MB: both bound by the FP32 FFMA rate (and far from it, see below).
//
// Design: one block of 8 x 16 threads owns 8 tiles x COB output channels for
// every tile position, so the whole Winograd chain for those outputs stays
// on chip (the tile body is csrc/winograd.cuh, shared with the stage
// kernel's F(2,3) mid-layer). Input channels are consumed in stages of 8: the block gathers
// its tiles with zero padding (the left/top pad of 1 and the right/bottom
// overhang), applies Bt d Bt^T in registers with the constant matrices
// folded in at compile time, and stages V and the matching slice of U in
// shared memory. Each thread then accumulates, in registers, all (m+2)^2
// positions of one tile for CPT output channels (F(2,3): 16 x 4, F(4,3):
// 36 x 2 accumulators), applies At M At^T in registers, and stores with
// the BN epilogue. All arithmetic is FP32 FFMA with FP32 accumulation,
// which holds 1e-4 for F(4,3) too. The inner loop issues one shared-memory
// load per CPT FMAs, so it runs well below the FFMA peak; a wgmma/3xTF32
// product per position is later work.
//
// winograd_conv3x3_bn_bf16 is the same tile body at F(2,3) on a bf16
// filter in FP64 (the int8 tier's stride-1 3x3 at 64 channels, the JAX
// package's conv3x3_bn_winograd_pallas(precision="bf16w") at 56x56x64 on
// the basic family's int8 route).

#include <cuda_bf16.h>

#include "common.cuh"
#include "winograd.cuh"

namespace {

constexpr int kTT = 8;  // tiles per block (threadIdx.y)

// TU: the filter's element type; TA and CPT: winograd.cuh's arithmetic type
// and output channels per thread.
template <int M, class TU, class TA, int CPT>
__global__ void __launch_bounds__(kTT * wt::kWinoTX) winograd_kernel(
    const float* __restrict__ x, const TU* __restrict__ u,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int N, int H, int W, int Cin, int Cout,
    int relu) {
  __shared__ __align__(16) unsigned char smem[wt::wino_smem_bytes<M, kTT, TA, CPT>()];
  wt::wino_tile<M, kTT, wt::PlainLoad, TU, TA, CPT>(
      wt::PlainLoad{}, x, u, scale, bias, out, N, H, W, Cin, Cout, relu, blockIdx.x * kTT,
      blockIdx.y * wt::kWinoTX * CPT, threadIdx.y * wt::kWinoTX + threadIdx.x,
      reinterpret_cast<float*>(smem));
}

template <int M, class TU, class TA = float, int CPT = wt::Wino<M>::CPT>
int launch(const float* x, const TU* u, const float* scale,
           const float* bias, float* out, int N, int H, int W, int Cin,
           int Cout, int relu, cudaStream_t stream) {
  constexpr int COB = wt::kWinoTX * CPT;
  const int nt = N * ((H + M - 1) / M) * ((W + M - 1) / M);
  const dim3 grid((nt + kTT - 1) / kTT, (Cout + COB - 1) / COB);
  const dim3 block(wt::kWinoTX, kTT);
  winograd_kernel<M, TU, TA, CPT><<<grid, block, 0, stream>>>(x, u, scale, bias, out, N,
                                                              H, W, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int winograd_conv3x3_bn(const float* x, const float* u,
                                   const float* scale, const float* bias,
                                   float* out, int N, int H, int W, int Cin,
                                   int Cout, int m, int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (m == 2) return launch<2>(x, u, scale, bias, out, N, H, W, Cin, Cout, relu, s);
  if (m == 4) return launch<4>(x, u, scale, bias, out, N, H, W, Cin, Cout, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// F(2,3) on a bf16 filter (the int8 tier's bf16-weight 3x3): the filter is
// widened to float as it is staged, and the transforms, products and sums
// run in FP64, each output rounded to float once before a BN whose multiply
// and add round separately (winograd.cuh), so the result matches a float64
// plain version to the bit. It feeds the next layer's int8 quantizations.
extern "C" int winograd_conv3x3_bn_bf16(const float* x, const __nv_bfloat16* u,
                                        const float* scale, const float* bias, float* out,
                                        int N, int H, int W, int Cin, int Cout, int relu,
                                        void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<2, __nv_bfloat16, double, 2>(x, u, scale, bias, out, N, H, W, Cin, Cout, relu,
                                             static_cast<cudaStream_t>(stream));
}
