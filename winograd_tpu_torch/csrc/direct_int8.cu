// Int8 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) as an implicit GEMM
// with per-im2col-row dynamic quantization: row p = (n, y, x) of the im2col
// matrix (K = 9 * Cin, k = (3r + s) * Cin + c, zero where the window leaves
// the map) gets its own scale over its 9 * Cin values, so one input pixel is
// quantized with a different scale for each output pixel that gathers it.
//
// Replaces: winograd_tpu/kernels/quantized.py::_direct_int8_kernel and
// ::_direct_int8_banded_kernel (conv3x3_bn_int8_pallas). The banded body is
// the same arithmetic cut into row bands to fit the TPU's scoped VMEM; here
// one kernel covers both. On the int8 ResNet-50 path it runs the projection
// block's 3x3 at 56x56x64, on the int8 ResNet-34 path conv5_x's entry b-leg
// at 7x7x512.
//
// Bound on the H100: bytes. At 7x7x512 the 0.12 G int8 MACs take 0.12 us
// at 1979 TOPS, the f32 map in and out and 2.4 MB of int8 weights 0.77 us
// at 3.35 TB/s; at 56x56x64, 0.49 us of f32 activations. But 49 rows give
// 8 output tiles of 64 x 64: a tile a block leaves 124 of 132 SMs idle, and
// each block's walk over K = 4608 is the time.
//
// Design: one launch of wgmma_s8_cluster.cuh's s8 wgmma GEMM (csrc/
// pointwise_int8.cu's cluster path) on the im2col rows (XIm2col: a
// thread's load names the source pixel of its k, or zero where the window
// leaves the map; the im2col matrix is never written). The K splits of a
// 64 x 64 or 64 x 128 output tile are the blocks of one thread-block
// cluster: each block takes its rows' max |a| over its K range, the cluster
// exchanges them into each row's maximum over all of 9 * Cin (the plain
// version's scale, a NaN in a window included), and each block quantizes
// its range once and multiplies it against the weights (K, Cout) as they
// are stored, byte-permuted into wgmma's K-major operand as they are
// staged. The int32 partials meet in the cluster's shared memory and the
// Int8BnEpilogue is applied once per element, each multiply and add rounded
// in the plain version's order, so kernel and plain version agree to the
// bit. No cooperative grid, no grid barrier, no quantize phase, no weight
// transpose and no workspace. The tile width and the K split are the host's
// plan (kernels/quantized.py::direct_int8_plan, the int8 pointwise's
// cluster rule); this entry checks it against the geometry compiled here.

#include <stdint.h>

#include "common.cuh"
#include "wgmma_s8_cluster.cuh"

namespace sc = wt::s8cluster;

// The host's plan: Kp, K = 9 * Cin padded to a multiple of 32 (the s8
// wgmma k step); `tile` the output tiles' width, 64 or 128; `blocks` the
// grid, tiles x splits; Kp in `splits` ranges of `chunk`, the last one
// shorter, chunk a multiple of sc::kClusterStep when splits > 1, at most
// sc::kClusterMax splits. x must be 16-byte aligned and Cin a multiple of 4
// (the wrapper pads Cin).
extern "C" int direct_int8_conv3x3_bn(const float* x, const int8_t* w9q, const float* sw,
                                      const float* scale, const float* bias, float* out, int N,
                                      int H, int W, int Cin, int Cout, int relu, int Kp, int tile,
                                      int blocks, int splits, int chunk, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = N * H * W;
  const sc::Args a{w9q, sw, scale, bias, out, P, 9 * Cin, Cout, relu, Kp, splits, chunk};
  const cudaError_t e = sc::run<sc::kClusterMax>(a, sc::XIm2col{x, H, W, Cin, P}, tile, blocks,
                                                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
