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
// served paths it runs ResNet-50's projection 3x3 at 56x56x64 and
// ResNet-34's identity 3x3s at 56x56x64, 28x28x128 and 14x14x256, all
// F(2,3).
//
// Bound on the H100: at each served shape the 16 products of (tiles x Cin x
// Cout) are 103 MFLOP at N=1; as three TF32 passes (the 3xTF32 split) at
// 495 TFLOP/s that is 0.6 us, and the map, U and the output (1.9 MB at
// 28x28x128) take about as long at 3.35 TB/s. But the products are small:
// 49 to 784 tiles (1 to 13 blocks of 64 rows) x 64 to 256 output channels,
// a handful of MMA tiles per position; a kernel that gives a block all
// positions of 64 tiles and all of Cout (as the TPU kernel does) fills 7
// to 98 of the 132 SMs and walks all of Cin for 16 positions alone.
//
// Design (the f32 route): one cooperative launch of wino_tf32.cuh's phase.
// The grid writes V once to the workspace; after a grid barrier, work items
// (position, Cin split, tile block, Cout block), cut by the host's plan
// (kernels/winograd.py::winograd_plan: Cin split until the items reach the
// grid's blocks, at 28x28x128 and 14x14x256), multiply V[q] by U[q] on
// wgmma_tile.cuh's tile (one warpgroup's wgmma m64n64k8 in 3xTF32, each
// 32-deep stage's products added in FP32; U[q] by TMA as boxes of the
// (16, Cin, Cout) filter's tensor map, block q, onto mbarriers; V by
// cp.async.cg, since V was written in the launch) and write their partial
// M; after a second barrier the grid adds each position's splits in split
// order and applies At M At^T and BN, so calls repeat to the bit. V and M
// take 3.2 MB each at N=1 56x56x64 and 26 MB each at N=8, more than half
// the 50 MB L2 together: there M is written while V is read, and part of
// both goes to HBM. At N=1 the launch's time is its three phases (~16 us),
// not the products; the tile moves the N=8 items. This entry checks the
// plan against the geometry compiled here and refuses a grid larger than
// the card holds resident.
//
// winograd_conv3x3_bn_bf16w is the bf16w tier's F(2,3) (the JAX package's
// conv3x3_bn_winograd_pallas(precision="bf16w"): ResNet-18/34's identity
// 3x3s and ResNet-50's projection 3x3 at bf16w): the same cooperative
// launch and plan on a bf16 U, its products on the tile's bf16 wgmma
// m64n64k16 (V split hi/lo into two passes, U read straight from TMA's
// 128-byte-swizzled boxes), the V phase and the inverse FP32. U streams
// at half the f32 bytes, and a k16 step is two tensor-core instructions
// where 3xTF32 takes six.
//
// winograd_conv3x3_bn_bf16 is the int8 tier's exact bf16-filter 3x3:
// winograd.cuh's FP64 F(2,3) tile on a bf16 filter, which computes JAX's
// bf16w op exactly (the JAX kernel's hi/lo split of V is within ~2^-17 of
// it), its products on the FP64 tensor cores (mma.sync .f64), its
// arithmetic equal to a float64 plain version to the bit, as the int8
// layer it feeds needs. Bound on the H100: the 16 products of (tiles x Cin
// x Cout) are 103 MFLOP at N=1 56x56x64, 1.5 us at the FP64 tensor cores'
// 67 TFLOP/s; the map, U and the output take 0.5 us at 3.35 TB/s. Its
// launch walks the host's plan (kernels/winograd.py::winograd_fp64_plan):
// items of 16 tiles x `cols` output channels, the Cout block narrowed
// until the items fill the card at N=1, on a grid of `blocks` blocks of
// 256 threads; the entry refuses a plan off the geometry compiled here.

#include <cuda_bf16.h>

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "winograd.cuh"
#include "wino_tf32.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace wg = wt::wg;
namespace wtc = wt::winotc;

// The FP64 route: items of wt::kF64Tiles tiles x CB output channels
// (the plan's cols), dealt over the grid.
template <int CB>
__global__ void __launch_bounds__(wt::kF64Threads, 1) winograd_f64_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ u,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int N, int H, int W, int Cin, int Cout, int relu) {
  extern __shared__ __align__(16) float smem[];
  const int cgroups = (Cout + CB - 1) / CB;
  const int items = wt::f64_tile_groups(N, H, W) * cgroups;
  for (int item = blockIdx.x; item < items; item += gridDim.x)
    wt::wino_f64_tile<CB>(wt::PlainLoad{}, x, u, scale, bias, out, N, H, W, Cin, Cout, relu,
                          item / cgroups * wt::kF64Tiles, item % cgroups * CB, smem);
}

template <int CB>
int launch_f64(const float* x, const __nv_bfloat16* u, const float* scale, const float* bias,
               float* out, int N, int H, int W, int Cin, int Cout, int relu, int blocks,
               cudaStream_t stream) {
  static bool raised[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  constexpr int kBytes = wt::F64Smem<CB>::kBytes;
  if (!raised[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(reinterpret_cast<const void*>(&winograd_f64_kernel<CB>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = true;
  }
  winograd_f64_kernel<CB><<<blocks, wt::kF64Threads, kBytes, stream>>>(x, u, scale, bias, out, N,
                                                                        H, W, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route, f32 (3xTF32) or bf16w; UT: U's element type; map:
// U as (Cout, Cin, a^2) for the TMA loads (kVec).
template <class UT>
struct TcArgs {
  CUtensorMap map;
  const float* x;
  const UT* u;
  const float* scale;
  const float* bias;
  float* out;
  float* v;
  float* part;
  unsigned int* bar;
  wtc::Conv cv;
  wtc::Cut cut;
  int relu;
};

template <int M, bool kVec, class UT>
__global__ void __launch_bounds__(wg::kThreads) winograd_tc_kernel(
    const __grid_constant__ TcArgs<UT> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[wg::kStages];
  wg::Ring ring = wg::make_ring(smem, bars);
  wtc::phase<M, kVec, false>(a.cv, a.cut, a.x, a.u, a.scale, a.bias, a.out, a.relu, a.v, a.part,
                             a.bar, wtc::Tc{&a.map, 0, &ring});
}

// Blocks of the instantiation that the current device holds resident (its
// dynamic shared memory limit, the wgmma tile's ring, raised once per
// device); 0 on error.
template <int M, bool kVec, class UT>
int resident_blocks() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    const void* kernel = reinterpret_cast<const void*>(&winograd_tc_kernel<M, kVec, UT>);
    constexpr size_t smem = wg::kSmemBytes<UT>;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
      return 0;
    cache[dev] = cooperative_grid(kernel, smem, wg::kThreads);
  }
  return cache[dev];
}

template <int M, bool kVec, class UT>
int launch_tc(TcArgs<UT>& a, int blocks, cudaStream_t s) {
  const int resident = resident_blocks<M, kVec, UT>();
  if (resident <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaMemsetAsync(a.bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&winograd_tc_kernel<M, kVec, UT>), dim3(blocks),
      dim3(wg::kThreads), args, wg::kSmemBytes<UT>, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class UT>
int conv_tc(const float* x, const UT* u, const float* scale, const float* bias, float* out,
            float* ws, long long ws_words, long long v, long long part, int N, int H, int W,
            int Cin, int Cout, int m, int relu, int tile, int blocks, int splits, int chunk,
            void* stream) {
  constexpr bool kBf16 = std::is_same_v<UT, __nv_bfloat16>;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || (m != 2 && (kBf16 || m != 4)) ||
      tile != wg::kBM || blocks <= 0 || ws == nullptr || !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int a2 = (m + 2) * (m + 2);
  const wtc::Conv cv = m == 2 ? wtc::make_conv<2>(N, H, W, Cin, Cout)
                              : wtc::make_conv<4>(N, H, W, Cin, Cout);
  const wtc::Cut cut{splits, chunk};
  if (!wtc::cut_fits(cv, cut) || v < 2 || v % 4 != 0 || part % 4 != 0 ||
      part < v + static_cast<long long>(wtc::v_floats(cv, a2)) ||
      ws_words < part + static_cast<long long>(wtc::part_floats(cv, a2, cut)))
    return static_cast<int>(cudaErrorInvalidValue);
  TcArgs<UT> a{};
  a.x = x;
  a.u = u;
  a.scale = scale;
  a.bias = bias;
  a.out = out;
  a.v = ws + v;
  a.part = ws + part;
  a.bar = reinterpret_cast<unsigned int*>(ws);
  a.cv = cv;
  a.cut = cut;
  a.relu = relu;
  const auto s = static_cast<cudaStream_t>(stream);
  // TMA loads (and 16-byte copies) of U: Cout a multiple of 4 floats or 8
  // bf16 values.
  const bool vec = Cout % (kBf16 ? 8 : 4) == 0 && aligned16(u);
  if (vec) {
    const cudaError_t e = wg::encode_weights(&a.map, u, a2, Cin, Cout);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if constexpr (kBf16) {
    return vec ? launch_tc<2, true>(a, blocks, s) : launch_tc<2, false>(a, blocks, s);
  } else {
    if (m == 2) return vec ? launch_tc<2, true>(a, blocks, s) : launch_tc<2, false>(a, blocks, s);
    return vec ? launch_tc<4, true>(a, blocks, s) : launch_tc<4, false>(a, blocks, s);
  }
}

}  // namespace

// The host's plan (kernels/winograd.py::winograd_plan): a cooperative grid
// of `blocks` blocks (at most what the card holds resident), Cin in
// `splits` ranges of `chunk` (the last one shorter; chunk a multiple of the
// MMA stage, tc::kBK, past one split); `tile` the width of the MMA tile, which
// must be this library's (64). ws: the grid barrier's two counters at word
// 0, V ((m+2)^2 x tiles x Cin rounded up to 4) from word `v`, the splits x
// (m+2)^2 x tiles x Cout partial products from word `part` (both multiples
// of 4, in that order), ws_words words in all.
extern "C" int winograd_conv3x3_bn(const float* x, const float* u, const float* scale,
                                   const float* bias, float* out, float* ws, long long ws_words,
                                   long long v, long long part, int N, int H, int W, int Cin,
                                   int Cout, int m, int relu, int tile, int blocks, int splits,
                                   int chunk, void* stream) {
  return conv_tc(x, u, scale, bias, out, ws, ws_words, v, part, N, H, W, Cin, Cout, m, relu, tile,
                 blocks, splits, chunk, stream);
}

// The bf16w tier: u (16, Cin, Cout) bf16, m = 2 only, the rest (plan and
// workspace) as winograd_conv3x3_bn.
extern "C" int winograd_conv3x3_bn_bf16w(const float* x, const __nv_bfloat16* u,
                                         const float* scale, const float* bias, float* out,
                                         float* ws, long long ws_words, long long v,
                                         long long part, int N, int H, int W, int Cin, int Cout,
                                         int m, int relu, int tile, int blocks, int splits,
                                         int chunk, void* stream) {
  return conv_tc(x, u, scale, bias, out, ws, ws_words, v, part, N, H, W, Cin, Cout, m, relu, tile,
                 blocks, splits, chunk, stream);
}

// F(2,3) on a bf16 filter (the int8 tier's bf16-weight 3x3): winograd.cuh's
// FP64 tile (transforms, products and sums in FP64, each output rounded to
// float once before a BN whose multiply and add round separately), so the
// result matches a float64 plain version to the bit. It feeds the next
// layer's int8 quantizations. u 16-byte aligned and Cout a multiple of 8
// (the wrapper pads it with zero channels); the host's plan
// (kernels/winograd.py::winograd_fp64_plan): items of 16 tiles x `cols`
// output channels (8, 16 or 32), on `blocks` blocks (at most the items).
extern "C" int winograd_conv3x3_bn_bf16(const float* x, const __nv_bfloat16* u,
                                        const float* scale, const float* bias, float* out,
                                        int N, int H, int W, int Cin, int Cout, int relu,
                                        int cols, int blocks, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cout % 8 != 0 || !aligned16(u) ||
      blocks <= 0 ||
      (cols != 8 && cols != 16 && cols != 32) ||
      static_cast<long long>(N) * ((H + 1) / 2) * ((W + 1) / 2) >= (1LL << 31) ||
      blocks > static_cast<long long>(wt::f64_tile_groups(N, H, W)) * ((Cout + cols - 1) / cols))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (cols == 8) return launch_f64<8>(x, u, scale, bias, out, N, H, W, Cin, Cout, relu, blocks, s);
  if (cols == 16)
    return launch_f64<16>(x, u, scale, bias, out, N, H, W, Cin, Cout, relu, blocks, s);
  return launch_f64<32>(x, u, scale, bias, out, N, H, W, Cin, Cout, relu, blocks, s);
}
