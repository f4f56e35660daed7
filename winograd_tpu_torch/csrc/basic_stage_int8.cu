// B int8 identity basic blocks (ResNet-18/34) over all N images in one
// persistent launch: per block b, with qdot(A, W) the int8 product of
// gemm_int8.cuh (per-row dynamic activation scale, int8 weights with
// per-column scales, exact int32 sum, dequantized in f32) and im2col the
// stride-1 SAME 3x3 patch matrix (K = 9 * C, zero padding included in each
// row's scale),
//   h1  = relu(qdot(im2col(act), w9_a_q[b]) * s_a[b] + b_a[b])
//   out = relu(qdot(im2col(h1), w9_b_q[b]) * s_b[b] + b_b[b] + act)
// with act = x for block 0 and out afterwards (updated in place: each
// residual element is read only by the thread that overwrites it).
//
// Replaces: winograd_tpu/kernels/basic_stage.py::_basic_stage_int8_kernel
// (basic_stage_int8_pallas). On the int8 ResNet-34 path it runs conv5_x's
// two identity blocks at 7x7x512 (ResNet-18: one).
//
// Bound on the H100: at N=1 and B=2 the 0.46 G int8 MACs take 0.47 us at
// 1979 TOPS and the quantization and epilogues ~1 us at the FP32 rate; the
// int8 weights, 4 * 2.4 MB read once, take 2.8 us at 3.35 TB/s: bound by
// bytes.
//
// Design: csrc/transition_int8.cu's folded phases (wgmma_s8_phase.cuh, the
// int8 stage's) in one cooperative launch: each conv is one gemm_phase on
// wgmma_s8.cuh's s8 wgmma m64n64k32 tiles, two warpgroups a block each on
// items of its own, the weights by TMA from k-contiguous (B, C, Kp) copies
// made once per weight tensor, at its first launch (kernels/
// basic_stage.py::basic_stage_int8_kmajor; s8 wgmma reads both operands
// K-major and TMA cannot transpose bytes), so no phase of the launch
// transposes weights and no phase only quantizes. A row's scale needs the
// max over its whole 9 * C window, written by many blocks in the phase
// before; so each producing epilogue publishes its pixels' max |v| (one
// atomicMax of the bits a row and tile) and the conv after it quantizes
// its own rows:
// * each conv's blocks quantize a share of its im2col rows into aq (a
//   row's scale the max of its nine pixels' published maxima, zero for a
//   tap outside the map, as the padding gives: wgmma_s8_phase.cuh::
//   Im2colSrc<1>), and each item waits only for its own row block's
//   counter;
// * the first conv's epilogue writes h1 and publishes h1's pixel maxima;
//   the second's writes out in place and publishes out's, which the next
//   block's first conv reads (the last block's are not published);
// * x has no producer in the launch: a first phase takes its pixel maxima,
//   a warp a pixel, while the first conv's first weight boxes land, one
//   grid barrier before block 0 (a block's share of x's im2col rows taking
//   their maxima itself, as XRowsSrc does for the transition's rows, ran
//   10 us longer at N=1: a row a block, a warp a row);
// * the maxima are kept per block (2 x B x P words) and the row blocks'
//   counters per conv and block, all zeroed by the launch's one memset
//   with the grid barrier: no phase zeroes any.
// A conv whose tiles are few splits K over items (kernels/basic_stage.py::
// basic_stage_int8_plan, in whole stages of the s8 tile; checked here
// against the geometry), its exact int32 partial sums added after a grid
// barrier, where the epilogue runs once per element. The next conv's first
// weight boxes are issued before each grid barrier. Grid barriers: one a
// conv (x's maxima's included), plus one for each conv that splits K.
// Int32 sums are exact and every f32 epilogue rounds each multiply and add
// on its own, in the plain version's order, so the kernel equals
// kernels/basic_stage.py::basic_stage_int8_plain to the bit.

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_s8.cuh"
#include "wgmma_s8_phase.cuh"

namespace {

namespace q8 = wt::wgs8;
namespace ph = wt::s8phase;

constexpr int kBlocksPerSm = 1;
constexpr int kSplitCap = 16;
constexpr int kKAlign = 32;  // K of the quantized rows and the k-contiguous weights padded to this

struct BasicStageInt8Args {
  CUtensorMap map_a, map_b;  // the k-contiguous (B, C, Kp) weights
  const float* x;
  float* out;
  const float* swa;  // (B, 1, C) weight scales
  const float* sa;   // (B, 1, C) folded BN
  const float* ba;
  const float* swb;
  const float* sb;
  const float* bb;
  float* h1;
  float* sx;      // a conv's row scales, P
  unsigned* mx1;  // h1's pixel maxima, B x P (block by block)
  unsigned* mxa;  // act's pixel maxima, B x P: x's, then out's after each block
  unsigned* cnt;  // the row blocks' counters: B blocks x 2 convs x row_blocks
  int8_t* aq;     // a conv's quantized im2col rows, (P, Kp)
  int* part;      // int32 partial sums
  unsigned int* bar;
  int N, H, W, C, B, Kp, row_blocks;
  wt::GemmPhase conv;
};

// The max |v| of each of x's P pixels (rows of C floats) as bits into
// mx[p], a warp a pixel over the grid (XRowsSrc's row maxima).
__device__ __forceinline__ void pixel_max(const float* x, int P, int C, unsigned* mx) {
  const int warps = gridDim.x * (q8::kThreads / 32);
  const ph::XRowsSrc rows{x, C, C};
  for (int p = blockIdx.x * (q8::kThreads / 32) + threadIdx.x / 32; p < P; p += warps) {
    unsigned m[1];
    rows.row_max<1>(p, 0, 1, m);
    if (threadIdx.x % 32 == 0) mx[p] = m[0];
  }
}

__global__ void __launch_bounds__(q8::kThreads, kBlocksPerSm)
    basic_stage_int8_kernel(const __grid_constant__ BasicStageInt8Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[q8::kWarpgroups * q8::kStages];
  q8::Ring ring = q8::make_ring(smem, bars);
  float* scratch = reinterpret_cast<float*>(ring.base - q8::wg_index() * q8::kRingBytes);
  const int c = a.C;
  const size_t P = static_cast<size_t>(a.N) * a.H * a.W;

  // x's pixel maxima, the first conv's first weight boxes meanwhile.
  ph::prefetch_phase(a.conv, q8::Weights{&a.map_a, 0}, ring);
  pixel_max(a.x, static_cast<int>(P), c, a.mxa);
  wt::grid_sync(a.bar);

  // Block by block: the first conv on act's im2col rows, then the second
  // on h1's, its residual act.
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bc = static_cast<size_t>(blk) * c;
    unsigned* cnt = a.cnt + static_cast<size_t>(blk) * 2 * a.row_blocks;
    unsigned* mx1 = a.mx1 + blk * P;
    unsigned* mxa = a.mxa + blk * P;
    const q8::Weights wa{&a.map_a, blk}, wb{&a.map_b, blk};

    // x is never written in the launch: block 0 reads it through L1.
    const ph::BnEpi e1{a.swa + bc, a.sa + bc, a.ba + bc, a.h1, c};
    if (blk == 0)
      ph::gemm_phase(a.conv, ph::Im2colSrc<1, true>{a.x, a.H, a.W, c, mxa}, a.Kp, wa, e1, mx1,
                     a.aq, a.sx, cnt, a.part, a.bar, ring, scratch, true);
    else
      ph::gemm_phase(a.conv, ph::Im2colSrc<1>{a.out, a.H, a.W, c, mxa}, a.Kp, wa, e1, mx1, a.aq,
                     a.sx, cnt, a.part, a.bar, ring, scratch, true);
    ph::prefetch_phase(a.conv, wb, ring);
    wt::grid_sync(a.bar);

    const ph::ResEpi e2{a.swb + bc, a.sb + bc, a.bb + bc, act, a.out, c};
    ph::gemm_phase(a.conv, ph::Im2colSrc<1>{a.h1, a.H, a.W, c, mx1}, a.Kp, wb, e2,
                   blk + 1 < a.B ? mxa + P : nullptr, a.aq, a.sx, cnt + a.row_blocks, a.part,
                   a.bar, ring, scratch, true);
    if (blk + 1 < a.B) {
      ph::prefetch_phase(a.conv, q8::Weights{&a.map_a, blk + 1}, ring);
      wt::grid_sync(a.bar);
    }
  }
}

// Blocks of the kernel the current device holds resident at once (a
// cooperative grid may not be larger), at most kBlocksPerSm an SM (its
// dynamic shared memory limit raised once per device); 0 on error.
int resident_blocks() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    const void* kernel = reinterpret_cast<const void*>(basic_stage_int8_kernel);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q8::kSmemBytes)) != cudaSuccess)
      return 0;
    cache[dev] = cooperative_grid(kernel, q8::kSmemBytes, q8::kThreads, kBlocksPerSm);
  }
  return cache[dev];
}

// 4-byte words holding `bytes` bytes, rounded up to the workspace's step.
size_t words_of(size_t bytes) { return workspace_round_up((bytes + 3) / 4); }

struct Layout {
  int Kp, row_blocks;
  wt::GemmPhase conv;
  // workspace offsets and size, in 4-byte words (the barrier, the counters
  // and the pixel maxima first: one memset of `zeroed` words zeroes them)
  size_t cnt, mx1, mxa, zeroed, h1, sx, aq, part, total;
};

// The workspace of the host's plan (K = 9 * C padded to kKAlign in `splits`
// ranges of `chunk`, each but the last a whole number of the tile's kBK-byte
// stages): the grid barrier's two counters at word 0, the row blocks'
// counters, h1's and act's pixel maxima, then h1, the row scales, the
// quantized rows and the int32 partial sums; an error if the shape or the
// plan does not fit.
int make_layout(int N, int H, int W, int C, int B, int splits, int chunk, Layout* l) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || B <= 0 || C % 4 != 0 || H >= (1 << 15) ||
      W >= (1 << 15))
    return static_cast<int>(cudaErrorInvalidValue);
  l->Kp = (9 * C + kKAlign - 1) / kKAlign * kKAlign;
  const size_t P = static_cast<size_t>(N) * H * W;
  l->conv = wt::GemmPhase{static_cast<int>(P), l->Kp, C, splits, chunk};
  const bool fits =
      splits == 1 ? chunk == l->Kp
                  : splits > 1 && splits <= kSplitCap && chunk % q8::kBK == 0 &&
                        static_cast<long long>(chunk) * splits >= l->Kp &&
                        static_cast<long long>(chunk) * (splits - 1) < l->Kp;
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  l->row_blocks = static_cast<int>((P + q8::kBM - 1) / q8::kBM);
  l->cnt = 2;
  l->mx1 = l->cnt + static_cast<size_t>(2) * B * l->row_blocks;
  l->mxa = l->mx1 + B * P;
  l->zeroed = l->mxa + B * P;
  l->h1 = workspace_round_up(l->zeroed);
  l->sx = l->h1 + workspace_round_up(P * C);
  l->aq = l->sx + workspace_round_up(P);
  l->part = l->aq + words_of(P * l->Kp);
  l->total = l->part + phase_partial_floats(l->conv);
  return 0;
}

}  // namespace

// Blocks an SM the cooperative grid takes at most (the host's plan,
// kernels/basic_stage.py::BASIC_STAGE_INT8_BLOCKS_PER_SM, checks against
// it).
extern "C" int basic_stage_int8_blocks_per_sm() { return kBlocksPerSm; }

// 4-byte words of workspace basic_stage_int8 needs for this shape and plan
// (into *words); returns a CUDA error code.
extern "C" int basic_stage_int8_workspace(int N, int H, int W, int C, int B, int blocks,
                                          int splits, int chunk, long long* words) {
  Layout l;
  const int err = blocks > 0 ? make_layout(N, H, W, C, B, splits, chunk, &l)
                             : static_cast<int>(cudaErrorInvalidValue);
  if (err == 0) *words = static_cast<long long>(l.total);
  return err;
}

// The host's plan (kernels/basic_stage.py::basic_stage_int8_plan): the
// cooperative grid's `blocks` (at most what the device holds resident) and
// the K split of both convs, Kp = 9 * C padded to kKAlign in `splits` ranges
// of `chunk`. wa_t, wb_t: the k-contiguous int8 weights, (B, C, Kp), zero
// past 9 * C, 16-byte aligned. C a multiple of 4 (the wrapper pads other
// counts with zero channels); x and out 16-byte aligned; ws at least
// basic_stage_int8_workspace's words, 16-byte aligned.
extern "C" int basic_stage_int8(const float* x, const int8_t* wa_t, const float* swa,
                                const float* sa, const float* ba, const int8_t* wb_t,
                                const float* swb, const float* sb, const float* bb, float* out,
                                float* ws, long long ws_words, int N, int H, int W, int C, int B,
                                int blocks, int splits, int chunk, void* stream) {
  Layout l;
  const int err = make_layout(N, H, W, C, B, splits, chunk, &l);
  if (err != 0) return err;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (blocks <= 0 || ws_words < static_cast<long long>(l.total) || !aligned(x) ||
      !aligned(out) || !aligned(ws) || !aligned(wa_t) || !aligned(wb_t))
    return static_cast<int>(cudaErrorInvalidValue);
  const int resident = resident_blocks();
  if (resident <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  BasicStageInt8Args a{};
  cudaError_t e = q8::encode_kmajor(&a.map_a, wa_t, B, C, l.Kp);
  if (e == cudaSuccess) e = q8::encode_kmajor(&a.map_b, wb_t, B, C, l.Kp);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto s = static_cast<cudaStream_t>(stream);
  // The barrier, the row blocks' counters and the pixel maxima in one memset.
  e = cudaMemsetAsync(ws, 0, l.zeroed * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto u32 = [&](size_t at) { return reinterpret_cast<unsigned*>(ws + at); };
  a.x = x;
  a.out = out;
  a.swa = swa;
  a.sa = sa;
  a.ba = ba;
  a.swb = swb;
  a.sb = sb;
  a.bb = bb;
  a.h1 = ws + l.h1;
  a.sx = ws + l.sx;
  a.mx1 = u32(l.mx1);
  a.mxa = u32(l.mxa);
  a.cnt = u32(l.cnt);
  a.aq = reinterpret_cast<int8_t*>(ws + l.aq);
  a.part = reinterpret_cast<int*>(ws + l.part);
  a.bar = u32(0);
  a.N = N;
  a.H = H;
  a.W = W;
  a.C = C;
  a.B = B;
  a.Kp = l.Kp;
  a.row_blocks = l.row_blocks;
  a.conv = l.conv;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(basic_stage_int8_kernel),
                                  dim3(blocks), dim3(q8::kThreads), args, q8::kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
