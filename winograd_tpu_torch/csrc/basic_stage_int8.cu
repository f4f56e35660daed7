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
// Design: csrc/stage_int8.cu's direct-mid phases on mma_int8.cuh, in one
// cooperative launch. A row's scale needs its whole 9 * C window, written
// by many blocks in the phase before, so each conv is a quantize phase
// (quantize_rows_phase over Im2colRows: every im2col row's scale and int8
// values once, zero padding included, into a (P, Kp) int8 matrix), a grid
// barrier, and a gemm_phase: 64 x 64 s8 mma.sync tiles, K split over exact
// int32 partial sums where the tiles are fewer than the blocks (24 ranges
// at N=1, 4 at N=8: the host's plan, kernels/basic_stage.py::
// basic_stage_int8_plan, picks the split and this entry checks it), added
// after a barrier, then the epilogue once per element, as acc * (s_x *
// s_w) * s + b (+ act), each multiply and add rounded on its own in the
// plain version's order, so the two agree to the bit. The 2B weight
// matrices are written k-contiguous (C, Kp) once a launch, beside block 0's
// first quantize phase (9.4 MB at conv5_x's two blocks, L2-resident).

#include <stdint.h>

#include "common.cuh"
#include "mma_int8.cuh"

namespace {

namespace s8 = wt::s8mma;

constexpr int kBlocksPerSm = 2;
constexpr int kSplitStep = s8::kBK;  // a split but the last is a multiple of this

struct Args {
  const float* x;
  float* out;
  const int8_t* wa;  // (B, 9*C, C) int8
  const float* swa;  // (B, 1, C) weight scales
  const float* sa;   // (B, 1, C) folded BN
  const float* ba;
  const int8_t* wb;
  const float* swb;
  const float* sb;
  const float* bb;
  float* h1;
  float* sx;    // row scales, P
  int8_t* aq;   // quantized im2col rows, (P, Kp)
  int8_t* bta;  // (B, C, Kp) first convs' weights, k-contiguous
  int8_t* btb;  // (B, C, Kp) second convs'
  int* part;
  unsigned int* bar;
  int N, H, W, C, B, Kp, splits, chunk;
};

__global__ void __launch_bounds__(s8::kThreads, kBlocksPerSm) basic_stage_int8_kernel(Args a) {
  __shared__ __align__(16) int8_t smem[s8::kSmemBytes];
  __shared__ float red[s8::kThreads / 32];
  const int c = a.C, k = 9 * c;
  const int P = a.N * a.H * a.W;

  // Every block's two weight matrices k-contiguous, for the whole launch.
  {
    const auto transpose = [&](int m) {  // m = 2 * block + leg
      const size_t in = static_cast<size_t>(m / 2) * k * c;
      const size_t to = static_cast<size_t>(m / 2) * c * a.Kp;
      return m % 2 ? s8::Transpose{a.wb + in, k, c, a.Kp, a.btb + to}
                   : s8::Transpose{a.wa + in, k, c, a.Kp, a.bta + to};
    };
    const long long per = transpose(0).items();
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < per * 2 * a.B; i += static_cast<long long>(gridDim.x) * blockDim.x)
      transpose(static_cast<int>(i / per)).item(i % per);
  }
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bw = static_cast<size_t>(blk) * c * a.Kp, bc = static_cast<size_t>(blk) * c;

    if (blk > 0) wt::grid_sync(a.bar);
    s8::quantize_rows_phase(s8::Im2colRows<true, true>{act, a.H, a.W, c / 4}, P, k, a.Kp, a.aq,
                            a.sx, red);
    wt::grid_sync(a.bar);
    s8::gemm_phase(a.aq, a.bta + bw, a.sx, P, c, a.Kp, a.splits, a.chunk,
                   wt::Int8BnEpilogue{a.swa + bc, a.sa + bc, a.ba + bc, a.h1, c, 1}, a.part,
                   a.bar, smem);
    wt::grid_sync(a.bar);

    s8::quantize_rows_phase(s8::Im2colRows<true, true>{a.h1, a.H, a.W, c / 4}, P, k, a.Kp, a.aq,
                            a.sx, red);
    wt::grid_sync(a.bar);
    s8::gemm_phase(a.aq, a.btb + bw, a.sx, P, c, a.Kp, a.splits, a.chunk,
                   wt::ResidualInt8Epilogue{a.swb + bc, a.sb + bc, a.bb + bc, act, a.out, c},
                   a.part, a.bar, smem);
  }
}

// Blocks of the kernel in the cooperative grid: what the current device
// holds resident, at most kBlocksPerSm an SM; 0 on error.
int resident_blocks() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0)
    cache[dev] = cooperative_grid(reinterpret_cast<const void*>(basic_stage_int8_kernel), 0,
                                  s8::kThreads, kBlocksPerSm);
  return cache[dev];
}

// 4-byte words holding `bytes` bytes, rounded up to the workspace's step.
size_t words_of(size_t bytes) { return workspace_round_up((bytes + 3) / 4); }

struct Plan {
  int Kp;
  size_t h1, sx, aq, bta, btb, part, total;  // workspace offsets and size, in words
};

// The workspace of the host's plan (grid `blocks`, Kp in `splits` ranges of
// `chunk`), after checking it against the kernel's geometry.
int make_plan(int N, int H, int W, int C, int B, int blocks, int splits, int chunk, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || B <= 0 || C % 4 != 0 || blocks <= 0 ||
      splits <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t P = static_cast<size_t>(N) * H * W;
  pl->Kp = (9 * C + s8::kKAlign - 1) / s8::kKAlign * s8::kKAlign;
  if (static_cast<long long>(chunk) * splits < pl->Kp ||
      static_cast<long long>(chunk) * (splits - 1) >= pl->Kp ||
      (splits > 1 && chunk % kSplitStep != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int resident = resident_blocks();
  if (resident <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t wt_bytes = static_cast<size_t>(B) * C * pl->Kp;
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->sx = pl->h1 + workspace_round_up(P * C);
  pl->aq = pl->sx + workspace_round_up(P);
  pl->bta = pl->aq + words_of(P * pl->Kp);
  pl->btb = pl->bta + words_of(wt_bytes);
  pl->part = pl->btb + words_of(wt_bytes);
  pl->total = pl->part + (splits > 1 ? static_cast<size_t>(splits) * P * C : 0);
  return 0;
}

}  // namespace

// 4-byte words of workspace basic_stage_int8 needs for this shape and plan
// on the current device (into *words); returns a CUDA error code.
extern "C" int basic_stage_int8_workspace(int N, int H, int W, int C, int B, int blocks,
                                          int splits, int chunk, long long* words) {
  Plan pl;
  const int err = make_plan(N, H, W, C, B, blocks, splits, chunk, &pl);
  if (err == 0) *words = static_cast<long long>(pl.total);
  return err;
}

// The host's plan (kernels/basic_stage.py::basic_stage_int8_plan): the
// cooperative grid's `blocks` (at most what the device holds resident) and
// the K split of both convs, Kp = 9 * C padded to a multiple of s8::kKAlign
// in `splits` ranges of `chunk`. C a multiple of 4 (the wrapper pads other
// counts with zero channels); x and out 16-byte aligned.
extern "C" int basic_stage_int8(const float* x, const int8_t* wa, const float* swa,
                                const float* sa, const float* ba, const int8_t* wb,
                                const float* swb, const float* sb, const float* bb, float* out,
                                float* ws, long long ws_words, int N, int H, int W, int C, int B,
                                int blocks, int splits, int chunk, void* stream) {
  Plan pl;
  const int err = make_plan(N, H, W, C, B, blocks, splits, chunk, &pl);
  if (err != 0) return err;
  if (ws_words < static_cast<long long>(pl.total) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{x, out, wa, swa, sa, ba, wb, swb, sb, bb, ws + pl.h1, ws + pl.sx,
         reinterpret_cast<int8_t*>(ws + pl.aq), reinterpret_cast<int8_t*>(ws + pl.bta),
         reinterpret_cast<int8_t*>(ws + pl.btb), reinterpret_cast<int*>(ws + pl.part), bar,
         N, H, W, C, B, pl.Kp, splits, chunk};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(basic_stage_int8_kernel),
                                  dim3(blocks), dim3(s8::kThreads), args, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
