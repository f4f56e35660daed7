// B int8 identity bottleneck blocks over all N images in one persistent
// launch: per block b, with qdot(A, W) the int8 product of gemm_int8.cuh
// (per-row dynamic activation scale, int8 weights with per-column scales,
// exact int32 sum, dequantized in f32),
//   h1  = relu(qdot(act, w_reduce[b]) * s1 + b1)
//   h2  = relu(qdot(im2col(h1), w9_mid[b]) * s2 + b2)        ("direct"), or
//         relu(F(2,3)(h1, u2_mid_bf16[b]) * s2 + b2)         ("winograd2")
//   out = relu(qdot(h2, w_expand[b]) * s3 + b3 + act)
// with act = x for block 0 and out afterwards (updated in place: each
// residual element is read only by the thread that overwrites it). In the
// winograd2 route the expand quantizes h2 per row and per group of
// cg = (Cmid % 128 == 0 ? 128 : Cmid) channels and adds the groups'
// dequantized products in f32, group by group, as the JAX kernel does.
//
// Replaces: winograd_tpu/kernels/quantized.py::_stage_int8_kernel and
// ::_stage_int8_kernel_resident (resnet_stage_int8_pallas), and
// ::_block_int8_kernel (bottleneck_block_int8_pallas), which is this kernel
// at B = 1 with the direct mid. As in csrc/stage.cu, every phase already
// runs over all N*H*W rows and reads each block's weights once per launch,
// which is what the TPU's resident layout buys, so one kernel covers all
// three. On the int8 ResNet-50 path it runs conv2_x (56x56, 256/64, 2
// blocks) and conv3_x (28x28, 512/128, 3 blocks) with the F(2,3) mid on
// bf16 filters, conv4_x (14x14, 1024/256, 5 blocks) and conv5_x (7x7,
// 2048/512, 2 blocks) with the int8 direct mid.
//
// Bound on the H100: the int8 products at 1979 TOPS and the bf16-filter
// F(2,3) products at 989 TFLOP/s take microseconds; x, out (f32) and the
// weights (int8, 1 byte each; the F(2,3) filters bf16) read once take
// 2-3 us per stage at N=1: every stage is bound by bytes.
//
// Design: the persistent cooperative kernel of csrc/stage.cu. A row's scale
// needs the max over the whole row before a GEMM can quantize it, and that
// row is produced by many blocks in the previous phase; so every int8 GEMM
// phase is preceded by a scale sub-phase (one warp per row, over the whole
// row; im2col rows over their 9*Cmid window, zero padding included) that
// writes the scales to the workspace, and one more grid barrier. The GEMM
// phases run the int8 tile of gemm_int8.cuh (__dp4a, int32) with split-K
// over int32 partial sums where a phase has fewer tiles than the grid has
// blocks; the sum is exact, so the f32 epilogue runs once per element after
// it. Every f32 epilogue rounds its multiply and its add separately
// (__fmul_rn, __fadd_rn), in the plain version's order. The F(2,3) mid is
// winograd.cuh's tile body on the bf16 filter (widened as it is staged)
// with FP64 transforms, products and sums, each output rounded to float
// once. Both choices make the kernel agree with its plain version to the
// bit: in a chain of int8 layers a last-bit difference moves a value across
// a rounding boundary of the next quantization now and then, a whole
// quantization step, and that grows through the blocks (with FMA-contracted
// epilogues and an FP32 mid, a five-block stage at 14x14x1024 differed
// from its plain version by 1% of its largest output). The JAX kernel
// multiplies V's bf16 hi and lo halves with f32 sums: within 2^-17 of a
// product of this.

#include <cuda_bf16.h>

#include "common.cuh"
#include "gemm_int8.cuh"
#include "grid_sync.cuh"
#include "winograd.cuh"

namespace {

constexpr int kWinoTiles = 16;  // Winograd tiles per item (256 threads)
constexpr int kWinoCPT = 2;     // output channels per thread (FP64 accumulators)
constexpr int kWinoCOB = wt::kWinoTX * kWinoCPT;
constexpr size_t kWinoBytes = wt::wino_smem_bytes<2, kWinoTiles, double, kWinoCPT>();
constexpr size_t kSmemBytes =
    kWinoBytes > static_cast<size_t>(wt::kInt8SmemBytes) ? kWinoBytes : wt::kInt8SmemBytes;

struct StageInt8Args {
  const float* x;
  float* out;
  const int8_t* wr;
  const float* swr;
  const float* s1;
  const float* b1;
  const int8_t* w9;          // (B, 9*Cmid, Cmid) int8, direct mid
  const __nv_bfloat16* u2;   // (B, 16, Cmid, Cmid) bf16, winograd2 mid
  const float* sw9;
  const float* s2;
  const float* b2;
  const int8_t* we;
  const float* swe;
  const float* s3;
  const float* b3;
  float* h1;
  float* h2;
  float* sx;  // row scales, P * groups
  int* part;
  unsigned int* bar;
  int N, H, W, Cio, Cmid, B, wino, groups;
  wt::GemmPhase reduce, mid, expand;
};

// The expand GEMM with h2 quantized per group of K / groups channels: each
// tile adds the groups' dequantized products in f32, in group order (no K
// split: this route runs only where Cmid is a multiple of 128 above 128).
__device__ void grouped_expand(const StageInt8Args& a, const int8_t* we,
                               const wt::ResidualInt8Epilogue& epi, int* smem) {
  float* sxs = reinterpret_cast<float*>(smem + 2 * wt::kW8 * wt::kBM);
  const int P = a.N * a.H * a.W;
  const int cg = a.Cmid / a.groups;
  const int tiles_n = (a.Cio + wt::kBN - 1) / wt::kBN;
  const int tiles = ((P + wt::kBM - 1) / wt::kBM) * tiles_n;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = (t / tiles_n) * wt::kBM;
    const int n0 = (t % tiles_n) * wt::kBN;
    float f[4][4] = {};
    for (int g = 0; g < a.groups; ++g) {
      wt::load_tile_scales(a.sx + g, a.groups, P, p0, sxs);
      int acc[4][4];
      wt::int8_tile(wt::RowsCg{a.h2, a.Cmid}, we, sxs, P, a.Cio, p0, n0, g * cg,
                    (g + 1) * cg, smem, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = min(n0 + tx * 4 + j, a.Cio - 1);
          f[i][j] = __fadd_rn(f[i][j], wt::dequant(acc[i][j], sxs[ty * 4 + i], epi.sw[n]));
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < a.Cio) epi.store(p, n, f[i][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(wt::kGemmThreads) stage_int8_kernel(StageInt8Args a) {
  extern __shared__ __align__(16) float smem[];
  int* ismem = reinterpret_cast<int*>(smem);
  const int cio = a.Cio, cmid = a.Cmid;
  const int P = a.N * a.H * a.W;
  const int th = (a.H + 1) / 2, tw = (a.W + 1) / 2;
  const int cgroups = (cmid + kWinoCOB - 1) / kWinoCOB;
  const int wino_items = ((a.N * th * tw + kWinoTiles - 1) / kWinoTiles) * cgroups;
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bm = static_cast<size_t>(blk) * cmid;
    const size_t bo = static_cast<size_t>(blk) * cio;

    wt::row_scales_phase(wt::RowsCg{act, cio}, P, cio, 1, a.sx);
    wt::grid_sync(a.bar);
    wt::int8_gemm_phase(a.reduce, wt::RowsCg{act, cio}, a.wr + bm * cio, a.sx,
                        wt::Int8BnEpilogue{a.swr + bm, a.s1 + bm, a.b1 + bm, a.h1, cmid, 1},
                        a.part, a.bar, ismem);
    wt::grid_sync(a.bar);

    if (a.wino) {
      const __nv_bfloat16* u2 = a.u2 + bm * 16 * cmid;
      for (int item = blockIdx.x; item < wino_items; item += gridDim.x) {
        wt::wino_tile<2, kWinoTiles, wt::CgLoad, __nv_bfloat16, double, kWinoCPT>(
            wt::CgLoad{}, a.h1, u2, a.s2 + bm, a.b2 + bm, a.h2, a.N, a.H, a.W, cmid, cmid,
            1, (item / cgroups) * kWinoTiles, (item % cgroups) * kWinoCOB, threadIdx.x, smem);
      }
    } else {
      const wt::Im2colCg col{a.h1, a.H, a.W, cmid};
      wt::row_scales_phase(col, P, 9 * cmid, 1, a.sx);
      wt::grid_sync(a.bar);
      wt::int8_gemm_phase(a.mid, col, a.w9 + bm * 9 * cmid, a.sx,
                          wt::Int8BnEpilogue{a.sw9 + bm, a.s2 + bm, a.b2 + bm, a.h2, cmid, 1},
                          a.part, a.bar, ismem);
    }
    wt::grid_sync(a.bar);

    wt::row_scales_phase(wt::RowsCg{a.h2, cmid}, P, cmid / a.groups, a.groups, a.sx);
    wt::grid_sync(a.bar);
    const int8_t* we = a.we + bm * cio;
    const wt::ResidualInt8Epilogue epi{a.swe + bo, a.s3 + bo, a.b3 + bo, act, a.out, cio};
    if (a.groups == 1)
      wt::int8_gemm_phase(a.expand, wt::RowsCg{a.h2, cmid}, we, a.sx, epi, a.part, a.bar,
                          ismem);
    else
      grouped_expand(a, we, epi, ismem);
    if (blk + 1 < a.B) wt::grid_sync(a.bar);
  }
}

int grid_size() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0)
    cache[dev] = cooperative_grid(reinterpret_cast<const void*>(stage_int8_kernel), kSmemBytes);
  return cache[dev];
}

struct Plan {
  int grid, groups;
  wt::GemmPhase reduce, mid, expand;
  size_t h1, h2, sx, part, total;  // workspace offsets and size, in 4-byte words
};

int make_plan(int N, int H, int W, int Cio, int Cmid, int wino, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || Cio <= 0 || Cmid <= 0 || Cio % 4 != 0 || Cmid % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pl->grid = grid_size();
  if (pl->grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int P = N * H * W;
  pl->groups = wino && Cmid % 128 == 0 ? Cmid / 128 : 1;
  pl->reduce = plan_phase(P, Cio, Cmid, pl->grid, wt::kBK8);
  pl->mid = plan_phase(P, 9 * Cmid, Cmid, wino ? 0 : pl->grid, wt::kBK8);
  pl->expand = plan_phase(P, Cmid, Cio, pl->groups > 1 ? 0 : pl->grid, wt::kBK8);
  size_t part = phase_partial_floats(pl->reduce);
  if (phase_partial_floats(pl->mid) > part) part = phase_partial_floats(pl->mid);
  if (phase_partial_floats(pl->expand) > part) part = phase_partial_floats(pl->expand);
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->h2 = pl->h1 + workspace_round_up(static_cast<size_t>(P) * Cmid);
  pl->sx = pl->h2 + workspace_round_up(static_cast<size_t>(P) * Cmid);
  pl->part = pl->sx + workspace_round_up(static_cast<size_t>(P) * pl->groups);
  pl->total = pl->part + part;
  return 0;
}

}  // namespace

// 4-byte words of workspace resnet_stage_int8 needs for this shape on the
// current device (into *words); returns a CUDA error code.
extern "C" int resnet_stage_int8_workspace(int N, int H, int W, int Cio, int Cmid,
                                           int wino, long long* words) {
  Plan pl;
  const int err = make_plan(N, H, W, Cio, Cmid, wino, &pl);
  if (err == 0) *words = static_cast<long long>(pl.total);
  return err;
}

// wm is the int8 w9_mid stack (wino = 0) or the bf16 u2_mid stack (wino = 1);
// sw9 is read only by the direct mid.
extern "C" int resnet_stage_int8(const float* x, const int8_t* wr, const float* swr,
                                 const float* s1, const float* b1, const void* wm,
                                 const float* sw9, const float* s2, const float* b2,
                                 const int8_t* we, const float* swe, const float* s3,
                                 const float* b3, float* out, float* ws,
                                 long long ws_words, int N, int H, int W, int Cio,
                                 int Cmid, int B, int wino, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = make_plan(N, H, W, Cio, Cmid, wino, &pl);
  if (err != 0) return err;
  if (ws_words < static_cast<long long>(pl.total))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  StageInt8Args a{x,
                  out,
                  wr,
                  swr,
                  s1,
                  b1,
                  wino ? nullptr : static_cast<const int8_t*>(wm),
                  wino ? static_cast<const __nv_bfloat16*>(wm) : nullptr,
                  sw9,
                  s2,
                  b2,
                  we,
                  swe,
                  s3,
                  b3,
                  ws + pl.h1,
                  ws + pl.h2,
                  ws + pl.sx,
                  reinterpret_cast<int*>(ws + pl.part),
                  bar,
                  N, H, W, Cio, Cmid, B, wino, pl.groups,
                  pl.reduce, pl.mid, pl.expand};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(stage_int8_kernel),
                                  dim3(pl.grid), dim3(wt::kGemmThreads), args, kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
