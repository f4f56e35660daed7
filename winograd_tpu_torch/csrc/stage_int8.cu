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
// Cmid / groups channels (the host passes groups = Cmid / 128 where Cmid is
// a multiple of 128, else 1) and adds the groups' dequantized products in
// f32, group by group, as the JAX kernel does.
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
// Design: one persistent cooperative launch (csrc/stage.cu's shape), whose
// int8 GEMM phases run on mma_int8.cuh as csrc/direct_int8.cu does. A row's
// scale needs the max over the whole row before any of it can be
// quantized, and that row is produced by many blocks in the phase before;
// so each GEMM is preceded by a quantize phase and a grid barrier:
// * quantize_rows_phase computes each row's scale and int8 values once (the
//   activation's rows for the reduce, each im2col row of h1 over its
//   9*Cmid window, zero padding included, for the direct mid, h2's rows, or
//   h2's rows per group, for the expand) into an int8 workspace matrix.
// * gemm_phase multiplies it by the k-contiguous int8 weights with
//   mma.sync s8 x s8 -> s32 on 64 x 64 tiles, K split over exact int32
//   partial sums where a phase has fewer tiles than the grid has blocks;
//   after a grid barrier all blocks add them and run the f32 epilogue once
//   per element (faster on the card than adding a tile's splits in the
//   last of its blocks to arrive, which saves the barrier but leaves the
//   sum to a few blocks).
// * The weights of every block (reduce, direct mid, expand) are transposed
//   to k-contiguous in one phase at the start of the launch, beside block
//   0's first quantize phase (5.6 MB of int8 at conv4_x's five blocks).
// * In the winograd2 route the expand quantizes h2 per row and per group
//   of 128 channels; each group is its own k range with its own int32
//   accumulators, dequantized and added in f32 in group order.
// Every f32 epilogue rounds its multiply and its add separately
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
// product of this. The two mids are two instantiations of the kernel, so
// the direct one does not carry the FP64 mid's registers: it runs two
// blocks an SM, the winograd2 one one.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_int8.cuh"
#include "winograd.cuh"

namespace {

namespace s8 = wt::s8mma;

constexpr int kWinoTiles = 16;  // Winograd tiles per item (256 threads)
constexpr int kWinoCPT = 2;     // output channels per thread (FP64 accumulators)
constexpr int kWinoCOB = wt::kWinoTX * kWinoCPT;
constexpr size_t kWinoBytes = wt::wino_smem_bytes<2, kWinoTiles, double, kWinoCPT>();
constexpr int kMaxBlocksPerSm = 2;

template <bool kWino>
constexpr size_t smem_bytes() {
  return kWino && kWinoBytes > static_cast<size_t>(s8::kSmemBytes) ? kWinoBytes
                                                                    : s8::kSmemBytes;
}
static_assert(smem_bytes<true>() <= 48 * 1024 && smem_bytes<false>() <= 48 * 1024,
              "the launch sets no dynamic shared memory attribute");

struct StageInt8Args {
  const float* x;
  float* out;
  const int8_t* wr;          // (B, Cio, Cmid)
  const float* swr;
  const float* s1;
  const float* b1;
  const int8_t* w9;          // (B, 9*Cmid, Cmid) int8, direct mid
  const __nv_bfloat16* u2;   // (B, 16, Cmid, Cmid) bf16, winograd2 mid
  const float* sw9;
  const float* s2;
  const float* b2;
  const int8_t* we;          // (B, Cmid, Cio)
  const float* swe;
  const float* s3;
  const float* b3;
  float* h1;
  float* h2;
  float* sx;     // row scales, P * groups
  int8_t* aq;    // quantized rows, (P, Kp) for the phase's Kp
  int8_t* btr;   // (B, Cmid, kpr) reduce weights, k-contiguous
  int8_t* btm;   // (B, Cmid, kpm) direct mid weights
  int8_t* bte;   // (B, Cio, kpe) expand weights
  int* part;
  unsigned int* bar;
  int N, H, W, Cio, Cmid, B, groups, kpr, kpm, kpe;
  wt::GemmPhase reduce, mid, expand;
};

// The expand GEMM with h2 quantized per group of Cmid / groups channels
// (aq (P, Cmid), scales sx[p * groups + g]): each tile adds the groups'
// dequantized products in f32, in group order (no K split: this route runs
// only where Cmid is a multiple of 128 above 128).
__device__ void grouped_expand(const StageInt8Args& a, const int8_t* bt,
                               const wt::ResidualInt8Epilogue& epi, int8_t* smem) {
  const int P = a.N * a.H * a.W;
  const int cg = a.Cmid / a.groups;
  const int tiles_n = (a.Cio + s8::kBN - 1) / s8::kBN;
  const int tiles = (P + s8::kBM - 1) / s8::kBM * tiles_n;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = t / tiles_n * s8::kBM, n0 = t % tiles_n * s8::kBN;
    float f[2][2][4];
    for (int g = 0; g < a.groups; ++g) {
      s8::Acc acc;
      s8::tile(a.aq, bt, P, a.Cio, a.Cmid, p0, n0, g * cg, (g + 1) * cg, smem, acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = min(p0 + s8::acc_row(mi, e), P - 1);
            const int n = min(n0 + s8::acc_col(ni, e), a.Cio - 1);
            const float d = wt::dequant(acc[mi][ni][e],
                                        __ldcg(a.sx + static_cast<size_t>(p) * a.groups + g),
                                        epi.sw[n]);
            f[mi][ni][e] = g == 0 ? d : __fadd_rn(f[mi][ni][e], d);
          }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + s8::acc_row(mi, e), n = n0 + s8::acc_col(ni, e);
          if (p < P && n < a.Cio) epi.store(p, n, f[mi][ni][e]);
        }
  }
}

// h2 = relu(F(2,3)(h1, u2) * s2 + b2) over the whole map, one block's mid
// of the winograd2 route. Not inlined: compiled apart from the tensor-core
// phases, the FP64 tile keeps the schedule it had in the dp4a kernel
// (inlined, it ran 40% slower; tools/chip_stage_timeline.py, PERF.md).
__device__ __noinline__ void winograd2_mid(const float* h1, const __nv_bfloat16* u2,
                                           const float* s2, const float* b2, float* h2, int N,
                                           int H, int W, int cmid, float* smem) {
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const int cgroups = (cmid + kWinoCOB - 1) / kWinoCOB;
  const int items = ((N * th * tw + kWinoTiles - 1) / kWinoTiles) * cgroups;
  for (int item = blockIdx.x; item < items; item += gridDim.x)
    wt::wino_tile<2, kWinoTiles, wt::CgLoad, __nv_bfloat16, double, kWinoCPT>(
        wt::CgLoad{}, h1, u2, s2, b2, h2, N, H, W, cmid, cmid, 1,
        (item / cgroups) * kWinoTiles, (item % cgroups) * kWinoCOB, threadIdx.x, smem);
}

template <bool kWino>
__global__ void __launch_bounds__(s8::kThreads, kWino ? 1 : kMaxBlocksPerSm)
    stage_int8_kernel(StageInt8Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[s8::kThreads / 32];
  int8_t* smem8 = reinterpret_cast<int8_t*>(smem);
  const int cio = a.Cio, cmid = a.Cmid;
  const int P = a.N * a.H * a.W;
  const int cg = cmid / a.groups;

  // Every block's weights k-contiguous, for the whole launch: the items of
  // all 2B (winograd2) or 3B transposes dealt to the grid in one walk.
  {
    const auto transpose = [&](int blk, int m) {
      const size_t bm = static_cast<size_t>(blk) * cmid, bo = static_cast<size_t>(blk) * cio;
      if (m == 0) return s8::Transpose{a.wr + bm * cio, cio, cmid, a.kpr, a.btr + bm * a.kpr};
      if (m == 1) return s8::Transpose{a.we + bm * cio, cmid, cio, a.kpe, a.bte + bo * a.kpe};
      return s8::Transpose{a.w9 + bm * 9 * cmid, 9 * cmid, cmid, a.kpm, a.btm + bm * a.kpm};
    };
    const long long n0 = transpose(0, 0).items(), n1 = transpose(0, 1).items();
    const long long per_blk = n0 + n1 + (kWino ? 0 : transpose(0, 2).items());
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < per_blk * a.B; i += static_cast<long long>(gridDim.x) * blockDim.x) {
      const int blk = static_cast<int>(i / per_blk);
      const long long r = i - blk * per_blk;
      if (r < n0)
        transpose(blk, 0).item(r);
      else if (r < n0 + n1)
        transpose(blk, 1).item(r - n0);
      else
        transpose(blk, 2).item(r - n0 - n1);
    }
  }
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bm = static_cast<size_t>(blk) * cmid;
    const size_t bo = static_cast<size_t>(blk) * cio;

    if (blk > 0) wt::grid_sync(a.bar);
    s8::quantize_rows_phase(s8::RowsCg4{act, cio}, P, cio, a.kpr, a.aq, a.sx, red);
    wt::grid_sync(a.bar);
    s8::gemm_phase(a.aq, a.btr + bm * a.kpr, a.sx, P, cmid, a.kpr, a.reduce.splits,
                   a.reduce.chunk,
                   wt::Int8BnEpilogue{a.swr + bm, a.s1 + bm, a.b1 + bm, a.h1, cmid, 1}, a.part,
                   a.bar, smem8);
    wt::grid_sync(a.bar);

    if constexpr (kWino) {
      winograd2_mid(a.h1, a.u2 + bm * 16 * cmid, a.s2 + bm, a.b2 + bm, a.h2, a.N, a.H, a.W, cmid,
                    smem);
    } else {
      s8::quantize_rows_phase(s8::Im2colRows<true, true>{a.h1, a.H, a.W, cmid / 4}, P,
                              9 * cmid, a.kpm, a.aq, a.sx, red);
      wt::grid_sync(a.bar);
      s8::gemm_phase(a.aq, a.btm + bm * a.kpm, a.sx, P, cmid, a.kpm, a.mid.splits,
                     a.mid.chunk,
                     wt::Int8BnEpilogue{a.sw9 + bm, a.s2 + bm, a.b2 + bm, a.h2, cmid, 1},
                     a.part, a.bar, smem8);
    }
    wt::grid_sync(a.bar);

    // h2 as (P * groups, cg) rows: one group's channels a row.
    s8::quantize_rows_phase(s8::RowsCg4{a.h2, cg}, P * a.groups, cg,
                            a.groups == 1 ? a.kpe : cg, a.aq, a.sx, red);
    wt::grid_sync(a.bar);
    const int8_t* bt = a.bte + bo * a.kpe;
    const wt::ResidualInt8Epilogue epi{a.swe + bo, a.s3 + bo, a.b3 + bo, act, a.out, cio};
    if (a.groups == 1)
      s8::gemm_phase(a.aq, bt, a.sx, P, cio, a.kpe, a.expand.splits, a.expand.chunk, epi,
                     a.part, a.bar, smem8);
    else
      grouped_expand(a, bt, epi, smem8);
  }
}

template <bool kWino>
const void* kernel_of() {
  return reinterpret_cast<const void*>(stage_int8_kernel<kWino>);
}

// Blocks of the route's kernel in the cooperative grid: what the current
// device holds resident, at most kMaxBlocksPerSm an SM; 0 on error.
int grid_size(int wino) {
  static int cache[64][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev][wino] == 0) {
    int sms = 0, per_sm = 0;
    const void* kernel = wino ? kernel_of<true>() : kernel_of<false>();
    const size_t smem = wino ? smem_bytes<true>() : smem_bytes<false>();
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, s8::kThreads, smem) !=
            cudaSuccess)
      return 0;
    cache[dev][wino] = (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm) * sms;
  }
  return cache[dev][wino];
}

size_t round_k(int k) { return (k + s8::kKAlign - 1) / s8::kKAlign * s8::kKAlign; }

// The K split of a GEMM phase: one with fewer output tiles than the grid
// has blocks splits K so that about one item lands on each block.
wt::GemmPhase plan_phase(int P, int K, int N, int grid) {
  const int tiles = ((P + s8::kBM - 1) / s8::kBM) * ((N + s8::kBN - 1) / s8::kBN);
  return split_k(P, K, N, grid / tiles, s8::kBK);
}

// 4-byte words holding `bytes` bytes, rounded up to the workspace's step.
size_t words_of(size_t bytes) { return workspace_round_up((bytes + 3) / 4); }

struct Plan {
  int grid, kpr, kpm, kpe;
  wt::GemmPhase reduce, mid, expand;
  size_t h1, h2, sx, aq, btr, btm, bte, part, total;  // workspace offsets and size, in words
};

int make_plan(int N, int H, int W, int Cio, int Cmid, int B, int wino, int groups, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || Cio <= 0 || Cmid <= 0 || B <= 0 || Cio % 4 != 0 ||
      Cmid % 4 != 0 || groups <= 0 || Cmid % groups != 0 ||
      (groups > 1 && (!wino || (Cmid / groups) % s8::kKAlign != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  pl->grid = grid_size(wino);
  if (pl->grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t P = static_cast<size_t>(N) * H * W;
  pl->kpr = static_cast<int>(round_k(Cio));
  pl->kpm = wino ? 0 : static_cast<int>(round_k(9 * Cmid));
  pl->kpe = static_cast<int>(round_k(Cmid));
  pl->reduce = plan_phase(static_cast<int>(P), pl->kpr, Cmid, pl->grid);
  pl->mid = plan_phase(static_cast<int>(P), wino ? 1 : pl->kpm, Cmid, wino ? 0 : pl->grid);
  pl->expand = plan_phase(static_cast<int>(P), pl->kpe, Cio, groups > 1 ? 0 : pl->grid);
  size_t part = phase_partial_floats(pl->reduce);
  if (phase_partial_floats(pl->mid) > part) part = phase_partial_floats(pl->mid);
  if (phase_partial_floats(pl->expand) > part) part = phase_partial_floats(pl->expand);
  size_t kp = pl->kpr > pl->kpe ? pl->kpr : pl->kpe;
  if (static_cast<size_t>(pl->kpm) > kp) kp = pl->kpm;
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->h2 = pl->h1 + workspace_round_up(P * Cmid);
  pl->sx = pl->h2 + workspace_round_up(P * Cmid);
  pl->aq = pl->sx + workspace_round_up(P * groups);
  pl->btr = pl->aq + words_of(P * kp);
  pl->btm = pl->btr + words_of(static_cast<size_t>(B) * Cmid * pl->kpr);
  pl->bte = pl->btm + words_of(static_cast<size_t>(B) * Cmid * pl->kpm);
  pl->part = pl->bte + words_of(static_cast<size_t>(B) * Cio * pl->kpe);
  pl->total = pl->part + part;
  return 0;
}

}  // namespace

// 4-byte words of workspace resnet_stage_int8 needs for this shape on the
// current device (into *words); returns a CUDA error code.
extern "C" int resnet_stage_int8_workspace(int N, int H, int W, int Cio, int Cmid, int B,
                                           int wino, int groups, long long* words) {
  Plan pl;
  const int err = make_plan(N, H, W, Cio, Cmid, B, wino, groups, &pl);
  if (err == 0) *words = static_cast<long long>(pl.total);
  return err;
}

// wm is the int8 w9_mid stack (wino = 0) or the bf16 u2_mid stack (wino = 1);
// sw9 is read only by the direct mid. Cio and Cmid multiples of 4 (the
// wrapper pads other counts with zero channels); groups: the expand's
// quantization groups, 1 or (winograd2 only) Cmid / 128; x and out 16-byte
// aligned.
extern "C" int resnet_stage_int8(const float* x, const int8_t* wr, const float* swr,
                                 const float* s1, const float* b1, const void* wm,
                                 const float* sw9, const float* s2, const float* b2,
                                 const int8_t* we, const float* swe, const float* s3,
                                 const float* b3, float* out, float* ws,
                                 long long ws_words, int N, int H, int W, int Cio,
                                 int Cmid, int B, int wino, int groups, void* stream) {
  Plan pl;
  const int err = make_plan(N, H, W, Cio, Cmid, B, wino, groups, &pl);
  if (err != 0) return err;
  if (ws_words < static_cast<long long>(pl.total) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
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
                  reinterpret_cast<int8_t*>(ws + pl.aq),
                  reinterpret_cast<int8_t*>(ws + pl.btr),
                  reinterpret_cast<int8_t*>(ws + pl.btm),
                  reinterpret_cast<int8_t*>(ws + pl.bte),
                  reinterpret_cast<int*>(ws + pl.part),
                  bar,
                  N, H, W, Cio, Cmid, B, groups, pl.kpr, pl.kpm, pl.kpe,
                  pl.reduce, pl.mid, pl.expand};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(wino ? kernel_of<true>() : kernel_of<false>(), dim3(pl.grid),
                                  dim3(s8::kThreads), args,
                                  wino ? smem_bytes<true>() : smem_bytes<false>(), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
