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
// 2-3 us per stage at N=1: every stage is bound by bytes. At N=1 what the
// launch costs is its phases (15-19 us each at conv4_x, a grid barrier
// 2 us; PERF.md).
//
// Design: one persistent cooperative launch (csrc/stage.cu's shape), whose
// GEMM phases run on wgmma_s8.cuh's tile: two warpgroups a block, each on
// 64 x 64 tiles of its own, s8 wgmma m64n64k32, the int8 weights by TMA onto
// mbarriers
// (k-contiguous copies made in the launch's first phase), the quantized
// activation rows by cp.async. A row's scale needs the max over the whole
// row, which many blocks produce; so every producing epilogue publishes its
// rows' max |v| (one atomicMax of the bits a row and tile, wgmma_s8.cuh::
// publish_row_max), and the consuming phase quantizes its rows itself
// (the phases' machinery is csrc/wgmma_s8_phase.cuh, shared with
// csrc/transition_int8.cu):
// * the reduce writes h1 and h1's row maxima (mx1), the mid writes h2 and
//   mx2 (per row, or per row and group of 128 channels for the winograd2
//   route's grouped expand: the FP64 F(2,3)'s observer, winograd.cuh), and
//   the expand writes out, the next block's act, and its row maxima
//   (mx_act, two buffers, block by block);
// * the direct mid's im2col row max is the max of its nine pixels' row
//   maxima (zero where a tap leaves the map, as the padding gives);
// * block 0's x has no producer in the launch: its row maxima are one warp
//   a row in the first phase, beside the weight transposes;
// * each buffer is zeroed in a phase that neither reads nor writes it (mx1
//   in the first phase and in each expand, mx2 and the next act's in each
//   reduce), never in a phase of its own.
// Within a GEMM phase each block first quantizes its share of the rows
// (P / grid rows, every one over all of K, its scales from the published
// maxima) into the int8 matrix aq and arrives on the counter of each
// 64-row block its share touches; then each of its work items (split,
// tile) waits only for its own row block's counter and stages aq. So every
// value is quantized once, all blocks quantize at once, and no grid
// barrier stands between the quantization and the product (every block is
// resident: a cooperative grid). Two first forms were slower on an H100:
// quantizing A in each tile as it is staged re-quantized it for every 64
// columns of output (1.1-3.2x the mma.sync parent's time), and quantizing
// a row block's share in each of its items put the quantization's latency
// in every item (tools/chip_stage_timeline.py, PERF.md). The quantization
// divides only where it can change the result (quantize4_fast).
// A phase whose tiles are few splits K over items (kernels/quantized.py::
// stage_int8_plan, checked here against the geometry); its exact int32
// partial sums are added after a grid barrier,
// where the epilogue runs once per element and a warp of one row publishes
// one maximum. Grid barriers a block: 6 (direct) and 5 (winograd2) before,
// each quantize phase with its own; 3 now (reduce, mid, expand), plus one
// for each phase that splits K, in both.
// * The weights of every block are transposed to k-contiguous in the first
//   phase (5.6 MB of int8 at conv4_x's five blocks): s8 wgmma reads both
//   operands K-major. That phase was the quantize phase of x before; the
//   transposes keep it at 5-15 us (the timeline), so they stay there.
// * In the winograd2 route the expand quantizes h2 per row and per group
//   of 128 channels; a group is one stage of the tile, its int32 products
//   dequantized and added in f32 in group order.
// Every f32 epilogue rounds its multiply and its add separately
// (__fmul_rn, __fadd_rn), in the plain version's order. The F(2,3) mid is
// winograd.cuh's FP64 tile on the bf16 filter (widened as it is loaded)
// with FP64 transforms, products and sums, each output rounded to float
// once. Both choices make the kernel agree with its plain version to the
// bit: in a chain of int8 layers a last-bit difference moves a value across
// a rounding boundary of the next quantization now and then, a whole
// quantization step, and that grows through the blocks (with FMA-contracted
// epilogues and an FP32 mid, a five-block stage at 14x14x1024 differed
// from its plain version by 1% of its largest output). The JAX kernel
// multiplies V's bf16 hi and lo halves with f32 sums: within 2^-17 of a
// product of this. The mids are instantiations of the kernel, the direct
// one and one for each Cout block of the FP64 mid's items, so none carries
// another's registers; each runs one block of two warpgroups an SM. The
// F(2,3) mid's products run on the FP64 tensor cores
// (winograd.cuh::wino_f64_tile: items of 16 tiles x the plan's Cout block,
// 8, 16 or 32 channels, dealt over the grid, the block's eight warps two
// tile positions each; the plan narrows the block only where the items
// fall short of half the grid: kernels/winograd.py::winograd_fp64_plan,
// passed as the mid's phase).
#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_int8.cuh"
#include "wgmma_s8.cuh"
#include "wgmma_s8_phase.cuh"
#include "winograd.cuh"

namespace {

namespace q8 = wt::wgs8;
namespace s8 = wt::s8mma;
using namespace wt::s8phase;

constexpr size_t kWinoBytes = wt::F64Smem<32>::kBytes;  // the widest FP64 item's
// Blocks an SM: one, on both routes (the winograd2 route's FP64 mid wants
// more than half an SM's registers, and two blocks an SM spilled the
// direct route's first form).
constexpr int kMaxBlocksPerSm = 1;
constexpr int kSplitCap = 16;
constexpr int kKAlign = 32;         // K of aq and of the k-contiguous weights is padded to this
static_assert(q8::kThreads == wt::kF64Threads, "one block runs both tiles");
static_assert(q8::kBK % 32 == 0, "an F(2,3) item's channels lie in one group of the expand");

constexpr size_t kSmem = kWinoBytes > q8::kSmemBytes ? kWinoBytes : q8::kSmemBytes;

struct StageInt8Args {
  CUtensorMap map_r, map_m, map_e;  // the k-contiguous weights btr, btm, bte
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
  float* sx;          // a phase's row scales, P
  unsigned* mx_act;   // act's row maxima, 2 x P (block b reads half b % 2)
  unsigned* mx1;      // h1's, P
  unsigned* mx2;      // h2's, P x groups
  unsigned* cnt;      // the row blocks' counters: 3 phases x B blocks x row_blocks
  int8_t* aq;         // a phase's quantized rows, (P, its Kp)
  int8_t* btr;        // (B, Cmid, kpr) reduce weights, k-contiguous
  int8_t* btm;        // (B, Cmid, kpm) direct mid weights
  int8_t* bte;        // (B, Cio, kpe) expand weights
  int* part;
  unsigned int* bar;
  int N, H, W, Cio, Cmid, B, groups, kpr, kpm, kpe, row_blocks;
  wt::GemmPhase reduce, mid, expand;
};

// ---- the winograd2 route -----------------------------------------------------

// h2's row maxima from the FP64 F(2,3) mid: one per pixel and group of cg
// channels (an item's channels lie in one group).
struct MidRowMax {
  static constexpr bool kOn = true;
  unsigned* mx;
  int groups, cg;
  __device__ __forceinline__ void operator()(int pixel, int co0, unsigned m) const {
    if (m != 0u) atomicMax(mx + static_cast<size_t>(pixel) * groups + co0 / cg, m);
  }
};

// The expand with h2 quantized per group of 128 channels (scales from
// mx2[p * groups + g]): each tile adds the groups' dequantized products in
// f32, in group order, then runs the residual epilogue once (no K split:
// this route runs only where Cmid is a multiple of 128 above 128).
__device__ void grouped_expand(const StageInt8Args& a, const q8::Weights& w, const ResEpi& epi,
                               unsigned* mx, unsigned* cnt, q8::Ring& ring, float* scratch) {
  const int P = a.N * a.H * a.W;
  const int tiles_n = (a.Cio + q8::kBN - 1) / q8::kBN;
  const int rbs = (P + q8::kBM - 1) / q8::kBM;
  const RowsSrc src{a.h2, a.Cmid, a.Cmid, a.mx2, a.groups};
  const wt::GemmPhase g{P, a.kpe, a.Cio, 1, a.kpe};
  const int first = blockIdx.x * q8::kWarpgroups + q8::wg_index();
  if (first < rbs * tiles_n) q8::prefetch_b(ring, w, item_of(g, first, tiles_n).n0, 0, a.kpe);
  quantize_share(src, P, a.kpe, a.Cmid / a.groups, a.aq, a.sx, cnt, scratch);
  for (int item = first; item < rbs * tiles_n; item += gridDim.x * q8::kWarpgroups) {
    const Item it = item_of(g, item, tiles_n);
    if (item != first) q8::prefetch_b(ring, w, it.n0, 0, a.kpe);
    ready(cnt, it.rb, P);
    float f[32];
    float sg[2];  // the thread's two rows' scales of the stage's group
    q8::Acc acc;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int r0 = it.p0 + warp * 16 + lane / 4;
    const auto fin = [&](int gi, q8::Acc& d) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sg[h] = q8::scale_of_bits(
            __ldcg(a.mx2 + static_cast<size_t>(min(r0 + 8 * h, P - 1)) * a.groups + gi));
      q8::for_each_acc([&](int r, int c, int i) {
        const float v = wt::dequant(d[i], sg[(r - (r0 - it.p0)) / 8],
                                    epi.sw[min(it.n0 + c, a.Cio - 1)]);
        f[i] = gi == 0 ? v : __fadd_rn(f[i], v);
      });
    };
    q8::tile<true>(a.aq, P, a.kpe, w, it.p0, it.n0, 0, a.kpe, ring, true, acc, fin);
    for_each_row(it.p0, P, mx, [&](int p, int h) {
      unsigned m = 0u;
#pragma unroll
      for (int j = 0; j < q8::kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = it.n0 + 8 * j + threadIdx.x % 4 * 2 + e;
          if (n < a.Cio) m = max(m, q8::abs_bits(epi.store(p, n, f[4 * j + 2 * h + e])));
        }
      return m;
    });
  }
}

// h2 = relu(F(2,3)(h1, u2) * s2 + b2) over the whole map, one block's mid
// of the winograd2 route, h2's row maxima (per group) into mx2: items of 16
// tiles x CB channels dealt over the grid, U by 16-byte copies (the host
// pads Cmid to a multiple of 8 and aligns u2). Inlined into the kernel of
// its CB alone: called instead, at CB 32 both spilled, and one call for
// every CB spilled the kernel (tools/chip_ptxas.py); inlined or called ran
// alike at N=1 and N=8 (tools/chip_fp64_tile.py, PERF.md).
template <int CB>
__device__ __forceinline__ void winograd2_mid(const float* h1, const __nv_bfloat16* u2,
                                              const float* s2, const float* b2, float* h2, int N,
                                              int H, int W, int cmid, int groups, unsigned* mx2,
                                              float* smem) {
  const int cgroups = (cmid + CB - 1) / CB;
  const int items = wt::f64_tile_groups(N, H, W) * cgroups;
  const MidRowMax obs{mx2, groups, cmid / groups};
  for (int item = blockIdx.x; item < items; item += gridDim.x)
    wt::wino_f64_tile<CB>(wt::CgLoad{}, h1, u2, s2, b2, h2, N, H, W, cmid, cmid, 1,
                          item / cgroups * wt::kF64Tiles, item % cgroups * CB, smem, obs);
}

// kCols 0: the direct mid's instantiation; 8, 16 or 32: the winograd2
// mid's, on FP64 items of that many output channels.
template <int kCols>
__global__ void __launch_bounds__(q8::kThreads, kMaxBlocksPerSm)
    stage_int8_kernel(const __grid_constant__ StageInt8Args a) {
  constexpr bool kWino = kCols != 0;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[q8::kWarpgroups * q8::kStages];
  q8::Ring ring = q8::make_ring(smem, bars);
  float* scratch = reinterpret_cast<float*>(ring.base - q8::wg_index() * q8::kRingBytes);
  const int cio = a.Cio, cmid = a.Cmid;
  const int P = a.N * a.H * a.W;

  // The first phase: every block's weights k-contiguous for the whole
  // launch (the items of all 2B (winograd2) or 3B transposes dealt to the
  // grid in one walk), x's row maxima (one warp a row) and mx1 zeroed.
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
    const int warps = gridDim.x * (q8::kThreads / 32), lane = threadIdx.x % 32;
    for (int p = blockIdx.x * (q8::kThreads / 32) + threadIdx.x / 32; p < P; p += warps) {
      const float4* row = reinterpret_cast<const float4*>(a.x + static_cast<size_t>(p) * cio);
      unsigned m = 0u;
      for (int c4 = lane; c4 < cio / 4; c4 += 32) {
        const float4 v = __ldg(row + c4);
        m = max(max(m, max(q8::abs_bits(v.x), q8::abs_bits(v.y))),
                max(q8::abs_bits(v.z), q8::abs_bits(v.w)));
      }
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) a.mx_act[p] = m;
    }
    zero(a.mx1, P);
    q8::fence_proxy_async_global();  // the transposes' writes before the TMA reads
  }
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bm = static_cast<size_t>(blk) * cmid;
    const size_t bo = static_cast<size_t>(blk) * cio;
    unsigned* mx_act = a.mx_act + static_cast<size_t>(blk & 1) * P;
    unsigned* mx_next = a.mx_act + static_cast<size_t>((blk + 1) & 1) * P;
    unsigned* cnt = a.cnt + static_cast<size_t>(blk) * 3 * a.row_blocks;

    wt::grid_sync(a.bar);
    q8::fence_proxy_async_global();
    zero(a.mx2, static_cast<size_t>(P) * a.groups);
    zero(mx_next, P);
    gemm_phase(a.reduce, RowsSrc{act, cio, cio, mx_act, 1}, a.kpr, q8::Weights{&a.map_r, blk},
               BnEpi{a.swr + bm, a.s1 + bm, a.b1 + bm, a.h1, cmid}, a.mx1, a.aq, a.sx, cnt,
               a.part, a.bar, ring, scratch);
    wt::grid_sync(a.bar);

    if constexpr (kWino) {
      winograd2_mid<kCols>(a.h1, a.u2 + bm * 16 * cmid, a.s2 + bm, a.b2 + bm, a.h2, a.N, a.H,
                           a.W, cmid, a.groups, a.mx2, smem);
      wt::wg::fence_proxy_async();  // its shared-memory writes before the next TMA writes
    } else {
      gemm_phase(a.mid, Im2colSrc<1>{a.h1, a.H, a.W, cmid, a.mx1}, a.kpm,
                 q8::Weights{&a.map_m, blk},
                 BnEpi{a.sw9 + bm, a.s2 + bm, a.b2 + bm, a.h2, cmid}, a.mx2, a.aq, a.sx,
                 cnt + a.row_blocks, a.part, a.bar, ring, scratch);
    }
    wt::grid_sync(a.bar);

    zero(a.mx1, P);
    const ResEpi epi{a.swe + bo, a.s3 + bo, a.b3 + bo, act, a.out, cio};
    if (a.groups == 1)
      gemm_phase(a.expand, RowsSrc{a.h2, cmid, cmid, a.mx2, 1}, a.kpe,
                 q8::Weights{&a.map_e, blk}, epi, mx_next, a.aq, a.sx, cnt + 2 * a.row_blocks,
                 a.part, a.bar, ring, scratch);
    else
      grouped_expand(a, q8::Weights{&a.map_e, blk}, epi, mx_next, cnt + 2 * a.row_blocks, ring,
                     scratch);
  }
}

// The instantiation of the plan's mid: its FP64 items' Cout block, 0 for
// the direct mid.
const void* kernel_of(int cols) {
  if (cols == 8) return reinterpret_cast<const void*>(stage_int8_kernel<8>);
  if (cols == 16) return reinterpret_cast<const void*>(stage_int8_kernel<16>);
  if (cols == 32) return reinterpret_cast<const void*>(stage_int8_kernel<32>);
  return reinterpret_cast<const void*>(stage_int8_kernel<0>);
}

// Blocks of the plan's kernel (kernel_of(cols)) the current device holds
// resident, at most kMaxBlocksPerSm an SM (its dynamic shared memory limit
// raised once per device); 0 on error.
int resident_blocks(int cols) {
  static int cache[64][4] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  const int k = cols == 0 ? 0 : cols == 8 ? 1 : cols == 16 ? 2 : 3;
  if (cache[dev][k] == 0) {
    const void* kernel = kernel_of(cols);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem)) != cudaSuccess)
      return 0;
    cache[dev][k] = cooperative_grid(kernel, kSmem, q8::kThreads, kMaxBlocksPerSm);
  }
  return cache[dev][k];
}

size_t round_k(int k) { return (k + kKAlign - 1) / kKAlign * kKAlign; }

// A host plan's phase fits: K (padded) in `splits` ranges of `chunk`, the
// last one shorter, chunk a multiple of the tile's stage past one split.
bool phase_fits(const wt::GemmPhase& g) {
  if (g.splits == 1) return g.chunk == g.K;
  return g.splits > 1 && g.splits <= kSplitCap && g.chunk % q8::kBK == 0 &&
         static_cast<long long>(g.chunk) * g.splits >= g.K &&
         static_cast<long long>(g.chunk) * (g.splits - 1) < g.K;
}

// 4-byte words holding `bytes` bytes, rounded up to the workspace's step.
size_t words_of(size_t bytes) { return workspace_round_up((bytes + 3) / 4); }

struct Plan {
  int grid, kpr, kpm, kpe, row_blocks, wcols;
  wt::GemmPhase reduce, mid, expand;
  // workspace offsets and size, in words (the barrier and the row blocks'
  // counters first: one memset zeroes both)
  size_t cnt, h1, h2, sx, mx_act, mx1, mx2, aq, btr, btm, bte, part, total;
};

// The host's plan (kernels/quantized.py::stage_int8_plan): `grid` blocks;
// phases[0..5] the (splits, chunk) of the reduce, the mid and the expand
// (one split when groups > 1), each over its padded K; the winograd2
// route's mid is (1, the FP64 items' Cout block: 8, 16 or 32).
int make_plan(int N, int H, int W, int Cio, int Cmid, int B, int wino, int groups, int grid,
              const int* phases, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || Cio <= 0 || Cmid <= 0 || B <= 0 || Cio % 4 != 0 ||
      Cmid % 4 != 0 || groups <= 0 || Cmid % groups != 0 || grid <= 0 ||
      (groups > 1 && (!wino || Cmid / groups != q8::kBK)) || (wino && Cmid % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t P = static_cast<size_t>(N) * H * W;
  pl->grid = grid;
  pl->kpr = static_cast<int>(round_k(Cio));
  pl->kpm = wino ? 0 : static_cast<int>(round_k(9 * Cmid));
  pl->kpe = static_cast<int>(round_k(Cmid));
  const int p = static_cast<int>(P);
  pl->reduce = wt::GemmPhase{p, pl->kpr, Cmid, phases[0], phases[1]};
  pl->mid = wino ? wt::GemmPhase{p, 0, Cmid, 1, 0}
                 : wt::GemmPhase{p, pl->kpm, Cmid, phases[2], phases[3]};
  pl->wcols = wino ? phases[3] : 0;
  if (wino && (phases[2] != 1 || (pl->wcols != 8 && pl->wcols != 16 && pl->wcols != 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  pl->expand = wt::GemmPhase{p, pl->kpe, Cio, phases[4], phases[5]};
  if (!phase_fits(pl->reduce) || !phase_fits(pl->mid) || !phase_fits(pl->expand) ||
      (groups > 1 && pl->expand.splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  pl->row_blocks = static_cast<int>((P + q8::kBM - 1) / q8::kBM);
  size_t part = phase_partial_floats(pl->reduce);
  if (phase_partial_floats(pl->mid) > part) part = phase_partial_floats(pl->mid);
  if (phase_partial_floats(pl->expand) > part) part = phase_partial_floats(pl->expand);
  size_t kp = pl->kpr > pl->kpe ? pl->kpr : pl->kpe;
  if (static_cast<size_t>(pl->kpm) > kp) kp = pl->kpm;
  pl->cnt = 2;  // after the barrier's two counters
  pl->h1 = workspace_round_up(pl->cnt + static_cast<size_t>(3) * B * pl->row_blocks);
  pl->h2 = pl->h1 + workspace_round_up(P * Cmid);
  pl->sx = pl->h2 + workspace_round_up(P * Cmid);
  pl->mx_act = pl->sx + workspace_round_up(P);
  pl->mx1 = pl->mx_act + workspace_round_up(2 * P);
  pl->mx2 = pl->mx1 + workspace_round_up(P);
  pl->aq = pl->mx2 + workspace_round_up(P * groups);
  pl->btr = pl->aq + words_of(P * kp);
  pl->btm = pl->btr + words_of(static_cast<size_t>(B) * Cmid * pl->kpr);
  pl->bte = pl->btm + words_of(static_cast<size_t>(B) * Cmid * pl->kpm);
  pl->part = pl->bte + words_of(static_cast<size_t>(B) * Cio * pl->kpe);
  pl->total = pl->part + part;
  return 0;
}

}  // namespace

// Blocks an SM the cooperative grid takes at most (the host's plan,
// kernels/quantized.py::STAGE_INT8_BLOCKS_PER_SM, checks against it).
extern "C" int resnet_stage_int8_blocks_per_sm() { return kMaxBlocksPerSm; }

// 4-byte words of workspace resnet_stage_int8 needs for this shape and
// plan on the current device (into *words); returns a CUDA error code.
extern "C" int resnet_stage_int8_workspace(int N, int H, int W, int Cio, int Cmid, int B,
                                           int wino, int groups, int grid, const int* phases,
                                           long long* words) {
  Plan pl;
  const int err = make_plan(N, H, W, Cio, Cmid, B, wino, groups, grid, phases, &pl);
  if (err == 0) *words = static_cast<long long>(pl.total);
  return err;
}

// wm is the int8 w9_mid stack (wino = 0) or the bf16 u2_mid stack (wino = 1,
// 16-byte aligned); sw9 is read only by the direct mid. Cio and Cmid
// multiples of 4, Cmid of 8 on winograd2 (the wrapper pads other counts
// with zero channels); groups: the expand's
// quantization groups, 1 or (winograd2 only) Cmid / 128; x, out and ws
// 16-byte aligned; grid and phases the host's plan, refused where it does
// not fit the geometry or the card.
extern "C" int resnet_stage_int8(const float* x, const int8_t* wr, const float* swr,
                                 const float* s1, const float* b1, const void* wm,
                                 const float* sw9, const float* s2, const float* b2,
                                 const int8_t* we, const float* swe, const float* s3,
                                 const float* b3, float* out, float* ws,
                                 long long ws_words, int N, int H, int W, int Cio,
                                 int Cmid, int B, int wino, int groups, int grid,
                                 const int* phases, void* stream) {
  Plan pl;
  const int err = make_plan(N, H, W, Cio, Cmid, B, wino, groups, grid, phases, &pl);
  if (err != 0) return err;
  const int resident = resident_blocks(pl.wcols);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (grid > resident || ws_words < static_cast<long long>(pl.total) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0 ||
      (wino && reinterpret_cast<uintptr_t>(wm) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  StageInt8Args a{};
  a.btr = reinterpret_cast<int8_t*>(ws + pl.btr);
  a.btm = reinterpret_cast<int8_t*>(ws + pl.btm);
  a.bte = reinterpret_cast<int8_t*>(ws + pl.bte);
  cudaError_t e = q8::encode_kmajor(&a.map_r, a.btr, B, Cmid, pl.kpr);
  if (e == cudaSuccess && !wino) e = q8::encode_kmajor(&a.map_m, a.btm, B, Cmid, pl.kpm);
  if (e == cudaSuccess) e = q8::encode_kmajor(&a.map_e, a.bte, B, Cio, pl.kpe);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  // The barrier's counters and the row blocks' (3B x row_blocks) in one memset.
  e = cudaMemsetAsync(bar, 0, (pl.cnt + static_cast<size_t>(3) * B * pl.row_blocks) * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.x = x;
  a.out = out;
  a.wr = wr;
  a.swr = swr;
  a.s1 = s1;
  a.b1 = b1;
  a.w9 = wino ? nullptr : static_cast<const int8_t*>(wm);
  a.u2 = wino ? static_cast<const __nv_bfloat16*>(wm) : nullptr;
  a.sw9 = sw9;
  a.s2 = s2;
  a.b2 = b2;
  a.we = we;
  a.swe = swe;
  a.s3 = s3;
  a.b3 = b3;
  a.h1 = ws + pl.h1;
  a.h2 = ws + pl.h2;
  a.sx = ws + pl.sx;
  a.mx_act = reinterpret_cast<unsigned*>(ws + pl.mx_act);
  a.mx1 = reinterpret_cast<unsigned*>(ws + pl.mx1);
  a.mx2 = reinterpret_cast<unsigned*>(ws + pl.mx2);
  a.cnt = reinterpret_cast<unsigned*>(ws + pl.cnt);
  a.aq = reinterpret_cast<int8_t*>(ws + pl.aq);
  a.part = reinterpret_cast<int*>(ws + pl.part);
  a.bar = bar;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cio = Cio;
  a.Cmid = Cmid;
  a.B = B;
  a.groups = groups;
  a.kpr = pl.kpr;
  a.kpm = pl.kpm;
  a.kpe = pl.kpe;
  a.row_blocks = pl.row_blocks;
  a.reduce = pl.reduce;
  a.mid = pl.mid;
  a.expand = pl.expand;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_of(pl.wcols), dim3(pl.grid),
                                  dim3(q8::kThreads), args, kSmem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
