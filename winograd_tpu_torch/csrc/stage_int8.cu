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
// publish_row_max), and the consuming phase quantizes its rows itself:
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
// divides only where it can change the result (quantize_fast).
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
#include "winograd.cuh"

namespace {

namespace q8 = wt::wgs8;
namespace s8 = wt::s8mma;

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

// ---- the rows a GEMM quantizes -----------------------------------------------

// Rows of a row-major (P, ld) float matrix written earlier in the launch,
// k < K; the scale of group g from the row maxima mx[p * mx_stride + g].
struct RowsSrc {
  const float* x;
  int ld, K;
  const unsigned* mx;
  int mx_stride;
  __device__ __forceinline__ float scale(int p, int g) const {
    return q8::scale_of_bits(__ldcg(mx + static_cast<size_t>(p) * mx_stride + g));
  }
  __device__ __forceinline__ int2 yx(int) const { return make_int2(0, 0); }
  __device__ __forceinline__ float4 load(int p, int2, int k) const {
    return k < K ? __ldcg(reinterpret_cast<const float4*>(x + static_cast<size_t>(p) * ld + k))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// The pad-1 3x3 im2col rows of an (N, H, W, C) map written earlier in the
// launch, k = (3r + s) * C + c < 9C; a row's maximum is the max of its nine
// pixels' (zero for a tap outside the map, as the zero padding gives).
struct Im2colSrc {
  const float* x;
  int H, W, C;
  const unsigned* mx;  // per pixel
  __device__ __forceinline__ int2 yx(int p) const {
    const int q = p % (H * W);
    return make_int2(q / W, q % W);
  }
  __device__ __forceinline__ float scale(int p, int) const {
    const int2 c = yx(p);
    unsigned m = 0u;
#pragma unroll
    for (int rs = 0; rs < 9; ++rs) {
      const int dy = rs / 3 - 1, dx = rs % 3 - 1;
      if (c.x + dy >= 0 && c.x + dy < H && c.y + dx >= 0 && c.y + dx < W)
        m = max(m, __ldcg(mx + p + dy * W + dx));
    }
    return q8::scale_of_bits(m);
  }
  __device__ __forceinline__ float4 load(int p, int2 c, int k) const {
    const int rs = k / C, dy = rs / 3 - 1, dx = rs % 3 - 1;
    if (rs >= 9 || c.x + dy < 0 || c.x + dy >= H || c.y + dx < 0 || c.y + dx >= W)
      return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = x + static_cast<size_t>(p + dy * W + dx) * C + (k - rs * C);
    return __ldcg(reinterpret_cast<const float4*>(src));
  }
};

// The IEEE division's quantize, called apart (a branch the warps rarely
// take, not a division predicated into every value).
__device__ __noinline__ int quantize_exact(float v, float s) { return wt::quantize(v, s); }

// gemm_int8.cuh's quantize(v, s) = clamp(rint(v / s), -127, 127), with the
// IEEE division only where it can matter: y = v * r (r = 1 / s) is within
// 3e-5 of v / s when |v| is at most the row's max (|v / s| <= ~127), so
// where y lies more than 2^-12 from every half-integer both round to the
// same integer; nearer one, or where y is not finite, the division decides.
__device__ __forceinline__ int quantize_fast(float v, float s, float r) {
  const float y = __fmul_rn(v, r), t = rintf(y);
  if (!(fabsf(fabsf(y - t) - 0.5f) >= 0x1p-12f)) return quantize_exact(v, s);
  return min(127, max(-127, static_cast<int>(t)));
}

// Rows [pb, pe) of `a`, k in [k0, k1) (multiples of 4, the range one group
// or whole groups of cg), quantized (gemm_int8.cuh's arithmetic) into aq
// (row stride Kp), each row's scale of its first group into sx. The rows'
// scales, their reciprocals and their map coordinates go to shared memory
// first (scratch: the first ring's first A region, whose kABytes the
// prefetched B boxes leave alone); then tpr threads a row walk its
// float4s, kLoads a thread in flight.
template <class Src>
__device__ __forceinline__ void quantize_rows(const Src& a, int pb, int pe, int k0, int k1, int Kp,
                                              int cg, int8_t* aq, float* sx, float* scratch) {
  constexpr int kLoads = 8;
  const int rows = pe - pb, ng = (k1 - k0 + cg - 1) / cg, g0 = k0 / cg;
  if (rows <= 0) return;
  float* sc = scratch;                                         // rows x ng scales
  float* rc = scratch + rows * ng;                             // their reciprocals
  int2* yx = reinterpret_cast<int2*>(scratch + (2 * rows * ng + 1) / 2 * 2);  // rows' (y, x)
  for (int e = threadIdx.x; e < rows * ng; e += q8::kThreads) {
    const int r = e / ng, g = e - r * ng;
    sc[e] = a.scale(pb + r, g0 + g);
    rc[e] = 1.f / sc[e];
    if (g == 0) sx[pb + r] = sc[e];
  }
  for (int r = threadIdx.x; r < rows; r += q8::kThreads) yx[r] = a.yx(pb + r);
  __syncthreads();
  const int kq = (k1 - k0) / 4;
  const int tpr = kq < q8::kThreads ? kq : q8::kThreads;  // threads a row
  const int rstep = q8::kThreads / tpr, c0 = threadIdx.x % tpr;
  int r = threadIdx.x / tpr, c = c0;
  if (threadIdx.x >= rstep * tpr) return;
  while (r < rows) {
    float4 v[kLoads];
    int rr[kLoads], cc[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      rr[u] = r;
      cc[u] = c;
      v[u] = r < rows ? a.load(pb + r, yx[r], k0 + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
      c += tpr;
      if (c >= kq) {
        c = c0;
        r += rstep;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (rr[u] >= rows) break;
      const int k = k0 + 4 * cc[u], i = rr[u] * ng + (k - k0) / cg;
      const float s = sc[i], rs = rc[i];
      const int q0 = quantize_fast(v[u].x, s, rs), q1 = quantize_fast(v[u].y, s, rs);
      const int q2 = quantize_fast(v[u].z, s, rs), q3 = quantize_fast(v[u].w, s, rs);
      *reinterpret_cast<unsigned*>(aq + static_cast<size_t>(pb + rr[u]) * Kp + k) =
          static_cast<unsigned>(wt::pack4(q0, q1, q2, q3));
    }
  }
}

// This block's share of a phase's rows, [pb, pe), quantized over all Kp by
// quantize_rows in pieces, then one arrival on the
// counter of each 64-row block (kBM) the share touches. Every thread's writes
// before it are seen after ready() in any block (grid_sync.cuh's fences).
template <class Src>
__device__ __forceinline__ void quantize_share(const Src& a, int P, int Kp, int cg, int8_t* aq,
                                               float* sx, unsigned* cnt, float* scratch) {
  const int rows = (P + gridDim.x - 1) / gridDim.x;
  const int pb = blockIdx.x * rows, pe = min(P, pb + rows);
  // Pieces whose scales and coordinates fit the ring's first A region.
  const int ng = (Kp + cg - 1) / cg;
  const int piece = min(q8::kBM, (q8::kABytes / 4 - 16) / (2 * ng + 2));
  for (int b = pb; b < pe; b += piece) {
    quantize_rows(a, b, min(pe, b + piece), 0, Kp, Kp, cg, aq, sx, scratch);
    __syncthreads();  // the scratch is rewritten by the next piece
  }
  if (pb < pe && threadIdx.x == 0) {
    __threadfence();
    for (int rb = pb / q8::kBM; rb <= (pe - 1) / q8::kBM; ++rb) atomicAdd(cnt + rb, 1u);
  }
}

// Waits, in the calling warpgroup, until every block whose share touches
// row block rb has arrived.
__device__ __forceinline__ void ready(const unsigned* cnt, int rb, int P) {
  if (q8::wg_thread() == 0) {
    const int rows = (P + gridDim.x - 1) / gridDim.x;
    const int first = rb * q8::kBM / rows, last = (min(P, (rb + 1) * q8::kBM) - 1) / rows;
    const volatile unsigned* c = cnt + rb;
    while (*c < static_cast<unsigned>(last - first + 1)) __nanosleep(32);
    __threadfence();
  }
  q8::wg_sync();
}

// ---- epilogues -----------------------------------------------------------------

// relu(float(acc) * (sx * sw[n]) * scale[n] + bias[n]) into out[p, n] (row
// stride N); returns it.
struct BnEpi {
  const float* __restrict__ sw;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  float* out;
  int N;
  __device__ __forceinline__ float operator()(int p, int n, int acc, float sx) const {
    const float y = wt::relu(wt::bn_rn(wt::dequant(acc, sx, sw[n]), scale[n], bias[n]));
    out[static_cast<size_t>(p) * N + n] = y;
    return y;
  }
};

// The expand's: out[p, n] = relu(deq * scale[n] + bias[n] + res[p, n]), deq
// the dequantized product, each multiply and add rounded on its own; res
// may be out (each element is read only by the thread that overwrites it);
// returns it.
struct ResEpi {
  const float* __restrict__ sw;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  const float* res;
  float* out;
  int N;
  __device__ __forceinline__ float store(int p, int n, float deq) const {
    const size_t i = static_cast<size_t>(p) * N + n;
    const float y = wt::relu(__fadd_rn(wt::bn_rn(deq, scale[n], bias[n]), __ldcg(res + i)));
    out[i] = y;
    return y;
  }
  __device__ __forceinline__ float operator()(int p, int n, int acc, float sx) const {
    return store(p, n, wt::dequant(acc, sx, sw[n]));
  }
};

struct NoFin {
  __device__ __forceinline__ void operator()(int, q8::Acc&) const {}
};

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

// v[i] = 0 for i < n, over the grid.
__device__ __forceinline__ void zero(unsigned* v, size_t n) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    v[i] = 0u;
}

// The thread's two accumulator rows of the tile (h = 0, 1), relative to
// its corner, and f(row, h) over them, then each row's maximum m published.
template <class F>
__device__ __forceinline__ void for_each_row(int p0, int P, unsigned* mx, const F& f) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + warp * 16 + lane / 4 + 8 * h;
    q8::publish_row_max(p < P ? f(p, h) : 0u, mx, p, P);
  }
}

// One split's tile through epi: each row's outputs, and max |y| into mx.
template <class Epi>
__device__ __forceinline__ void tile_epilogue(const q8::Acc& acc, int P, int N, int p0, int n0,
                                              const float* sx, const Epi& epi, unsigned* mx) {
  for_each_row(p0, P, mx, [&](int p, int h) {
    const float s = __ldcg(sx + p);
    unsigned m = 0u;
#pragma unroll
    for (int j = 0; j < q8::kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + threadIdx.x % 4 * 2 + e;
        if (n < N) m = max(m, q8::abs_bits(epi(p, n, acc[4 * j + 2 * h + e], s)));
      }
    return m;
  });
}

// An item of a phase with `tiles_n` column tiles: its split, row block,
// its tile's corner and its K range.
struct Item {
  int split, rb, p0, n0, k0, k1;
};

__device__ __forceinline__ Item item_of(const wt::GemmPhase& g, int item, int tiles_n) {
  const int tiles = (g.P + q8::kBM - 1) / q8::kBM * tiles_n;
  const int split = item / tiles, t = item - split * tiles;
  const int rb = t / tiles_n, k0 = split * g.chunk;
  return Item{split, rb, rb * q8::kBM, t % tiles_n * q8::kBN, k0, min(g.K, k0 + g.chunk)};
}

// This block's items of the product of phase g, each warpgroup walking its
// own. First the block quantizes its share of the phase's rows from `a`
// (group width cg; scratch: the first ring's first A region) into aq; then
// each item waits for its row block's quantized rows (no grid barrier: the
// row block's counter) and multiplies them by the
// k-contiguous weights w; each output through epi and its row maxima into
// mx, at one split; past one, the items' int32 partial tiles into part
// (splits x P x N), then after a grid barrier the blocks add the splits and
// run epi once per element (a warp whose 32 elements lie in one row
// publishes one maximum). cnt: the phase's zeroed row-block counters. The
// caller places the barrier that ends the phase.
template <class Src, class Epi>
__device__ __forceinline__ void gemm_phase(const wt::GemmPhase& g, const Src& a, int cg,
                                           const q8::Weights& w, const Epi& epi, unsigned* mx,
                                           int8_t* aq, float* sx, unsigned* cnt, int* part,
                                           unsigned int* bar, q8::Ring& ring, float* scratch) {
  const int tiles_n = (g.N + q8::kBN - 1) / q8::kBN;
  const int rbs = (g.P + q8::kBM - 1) / q8::kBM;
  const int items = rbs * tiles_n * g.splits;
  const int first = blockIdx.x * q8::kWarpgroups + q8::wg_index();  // the warpgroup's items
  if (first < items) {
    const Item it = item_of(g, first, tiles_n);
    q8::prefetch_b(ring, w, it.n0, it.k0, it.k1);  // the first item's weights meanwhile
  }
  quantize_share(a, g.P, g.K, cg, aq, sx, cnt, scratch);
  for (int item = first; item < items; item += gridDim.x * q8::kWarpgroups) {
    const Item it = item_of(g, item, tiles_n);
    if (item != first) q8::prefetch_b(ring, w, it.n0, it.k0, it.k1);
    ready(cnt, it.rb, g.P);
    q8::Acc acc;
    q8::tile<false>(aq, g.P, g.K, w, it.p0, it.n0, it.k0, it.k1, ring, true, acc, NoFin{});
    if (g.splits == 1) {
      tile_epilogue(acc, g.P, g.N, it.p0, it.n0, sx, epi, mx);
      continue;
    }
    int* sp = part + static_cast<size_t>(it.split) * g.P * g.N;
    q8::for_each_acc([&](int r, int c, int i) {
      const int p = it.p0 + r, n = it.n0 + c;
      if (p < g.P && n < g.N) sp[static_cast<size_t>(p) * g.N + n] = acc[i];
    });
  }
  if (g.splits == 1) return;
  wt::grid_sync(bar);
  const size_t pn = static_cast<size_t>(g.P) * g.N;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t end = (pn + 31) / 32 * 32;  // whole warps, for the row reduction
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < end;
       i += stride) {
    const bool live = i < pn;
    const int p = live ? static_cast<int>(i / g.N) : -1;
    unsigned m = 0u;
    if (live) {
      int s = 0;
      for (int k0 = 0; k0 < g.splits; k0 += 8) {  // eight splits' loads in flight
        int v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = k0 + u < g.splits ? __ldcg(part + (k0 + u) * pn + i) : 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) s += v[u];
      }
      m = q8::abs_bits(epi(p, static_cast<int>(i % g.N), s, __ldcg(sx + p)));
    }
    const int p_first = __shfl_sync(0xffffffffu, p, 0);
    if (__all_sync(0xffffffffu, p == p_first)) {
      m = __reduce_max_sync(0xffffffffu, m);
      if (threadIdx.x % 32 == 0 && p_first >= 0 && m != 0u) atomicMax(mx + p_first, m);
    } else if (live && m != 0u) {
      atomicMax(mx + p, m);
    }
  }
}

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
      gemm_phase(a.mid, Im2colSrc{a.h1, a.H, a.W, cmid, a.mx1}, a.kpm,
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
