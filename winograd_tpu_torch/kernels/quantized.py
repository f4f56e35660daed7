"""The int8 serving tier: offline weight quantization, the four int8 kernels
and their plain twins.

Port of winograd_tpu/kernels/quantized.py. Weights are quantized offline,
symmetric per output column (quantize_weights); activations are quantized
per row inside each kernel: s_x = max|row| / 127 (1 for a zero row),
q = clamp(round_half_even(x / s_x), -127, 127); the int8 x int8 product is
summed exactly in int32 and dequantized as float(acc) * (s_x * s_w), then
the folded BN (+ReLU). A row is the GEMM's row: a pixel over its channels
for a 1x1, an im2col row over all 9*C gathered values (zero padding
included) for a 3x3.

Kernels (CUDA C++ for sm_90a, csrc/*_int8.cu on csrc/gemm_int8.cuh's
arithmetic and csrc/mma_int8.cuh's s8 mma.sync; every one takes any
channel count, see pad_to):

* conv1x1_bn_int8 -> csrc/pointwise_int8.cu (_quant_matmul_kernel): a
  GEMV at a few rows, else the product on the int8 tensor cores, rows
  quantized in one pass a block (short K) or once by a cooperative grid
  with K split (longer K), the path and split by pointwise_int8_plan;
* conv3x3_bn_int8 -> csrc/direct_int8.cu (_direct_int8_kernel and its
  row-banded twin) on csrc/mma_int8.cuh: rows quantized once, the product
  on the int8 tensor cores with K split by direct_int8_plan;
* resnet_stage_int8 -> csrc/stage_int8.cu (_stage_int8_kernel, its
  resident twin, and _block_int8_kernel at one block) on csrc/mma_int8.cuh
  as conv3x3_bn_int8; the mid-layer is the int8 direct 3x3 or, on maps of
  28x28 and up, F(2,3) on bf16 filters;
* transition_block_int8 -> csrc/transition_int8.cu (_transition_int8_kernel
  and its resident twin) on csrc/mma_int8.cuh as resnet_stage_int8: every
  row quantized once, the grid and the phases' K splits by
  transition_int8_plan;
* conv3x3_bn_winograd_int8 -> csrc/winograd_int8.cu (_winograd_int8_kernel):
  F(2,3) with V quantized per row (a 4x4 tile at one of its 16 positions)
  and per-position filter scales (quantize_winograd_filter); work items of
  16 tiles x one position x 128 output channels, V transformed and
  quantized once an item, the products on the int8 tensor cores, the
  inverse after a grid barrier, the grid by winograd_int8_plan.

The plain twins compute the integer product as a float64 matmul of the int8
values (exact: every |sum| < 2^53) and cast it as int32 -> float32 would;
they run on the CPU and on the card. CPU tensors run them; CUDA tensors
launch the kernels or raise. Kernels and twins agree to the bit, on purpose:
in a chain of int8 layers a last-bit difference moves a value across a
rounding boundary of the next quantization now and then, a whole step, and
that grows block after block. So the scale is a true division (never a
multiply by 1/127), the epilogues round each multiply and add in the same
order, and the bf16-filter F(2,3) mid computes its algebra in float64 and
rounds once (the kernel in FP64), which makes it independent of the order
of its sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.direct import im2col3x3
from winograd_tpu_torch.kernels.pointwise import COUNTER_WORDS
from winograd_tpu_torch.kernels.splitk import H100_SMS, Split, split_k
from winograd_tpu_torch.kernels.stage import WINOGRAD_MIN_PIXELS
from winograd_tpu_torch.kernels.transition import strided_im2col
from winograd_tpu_torch.kernels.winograd import winograd2_mid_plain, winograd_matrices

BN_KEYS = ("s_reduce", "b_reduce", "s_mid", "b_mid", "s_expand", "b_expand")
PROJ_BN_KEYS = ("s_proj", "b_proj")


# --- offline quantization (numpy; copies of the JAX package's) -------------


def quantize_weights(w):
    """Symmetric per-output-channel int8 weights. w: (Cin, Cout) ->
    (w_q int8 (Cin, Cout), s_w float32 (Cout,)), numpy."""
    w = np.asarray(w, np.float32)
    s_w = np.abs(w).max(axis=0) / 127.0
    s_w = np.where(s_w == 0, 1.0, s_w).astype(np.float32)
    w_q = np.clip(np.rint(w / s_w), -127, 127).astype(np.int8)
    return w_q, s_w


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _quantize(params: Dict, weight_keys, bn_keys) -> Dict[str, torch.Tensor]:
    out = {}
    for key in weight_keys:
        w_q, s_w = quantize_weights(_numpy(params[key]))
        out[f"{key}_q"] = torch.from_numpy(w_q)
        out[f"{key}_s"] = torch.from_numpy(s_w)
    for key in bn_keys:
        out[key] = torch.from_numpy(np.asarray(_numpy(params[key]), np.float32))
    return out


def quantize_block_params(params: Dict) -> Dict[str, torch.Tensor]:
    """An identity block's three weight matrices to int8 (w_reduce_q/_s,
    w9_mid_q/_s, w_expand_q/_s); BN stays float32; the F(2,3) filter u2_mid,
    when present, becomes u2_mid_bf16 (round to nearest even)."""
    out = _quantize(params, ("w_reduce", "w9_mid", "w_expand"), BN_KEYS)
    if "u2_mid" in params:
        u2 = torch.from_numpy(np.asarray(_numpy(params["u2_mid"]), np.float32))
        out["u2_mid_bf16"] = u2.to(torch.bfloat16)
    return out


def quantize_stage_params(blocks: List[Dict]) -> Dict[str, torch.Tensor]:
    """A stage's blocks quantized and stacked on a leading block axis (1-D
    arrays as (B, 1, C)), the int8 twin of kernels/stage.py's
    stack_stage_params."""
    qs = [quantize_block_params(p) for p in blocks]
    out = {}
    for key in qs[0]:
        ts = [q[key] for q in qs]
        if ts[0].dim() == 1:
            ts = [t.reshape(1, -1) for t in ts]
        out[key] = torch.stack(ts).contiguous()
    return out


def quantize_transition_params(params: Dict) -> Dict[str, torch.Tensor]:
    """A transition (or projection) block's four weight matrices to int8;
    BN stays float32."""
    return _quantize(params, ("w_reduce", "w9_mid", "w_expand", "w_proj"),
                     BN_KEYS + PROJ_BN_KEYS)


def quantize_winograd_filter(u):
    """Per-position per-output-channel symmetric int8 quantization of the
    F(2,3) filter u (a2, Cin, Cout): (u_q int8 (a2, Cin, Cout), s_u float32
    (a2, Cout)), numpy. A copy of the JAX package's."""
    u = np.asarray(u, np.float32)
    s_u = np.abs(u).max(axis=1) / 127.0
    s_u = np.where(s_u == 0, 1.0, s_u).astype(np.float32)
    u_q = np.clip(np.rint(u / s_u[:, None, :]), -127, 127).astype(np.int8)
    return u_q, s_u


# --- the int8 product --------------------------------------------------------


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization of x (..., K): (q, s_x) with q
    the int8 values (in x's dtype) and s_x (..., 1)."""
    m = x.abs().amax(dim=-1, keepdim=True)
    s = m / torch.full_like(m, 127.0)  # true division: a scalar divisor becomes * (1/127)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.clamp(torch.round(x / s), -127, 127), s


def qdot_plain(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """Dynamic per-row activation quantization, the exact integer product,
    dequantization: float(q(x) @ w_q) * (s_x * s_w), in x's dtype."""
    q, s = quantize_rows(x)
    acc = torch.matmul(q.double(), w_q.double())
    return acc.to(x.dtype) * (s * s_w.to(x.dtype))


# --- plain twins -------------------------------------------------------------


def _bn_relu(y, scale, bias, relu: bool):
    y = y * scale + bias
    return torch.relu(y) if relu else y


def conv1x1_bn_int8_plain(x, w_q, s_w, scale, bias, relu: bool) -> torch.Tensor:
    return _bn_relu(qdot_plain(x, w_q, s_w), scale, bias, relu)


def conv3x3_bn_int8_plain(x, w9_q, s_w9, scale, bias, relu: bool = True) -> torch.Tensor:
    """im2col (zero padding in the rows' scales), then the int8 product.
    x: (N, H, W, Cin)."""
    return _bn_relu(qdot_plain(im2col3x3(x), w9_q, s_w9), scale, bias, relu)


# Output channels per tile of the JAX int8 Winograd kernel (tile_co): a map
# with more output channels than this is tiled and stashes V quantized over
# all of Cin; one tile quantizes V per group of WINO_INT8_GROUP channels.
WINO_INT8_TILE_CO = 128
WINO_INT8_GROUP = 128


def wino_int8_stash(cout: int) -> bool:
    """True when the JAX kernel takes its quantized-V-stash branch (more
    than one output-channel tile); Cout must then be a multiple of 128."""
    if cout > WINO_INT8_TILE_CO and cout % WINO_INT8_TILE_CO:
        raise ValueError(f"the int8 Winograd tiles Cout = {cout} > 128 by 128")
    return cout > WINO_INT8_TILE_CO


def conv3x3_bn_winograd_int8_plain(x, u_q, s_u, scale, bias, relu: bool = True) -> torch.Tensor:
    """The int8 F(2,3) in plain PyTorch. V = Bt d Bt^T and At M At^T in
    float64, each rounded to x's dtype once; V quantized per (tile,
    position) row, per WINO_INT8_GROUP channels with the groups' dequantized
    products added in order, or over all of Cin with one int32 sum
    (wino_int8_stash: scale max|V| / 127, 1 / 127 for a zero row); the
    product dequantized by (s_v * s_u). x: (N, H, W, Cin)."""
    n, h, w, cin = x.shape
    cout = u_q.shape[2]
    th, tw = -(-h // 2), -(-w // 2)
    bt, at = winograd_matrices(2, torch.float64, x.device)
    xp = F.pad(x.double(), (0, 0, 1, 2 * tw + 1 - w, 1, 2 * th + 1 - h))
    d = xp.unfold(1, 4, 2).unfold(2, 4, 2)                 # (n, th, tw, cin, 4, 4)
    v = torch.einsum("ik,nyxckl,jl->nyxijc", bt, d, bt).reshape(-1, 16, cin).to(x.dtype)
    uq, su = u_q.double(), s_u.to(x.dtype)
    if wino_int8_stash(cout):
        m = v.abs().amax(dim=-1, keepdim=True)
        s = torch.where(m == 0, torch.ones_like(m), m) / torch.full_like(m, 127.0)
        q = torch.clamp(torch.round(v / s), -127, 127)
        mm = torch.einsum("tpc,pco->tpo", q.double(), uq).to(x.dtype) * (s * su)
    else:
        cg = WINO_INT8_GROUP if cin % WINO_INT8_GROUP == 0 else cin
        mm = None
        for g in range(0, cin, cg):
            q, s = quantize_rows(v[..., g:g + cg])
            part = torch.einsum("tpc,pco->tpo", q.double(), uq[:, g:g + cg]).to(x.dtype) * (s * su)
            mm = part if mm is None else mm + part
    y = torch.einsum("pi,tijo,qj->tpqo", at, mm.double().reshape(-1, 4, 4, cout), at)
    y = y.to(x.dtype).reshape(n, th, tw, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(n, 2 * th, 2 * tw, cout)[:, :h, :w]
    return _bn_relu(y, scale, bias, relu)


def resolve_mid_algo(mid_algo: str, qstacked: Dict, h: int, w: int) -> str:
    """"auto" takes F(2,3) on the bf16 filter ("winograd2") when
    u2_mid_bf16 is there and the map has at least WINOGRAD_MIN_PIXELS
    pixels, else "direct" (the JAX package's rule)."""
    if mid_algo == "auto":
        wino = "u2_mid_bf16" in qstacked and h * w >= WINOGRAD_MIN_PIXELS
        return "winograd2" if wino else "direct"
    if mid_algo not in ("direct", "winograd2"):
        raise ValueError(f"unknown mid_algo {mid_algo!r}")
    if mid_algo == "winograd2" and "u2_mid_bf16" not in qstacked:
        raise ValueError("mid_algo 'winograd2' needs the bf16 F(2,3) filter u2_mid_bf16")
    return mid_algo


def expand_groups(cmid: int, mid_algo: str) -> int:
    """The winograd2 route quantizes h2 for the expand GEMM per group of
    128 channels when Cmid is a multiple of 128 (else one group); the
    direct route over all of Cmid."""
    return cmid // 128 if mid_algo == "winograd2" and cmid % 128 == 0 else 1


def resnet_stage_int8_plain(x, qstacked: Dict, mid_algo: str = "auto",
                            groups: int = 0) -> torch.Tensor:
    """The int8 stage block by block in plain PyTorch. x: (N, H, W, Cio).
    groups: the expand's quantization groups; 0 takes expand_groups(Cmid)
    (the wrapper passes the unpadded Cmid's when it pads)."""
    mid_algo = resolve_mid_algo(mid_algo, qstacked, x.shape[-3], x.shape[-2])
    q = qstacked
    cmid = q["w_reduce_q"].shape[2]
    groups = groups or expand_groups(cmid, mid_algo)
    cg = cmid // groups
    for b in range(q["w_reduce_q"].shape[0]):
        h = conv1x1_bn_int8_plain(x, q["w_reduce_q"][b], q["w_reduce_s"][b, 0],
                                  q["s_reduce"][b, 0], q["b_reduce"][b, 0], True)
        if mid_algo == "winograd2":
            h = winograd2_mid_plain(h, q["u2_mid_bf16"][b], q["s_mid"][b, 0], q["b_mid"][b, 0])
        else:
            h = conv3x3_bn_int8_plain(h, q["w9_mid_q"][b], q["w9_mid_s"][b, 0],
                                      q["s_mid"][b, 0], q["b_mid"][b, 0])
        h3 = None
        for g in range(groups):
            part = qdot_plain(h[..., g * cg:(g + 1) * cg], q["w_expand_q"][b, g * cg:(g + 1) * cg],
                              q["w_expand_s"][b, 0])
            h3 = part if h3 is None else h3 + part
        x = torch.relu(h3 * q["s_expand"][b, 0] + q["b_expand"][b, 0] + x)
    return x


def transition_block_int8_plain(x, q: Dict) -> torch.Tensor:
    """Reduce, strided-im2col 3x3, then the expand and projection products
    quantized separately, each with its BN, added, ReLU. x: (N, H, W, Cin)."""
    h = conv1x1_bn_int8_plain(x, q["w_reduce_q"], q["w_reduce_s"], q["s_reduce"],
                              q["b_reduce"], True)
    h = conv1x1_bn_int8_plain(strided_im2col(h), q["w9_mid_q"], q["w9_mid_s"], q["s_mid"],
                              q["b_mid"], True)
    h3 = conv1x1_bn_int8_plain(h, q["w_expand_q"], q["w_expand_s"], q["s_expand"],
                               q["b_expand"], False)
    skip = conv1x1_bn_int8_plain(x[:, ::2, ::2, :], q["w_proj_q"], q["w_proj_s"],
                                 q["s_proj"], q["b_proj"], False)
    return torch.relu(h3 + skip)


# --- kernel wrappers ---------------------------------------------------------


# The plan of a csrc/direct_int8.cu launch. The kernel's geometry, which its
# C entry checks every plan against (s8::kKAlign, s8::kBM, s8::kBK;
# tests/test_torch_splitk.py reads them from the sources): K (9 * Cin)
# padded to DIRECT_INT8_K_ALIGN bytes, DIRECT_INT8_TILE x DIRECT_INT8_TILE
# output tiles, DIRECT_INT8_STEP-byte cp.async stages. The plan's own rule:
# a cooperative grid of DIRECT_INT8_BLOCKS_PER_SM blocks an SM (the entry
# refuses more than the card holds resident); K split until tiles x splits
# reach about one work item a block, in multiples of DIRECT_INT8_STEP at
# least DIRECT_INT8_MIN_CHUNK long (tuned on the served shapes by
# tools/chip_split_sweep.py); workspace parts start at multiples of
# WORKSPACE_ALIGN words.
DIRECT_INT8_K_ALIGN = 32
DIRECT_INT8_TILE = 64
DIRECT_INT8_STEP = 64
DIRECT_INT8_BLOCKS_PER_SM = 2
DIRECT_INT8_MIN_CHUNK = 128
WORKSPACE_ALIGN = 64


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class DirectInt8Workspace(NamedTuple):
    """Where csrc/direct_int8.cu's parts lie in its workspace, in 4-byte
    words: the grid barrier at 0, the row scales at `sx`, the quantized rows
    at `aq`, the transposed weights at `bt`, the int32 partial sums at
    `part`; `words` in all."""

    sx: int
    aq: int
    bt: int
    part: int
    words: int


def _mma_int8_workspace(p: int, kp: int, cout: int, splits: int) -> DirectInt8Workspace:
    """The layout of a cooperative launch on csrc/mma_int8.cuh: the grid
    barrier, p row scales, the (p, kp) quantized rows, the (cout, kp)
    transposed weights, and splits x p x cout int32 partial sums past one
    split, each part at a multiple of WORKSPACE_ALIGN."""
    sx = WORKSPACE_ALIGN
    aq = sx + _round_up(p, WORKSPACE_ALIGN)
    bt = aq + _round_up(p * kp // 4, WORKSPACE_ALIGN)
    part = bt + _round_up(cout * kp // 4, WORKSPACE_ALIGN)
    return DirectInt8Workspace(sx, aq, bt, part, part + (splits * p * cout if splits > 1 else 0))


class DirectInt8Plan(NamedTuple):
    """How csrc/direct_int8.cu runs one conv: the padded K, the output
    tiles, the cooperative grid's blocks and the K split."""

    kp: int
    tiles: int
    blocks: int
    splits: int
    chunk: int

    def workspace(self, p: int, cout: int) -> DirectInt8Workspace:
        return _mma_int8_workspace(p, self.kp, cout, self.splits)

    def workspace_words(self, p: int, cout: int) -> int:
        return self.workspace(p, cout).words


def direct_int8_plan(n: int, h: int, w: int, cin: int, cout: int,
                     sms: int = H100_SMS) -> DirectInt8Plan:
    """The grid and K split of an (n, h, w, cin) -> cout int8 3x3 on a card
    with `sms` SMs."""
    p, kp = n * h * w, _round_up(9 * cin, DIRECT_INT8_K_ALIGN)
    tiles = -(-p // DIRECT_INT8_TILE) * -(-cout // DIRECT_INT8_TILE)
    blocks = DIRECT_INT8_BLOCKS_PER_SM * sms
    split = split_k(kp, blocks // tiles, DIRECT_INT8_STEP, DIRECT_INT8_MIN_CHUNK)
    return DirectInt8Plan(kp, tiles, blocks, split.splits, split.chunk)


class TransitionInt8Plan(NamedTuple):
    """How csrc/transition_int8.cu runs one transition: the padded K of its
    operands (kpr: Cin, the reduce's and the projection's; kpm: 9 * Cmid,
    the mid's; kpe: Cmid, the expand's), the cooperative grid's blocks, and
    the K split of each product. The last phase's expand and projection
    split apart, into slots of their own."""

    kpr: int
    kpm: int
    kpe: int
    blocks: int
    reduce: Split
    mid: Split
    expand: Split
    proj: Split

    def args(self) -> tuple:
        """The plan as the C entry takes it: blocks, then (splits, chunk) of
        the reduce, the mid, the expand and the projection."""
        return (self.blocks,) + self.reduce + self.mid + self.expand + self.proj


# The int8 transition's splits are at least this long: each split of one
# of its five products costs a partial-sum pass and a grid barrier, and
# tools/chip_split_sweep.py found 128-long ones slower at the served N=1
# shapes (PERF.md).
TRANSITION_INT8_MIN_CHUNK = 256


def transition_int8_plan(n: int, h: int, w: int, cin: int, cmid: int, cout: int,
                         sms: int = H100_SMS) -> TransitionInt8Plan:
    """The grid and K splits of an (n, h, w, cin) -> cmid -> cout int8
    transition on a card with `sms` SMs: csrc/mma_int8.cuh's geometry as in
    direct_int8_plan, DIRECT_INT8_BLOCKS_PER_SM blocks an SM, splits at
    least TRANSITION_INT8_MIN_CHUNK long. The reduce and the mid split K
    until tiles x splits reach about one item a block. The last phase
    shares the blocks left per output tile between its two products in
    proportion to their K; with one range each, a block runs both products
    of a tile and needs no partial sums."""
    p1, p2 = n * h * w, n * -(-h // 2) * -(-w // 2)
    kpr, kpm, kpe = (_round_up(k, DIRECT_INT8_K_ALIGN) for k in (cin, 9 * cmid, cmid))
    blocks = DIRECT_INT8_BLOCKS_PER_SM * sms

    def tiles(p: int, cols: int) -> int:
        return -(-p // DIRECT_INT8_TILE) * -(-cols // DIRECT_INT8_TILE)

    def split(k: int, want: int) -> Split:
        return split_k(k, want, DIRECT_INT8_STEP, TRANSITION_INT8_MIN_CHUNK)

    slots = blocks // tiles(p2, cout)
    expand = split(kpe, min(round(slots * kpe / (kpe + kpr)), slots - 1))
    return TransitionInt8Plan(
        kpr, kpm, kpe, blocks, split(kpr, blocks // tiles(p1, cmid)),
        split(kpm, blocks // tiles(p2, cmid)), expand, split(kpr, slots - expand.splits))


# The plan of a csrc/pointwise_int8.cu launch. The kernel's geometry, which
# its C entry checks every plan against (tests/test_torch_splitk.py reads
# it from the sources): rows at or below POINTWISE_INT8_GEMV_MAX_ROWS may
# take the GEMV (blocks of POINTWISE_INT8_GEMV_COLS columns, splits in
# multiples of POINTWISE_INT8_GEMV_STEP); a padded K of at most
# POINTWISE_INT8_ONE_PASS_MAX_K may take the one-pass form (one block a
# 64 x 64 tile); any shape the cooperative form, on the direct_int8 plan's
# geometry. The plan's own rule: the GEMV at P <= 8, its K split until its
# column tiles x splits reach about one block an SM, in ranges at least
# POINTWISE_INT8_GEMV_MIN_CHUNK long; else the one-pass form where the
# padded K fits it, and the cooperative form for longer K, split as
# direct_int8_plan splits (the routes were timed against each other at the
# served shapes by tools/chip_split_sweep.py, PERF.md).
POINTWISE_INT8_GEMV_MAX_ROWS = 8
POINTWISE_INT8_GEMV_COLS = 128
POINTWISE_INT8_GEMV_STEP = 32
POINTWISE_INT8_GEMV_MIN_CHUNK = 64
POINTWISE_INT8_ONE_PASS_MAX_K = 256
POINTWISE_INT8_PATHS = ("gemv", "one_pass", "cooperative")  # the C entry's numbering


class PointwiseInt8Plan(NamedTuple):
    """How csrc/pointwise_int8.cu runs one (P, K) x (K, N) product: the
    path, the padded K (K itself for the GEMV), the output tiles' width and
    count, the grid's blocks and the K split."""

    path: str
    kp: int
    tile: int
    tiles: int
    blocks: int
    splits: int
    chunk: int

    def workspace(self, p: int, n: int) -> DirectInt8Workspace:
        """The cooperative form's layout (_mma_int8_workspace); for the GEMV
        past one split, its column tiles' counters from word 0 (room rounded
        up to COUNTER_WORDS) and the int32 partial sums at `part`; nothing
        else."""
        if self.path == "cooperative":
            return _mma_int8_workspace(p, self.kp, n, self.splits)
        if self.path == "gemv" and self.splits > 1:
            part = _round_up(self.tiles, COUNTER_WORDS)
            return DirectInt8Workspace(0, 0, 0, part, part + self.splits * p * n)
        return DirectInt8Workspace(0, 0, 0, 0, 0)

    def args(self) -> tuple:
        """The plan as the C entry takes it: path, Kp, tile, blocks, splits,
        chunk."""
        return (POINTWISE_INT8_PATHS.index(self.path), self.kp, self.tile, self.blocks,
                self.splits, self.chunk)


def pointwise_int8_plan(p: int, k: int, n: int, sms: int = H100_SMS,
                        path: str | None = None) -> PointwiseInt8Plan:
    """The path, grid and K split of a (p, k) x (k, n) int8 product (k a
    multiple of 4) on a card with `sms` SMs; `path` forces a path that
    takes the shape (tools/chip_split_sweep.py times the others)."""
    kp = _round_up(k, DIRECT_INT8_K_ALIGN)
    if path is None:
        path = ("gemv" if p <= POINTWISE_INT8_GEMV_MAX_ROWS
                else "one_pass" if kp <= POINTWISE_INT8_ONE_PASS_MAX_K else "cooperative")
    if (path not in POINTWISE_INT8_PATHS or path == "gemv" and p > POINTWISE_INT8_GEMV_MAX_ROWS
            or path == "one_pass" and kp > POINTWISE_INT8_ONE_PASS_MAX_K):
        raise ValueError(f"path {path!r} does not take a ({p}, {k}) x ({k}, {n}) product")
    if path == "gemv":
        tiles = -(-n // POINTWISE_INT8_GEMV_COLS)
        split = split_k(k, sms // tiles, POINTWISE_INT8_GEMV_STEP, POINTWISE_INT8_GEMV_MIN_CHUNK)
        return PointwiseInt8Plan(path, k, POINTWISE_INT8_GEMV_COLS, tiles, tiles * split.splits,
                                 split.splits, split.chunk)
    tiles = -(-p // DIRECT_INT8_TILE) * -(-n // DIRECT_INT8_TILE)
    if path == "one_pass":
        return PointwiseInt8Plan(path, kp, DIRECT_INT8_TILE, tiles, tiles, 1, kp)
    blocks = DIRECT_INT8_BLOCKS_PER_SM * sms
    split = split_k(kp, blocks // tiles, DIRECT_INT8_STEP, DIRECT_INT8_MIN_CHUNK)
    return PointwiseInt8Plan(path, kp, DIRECT_INT8_TILE, tiles, blocks, split.splits, split.chunk)


# The plan of a csrc/winograd_int8.cu launch. The kernel's geometry, which
# its C entry checks every plan against (tests/test_torch_splitk.py reads it
# from the source): a work item is WINO_INT8_TILES Winograd tiles by
# WINO_INT8_COLS output channels at one position, the items are dealt to a
# resident cooperative grid of at most WINO_INT8_BLOCKS_PER_SM blocks an SM,
# and the padded Cin is a multiple of DIRECT_INT8_K_ALIGN. An item stages K
# in spans of the plan's chunk: the padded Cin itself up to
# WINO_INT8_CHUNK, past it spans of WINO_INT8_CHUNK (a multiple of the
# scale group WINO_INT8_GROUP), so a block's shared memory
# (winograd_int8_smem) stops growing with Cin and two blocks an SM fit at
# any Cin.
WINO_INT8_TILES = 16
WINO_INT8_COLS = 128
WINO_INT8_BLOCKS_PER_SM = 2
WINO_INT8_PAD = 16
WINO_INT8_CHUNK = 512
H100_SMEM_PER_SM = 233472     # bytes of shared memory an SM holds (228 KB)
H100_SMEM_PER_BLOCK = 232448  # the most one block may take (227 KB)
SMEM_RESERVED_PER_BLOCK = 1024


def wino_int8_groups(cin: int, cout: int) -> int:
    """The int8 Winograd's row-scale groups: one in the stash branch, else
    Cin / WINO_INT8_GROUP where that divides Cin, else one."""
    return 1 if wino_int8_stash(cout) or cin % WINO_INT8_GROUP else cin // WINO_INT8_GROUP


def winograd_int8_smem(chunk: int, groups: int) -> int:
    """Bytes of shared memory a block of csrc/winograd_int8.cu takes (its
    Layout) for spans of `chunk` of K holding `groups` scale groups: V of
    the item's rows in f32, the rows and weight columns quantized (rows of
    chunk + WINO_INT8_PAD bytes), the rows' scales."""
    ld = chunk + WINO_INT8_PAD
    scales = -(-WINO_INT8_TILES * groups * 4 // 16) * 16
    return WINO_INT8_TILES * chunk * 4 + (WINO_INT8_TILES + WINO_INT8_COLS) * ld + scales


class WinogradInt8Plan(NamedTuple):
    """How csrc/winograd_int8.cu runs one conv: the padded Cin, the K an
    item stages at once, the map's Winograd tiles, the items' tile and
    column blocks, and the cooperative grid's blocks."""

    kp: int
    chunk: int
    tiles: int
    tile_blocks: int
    col_blocks: int
    blocks: int

    def items(self) -> int:
        """Work items: 16 positions x tile blocks x column blocks."""
        return 16 * self.tile_blocks * self.col_blocks

    def workspace_words(self, cout: int) -> int:
        """The grid barrier and M (16, tiles, cout) in f32 from word
        WORKSPACE_ALIGN."""
        return WORKSPACE_ALIGN + 16 * self.tiles * cout

    def smem(self, cin: int, cout: int) -> int:
        """Bytes of shared memory a block takes: a span's scale groups are
        one where a scale covers the whole row, else chunk / WINO_INT8_GROUP."""
        groups = wino_int8_groups(cin, cout)
        return winograd_int8_smem(self.chunk, 1 if groups == 1 else self.chunk // WINO_INT8_GROUP)

    def args(self) -> tuple:
        """The plan as the C entry takes it: Kp, an item's tiles and
        columns, the chunk, blocks."""
        return (self.kp, WINO_INT8_TILES, WINO_INT8_COLS, self.chunk, self.blocks)


def winograd_int8_plan(n: int, h: int, w: int, cin: int, cout: int,
                       sms: int = H100_SMS) -> WinogradInt8Plan:
    """The work items, span and grid of an (n, h, w, cin) -> cout int8
    F(2,3) on a card with `sms` SMs: one block an item, at most a resident
    wave of WINO_INT8_BLOCKS_PER_SM blocks an SM (fewer where their shared
    memory does not fit), K staged in spans of at most WINO_INT8_CHUNK."""
    kp = _round_up(cin, DIRECT_INT8_K_ALIGN)
    tiles = n * -(-h // 2) * -(-w // 2)
    tile_blocks, col_blocks = -(-tiles // WINO_INT8_TILES), -(-cout // WINO_INT8_COLS)
    plan = WinogradInt8Plan(kp, min(kp, WINO_INT8_CHUNK), tiles, tile_blocks, col_blocks, 0)
    per_sm = min(WINO_INT8_BLOCKS_PER_SM,
                 H100_SMEM_PER_SM // (plan.smem(cin, cout) + SMEM_RESERVED_PER_BLOCK))
    return plan._replace(blocks=min(plan.items(), per_sm * sms))


# The int8 kernels pack four k to a 32-bit word and take channel counts that
# are multiples of 4. The wrappers pad any other count with zero channels
# before they dispatch: zero input channels and zero weight rows; a padded
# output channel gets a zero weight column, a zero weight scale and a zero
# BN scale and bias. A zero column changes neither a row's max|a| nor its
# int32 sum, and a padded output channel ends as relu(0) = 0 (plus a zero
# residual), so the padded call gives the unpadded one's bits, and the
# wrappers slice the padded channels off. Counts that are multiples of 4
# (every served width) are passed through untouched.


def ceil4(c: int) -> int:
    return -(-c // 4) * 4


def pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """t zero-padded at the end of `dim` to `size` (t itself when it already is)."""
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    return F.pad(t, [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, extra])


def pad_windows(w9: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """(..., 9 * Ci, Co) im2col weights (direct_filter's row order) to
    (..., 9 * cin, cout): zero rows for each window's padded channels, zero
    columns for the padded outputs."""
    *lead, k, co = w9.shape
    w = w9.reshape(*lead, 9, k // 9, co)
    return pad_to(pad_to(w, -2, cin), -1, cout).reshape(*lead, 9 * cin, cout)


def _pad_keys(q: Dict, keys, dim: int, size: int) -> None:
    for key in keys:
        q[key] = pad_to(q[key], dim, size)


def pad_stage_int8(q: Dict, cio: int, cmid: int) -> Dict:
    """quantize_stage_params' stack padded to cio and cmid channels."""
    q = dict(q)
    _pad_keys(q, ("w_reduce_s", "s_reduce", "b_reduce", "w9_mid_s", "s_mid", "b_mid"), 2, cmid)
    _pad_keys(q, ("w_expand_s", "s_expand", "b_expand"), 2, cio)
    q["w_reduce_q"] = pad_to(pad_to(q["w_reduce_q"], 1, cio), 2, cmid)
    q["w_expand_q"] = pad_to(pad_to(q["w_expand_q"], 1, cmid), 2, cio)
    q["w9_mid_q"] = pad_windows(q["w9_mid_q"], cmid, cmid)
    if "u2_mid_bf16" in q:
        q["u2_mid_bf16"] = pad_to(pad_to(q["u2_mid_bf16"], 2, cmid), 3, cmid)
    return q


def pad_transition_int8(q: Dict, cin: int, cmid: int) -> Dict:
    """quantize_transition_params' weights padded to cin and cmid channels
    (Cout is the GEMMs' N and needs none)."""
    q = dict(q)
    _pad_keys(q, ("w_reduce_s", "s_reduce", "b_reduce", "w9_mid_s", "s_mid", "b_mid"), 0, cmid)
    q["w_reduce_q"] = pad_to(pad_to(q["w_reduce_q"], 0, cin), 1, cmid)
    q["w_proj_q"] = pad_to(q["w_proj_q"], 0, cin)
    q["w9_mid_q"] = pad_windows(q["w9_mid_q"], cmid, cmid)
    q["w_expand_q"] = pad_to(q["w_expand_q"], 0, cmid)
    return q


def _check_shapes(pairs) -> None:
    for name, t, shape in pairs:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(t.shape)}, want {tuple(shape)}")


@functools.lru_cache(maxsize=None)
def _workspace_words(name: str, entry: str, device_index: int, *dims) -> int:
    """4-byte words of workspace the C entry `entry` of library `name` needs
    for these dims on the device (its `<entry>_workspace` function)."""
    lib = _build.library(name)
    words = ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        err = getattr(lib, f"{entry}_workspace")(*map(_build.cint, dims), ctypes.byref(words))
    _build.check_error(lib, f"{entry}_workspace", err)
    return words.value


@_build.checked("pointwise_int8")
def conv1x1_bn_int8(x, w_q, s_w, scale, bias, relu: bool) -> torch.Tensor:
    """Int8 pointwise conv + BN (+ReLU).

    x: (..., Cin) float32; w_q: (Cin, Cout) int8; s_w, scale, bias: (Cout,).
    Returns x.shape[:-1] + (Cout,). Any Cin (padded to a multiple of 4, see
    pad_to). CPU tensors run the plain version; CUDA tensors launch
    csrc/pointwise_int8.cu."""
    cin, cout = w_q.shape
    if x.shape[-1] != cin:
        raise ValueError(f"x channels {x.shape[-1]} != weight Cin {cin}")
    if cin % 4:
        cin = ceil4(cin)
        x, w_q = pad_to(x, -1, cin), pad_to(w_q, 0, cin)
    if x.device.type == "cpu":
        return conv1x1_bn_int8_plain(x, w_q, s_w, scale, bias, relu)
    _build.check_operands(scale, bias, cout, x, s_w)
    _check_shapes([("s_w", s_w, (cout,))])
    _build.check_tensors(w_q, dtype=torch.int8, device=x.device)
    p = x.numel() // cin
    return conv1x1_bn_int8_planned(x, w_q, s_w, scale, bias, relu,
                                   pointwise_int8_plan(p, cin, cout, _build.sm_count(x.device)))


def conv1x1_bn_int8_planned(x, w_q, s_w, scale, bias, relu: bool,
                            plan: PointwiseInt8Plan) -> torch.Tensor:
    """conv1x1_bn_int8's launch on CUDA tensors under an explicit plan (the
    wrapper passes pointwise_int8_plan's; tools/chip_split_sweep.py times
    others). Cin a multiple of 4; operands as conv1x1_bn_int8 checks them."""
    cin, cout = w_q.shape
    p = x.numel() // cin
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads rows as float4s
    at = plan.workspace(p, cout)
    ws = torch.empty(at.words, device=x.device, dtype=torch.float32) if at.words else None
    out = torch.empty(*x.shape[:-1], cout, device=x.device, dtype=torch.float32)
    ptr, c, ll = _build.ptr, _build.cint, ctypes.c_longlong
    _build.launch(
        "pointwise_int8", "pointwise_int8_conv1x1_bn", (p, cin, cout, bool(relu)), x.device,
        ptr(x), ptr(w_q), ptr(s_w), ptr(scale), ptr(bias), ptr(out),
        ptr(ws) if ws is not None else ctypes.c_void_p(0), ll(at.words), ll(at.sx), ll(at.aq),
        ll(at.bt), ll(at.part), c(p), c(cin), c(cout), c(relu), *map(c, plan.args()),
    )
    return out


@_build.checked("direct_int8")
def conv3x3_bn_int8(x, w9_q, s_w9, scale, bias, relu: bool = True) -> torch.Tensor:
    """Int8 3x3 conv (pad 1, stride 1) + BN (+ReLU), per-im2col-row scales.

    x: (H, W, Cin) or (N, H, W, Cin) float32; w9_q: (9*Cin, Cout) int8 in
    kernels/direct.py::direct_filter's row order; s_w9, scale, bias:
    (Cout,). Any Cin (padded to a multiple of 4, see pad_to). CPU tensors
    run the plain version; CUDA tensors launch csrc/direct_int8.cu."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, cin = x.shape
    if w9_q.shape[0] != 9 * cin:
        raise ValueError(f"w9_q {tuple(w9_q.shape)} does not take {cin} input channels")
    cout = w9_q.shape[1]
    if cin % 4:
        cin = ceil4(cin)
        x, w9_q = pad_to(x, -1, cin), pad_windows(w9_q, cin, cout)
    if x.device.type == "cpu":
        out = conv3x3_bn_int8_plain(x, w9_q, s_w9, scale, bias, relu)
    else:
        _build.check_operands(scale, bias, cout, x, s_w9)
        _check_shapes([("s_w9", s_w9, (cout,))])
        _build.check_tensors(w9_q, dtype=torch.int8, device=x.device)
        out = conv3x3_bn_int8_planned(
            x, w9_q, s_w9, scale, bias, relu,
            direct_int8_plan(n, h, w, cin, cout, _build.sm_count(x.device)))
    return out[0] if squeeze else out


def conv3x3_bn_int8_planned(x, w9_q, s_w9, scale, bias, relu: bool,
                            plan: DirectInt8Plan) -> torch.Tensor:
    """conv3x3_bn_int8's launch on CUDA tensors under an explicit plan (the
    wrapper passes direct_int8_plan's; tools/chip_split_sweep.py times
    others). x: (N, H, W, Cin); operands as conv3x3_bn_int8 checks them."""
    n, h, w, cin = x.shape
    cout = w9_q.shape[1]
    at = plan.workspace(n * h * w, cout)
    ws = torch.empty(at.words, device=x.device, dtype=torch.float32)
    out = torch.empty(n, h, w, cout, device=x.device, dtype=torch.float32)
    ptr, c, ll = _build.ptr, _build.cint, ctypes.c_longlong
    _build.launch(
        "direct_int8", "direct_int8_conv3x3_bn", (n, h, w, cin, cout, bool(relu)),
        x.device, ptr(x), ptr(w9_q), ptr(s_w9), ptr(scale), ptr(bias), ptr(out),
        ptr(ws), ll(at.words), ll(at.sx), ll(at.aq), ll(at.bt), ll(at.part),
        c(n), c(h), c(w), c(cin), c(cout), c(relu), c(plan.kp), c(DIRECT_INT8_TILE),
        c(plan.blocks), c(plan.splits), c(plan.chunk),
    )
    return out


@_build.checked("winograd_int8")
def conv3x3_bn_winograd_int8(x, u_q, s_u, scale, bias, relu: bool = True) -> torch.Tensor:
    """Int8 3x3 conv (pad 1, stride 1) + BN (+ReLU) by Winograd F(2,3).

    x: (H, W, Cin) or (N, H, W, Cin) float32; u_q (16, Cin, Cout) int8 and
    s_u (16, Cout) from quantize_winograd_filter(transform_filter(w, m=2));
    scale, bias: (Cout,). Cout above 128 must be a multiple of 128; any Cin
    (past WINO_INT8_CHUNK the kernel walks it in spans). CPU tensors run
    the plain version; CUDA tensors launch csrc/winograd_int8.cu."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, cin = x.shape
    if u_q.shape[0] != 16 or u_q.shape[1] != cin:
        raise ValueError(f"u_q {tuple(u_q.shape)} is not an F(2,3) filter for {cin} channels")
    cout = u_q.shape[2]
    if x.device.type == "cpu":
        out = conv3x3_bn_winograd_int8_plain(x, u_q, s_u, scale, bias, relu)
    else:
        _build.check_operands(scale, bias, cout, x, s_u)
        _check_shapes([("s_u", s_u, (16, cout))])
        _build.check_tensors(u_q, dtype=torch.int8, device=x.device)
        out = conv3x3_bn_winograd_int8_planned(
            x, u_q, s_u, scale, bias, relu,
            winograd_int8_plan(n, h, w, cin, cout, _build.sm_count(x.device)))
    return out[0] if squeeze else out


def conv3x3_bn_winograd_int8_planned(x, u_q, s_u, scale, bias, relu: bool,
                                     plan: WinogradInt8Plan) -> torch.Tensor:
    """conv3x3_bn_winograd_int8's launch on CUDA tensors under an explicit
    plan (the wrapper passes winograd_int8_plan's; tools/chip_split_sweep.py
    times other grids). x: (N, H, W, Cin); operands as
    conv3x3_bn_winograd_int8 checks them."""
    n, h, w, cin = x.shape
    cout = u_q.shape[2]
    words = plan.workspace_words(cout)
    ws = torch.empty(words, device=x.device, dtype=torch.float32)
    out = torch.empty(n, h, w, cout, device=x.device, dtype=torch.float32)
    ptr, c = _build.ptr, _build.cint
    _build.launch(
        "winograd_int8", "winograd_int8_conv3x3_bn", (n, h, w, cin, cout, bool(relu)),
        x.device, ptr(x), ptr(u_q), ptr(s_u), ptr(scale), ptr(bias), ptr(out),
        ptr(ws), ctypes.c_longlong(words), c(n), c(h), c(w), c(cin), c(cout),
        c(wino_int8_stash(cout)), c(relu), *map(c, plan.args()),
    )
    return out


@_build.checked("stage_int8")
def resnet_stage_int8(x, qstacked: Dict, mid_algo: str = "auto") -> torch.Tensor:
    """B int8 identity bottleneck blocks in one launch.

    x: (H, W, Cio) or (N, H, W, Cio) float32; qstacked from
    quantize_stage_params (B = 1 is one block). mid_algo: "direct" (int8
    w9_mid), "winograd2" (F(2,3) on u2_mid_bf16) or "auto"
    (resolve_mid_algo). The JAX package's block-outer resident layout needs
    no option here: the CUDA kernel reads each block's weights once for the
    whole batch. Any Cio and Cmid (padded to multiples of 4, see pad_to).
    CPU tensors run the plain version; CUDA tensors launch
    csrc/stage_int8.cu."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    cio_x = x.shape[-1]
    q = qstacked
    nb, cio_w, cmid = q["w_reduce_q"].shape
    if cio_w != cio_x:
        raise ValueError(f"w_reduce_q {tuple(q['w_reduce_q'].shape)} does not take {cio_x} channels")
    mid_algo = resolve_mid_algo(mid_algo, q, x.shape[1], x.shape[2])
    groups = expand_groups(cmid, mid_algo)
    if cio_x % 4 or cmid % 4:
        x = pad_to(x, -1, ceil4(cio_x))
        q = pad_stage_int8(q, ceil4(cio_x), ceil4(cmid))
        cmid = ceil4(cmid)
    if x.device.type == "cpu":
        out = resnet_stage_int8_plain(x, q, mid_algo, groups)
    else:
        out = _stage_int8_launch(x, q, mid_algo, groups)
    if out.shape[-1] != cio_x:
        out = out[..., :cio_x].contiguous()
    return out[0] if squeeze else out


def _stage_int8_launch(x, q: Dict, mid_algo: str, groups: int) -> torch.Tensor:
    """resnet_stage_int8's launch on CUDA tensors; channels multiples of 4."""
    n, h, w, cio = x.shape
    nb, _, cmid = q["w_reduce_q"].shape
    wino = mid_algo == "winograd2"
    mid_key, mid_shape, mid_dtype = (
        ("u2_mid_bf16", (nb, 16, cmid, cmid), torch.bfloat16) if wino
        else ("w9_mid_q", (nb, 9 * cmid, cmid), torch.int8))
    row_m, row_o = (nb, 1, cmid), (nb, 1, cio)
    f32 = [("x", x, x.shape)] + [
        (k, q[k], s) for k, s in (
            ("w_reduce_s", row_m), ("s_reduce", row_m), ("b_reduce", row_m),
            ("w9_mid_s", row_m), ("s_mid", row_m), ("b_mid", row_m),
            ("w_expand_s", row_o), ("s_expand", row_o), ("b_expand", row_o))]
    int8 = [("w_reduce_q", q["w_reduce_q"], (nb, cio, cmid)),
            ("w_expand_q", q["w_expand_q"], (nb, cmid, cio))]
    _check_shapes(f32 + int8 + [(mid_key, q[mid_key], mid_shape)])
    _build.check_tensors(*(t for _, t, _ in f32))
    _build.check_tensors(*(t for _, t, _ in int8), dtype=torch.int8, device=x.device)
    _build.check_tensors(q[mid_key], dtype=mid_dtype, device=x.device)
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads rows as float4s
    words = _workspace_words("stage_int8", "resnet_stage_int8", x.device.index,
                             n, h, w, cio, cmid, nb, int(wino), groups)
    ws = torch.empty(words, device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    ptr, c = _build.ptr, _build.cint
    _build.launch(
        "stage_int8", "resnet_stage_int8", (n, h, w, cio, cmid, nb, mid_algo), x.device,
        ptr(x), ptr(q["w_reduce_q"]), ptr(q["w_reduce_s"]), ptr(q["s_reduce"]),
        ptr(q["b_reduce"]), ptr(q[mid_key]), ptr(q["w9_mid_s"]), ptr(q["s_mid"]),
        ptr(q["b_mid"]), ptr(q["w_expand_q"]), ptr(q["w_expand_s"]), ptr(q["s_expand"]),
        ptr(q["b_expand"]), ptr(out), ptr(ws), ctypes.c_longlong(words),
        c(n), c(h), c(w), c(cio), c(cmid), c(nb), c(wino), c(groups),
    )
    return out


@_build.checked("transition_int8")
def transition_block_int8(x, qparams: Dict) -> torch.Tensor:
    """Int8 stride-2 transition block in one launch. x: (H, W, Cin) or
    (N, H, W, Cin) float32; qparams from quantize_transition_params.
    Returns (..., ceil(H/2), ceil(W/2), Cout). The JAX package's tile-outer
    resident layout needs no option here: the kernel reads each weight once
    for the whole batch. Any Cin and Cmid (padded to multiples of 4, see
    pad_to). CPU tensors run the plain version; CUDA tensors launch
    csrc/transition_int8.cu."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, cin = x.shape
    q = qparams
    cin_w, cmid = q["w_reduce_q"].shape
    if cin_w != cin:
        raise ValueError(f"w_reduce_q {tuple(q['w_reduce_q'].shape)} does not take {cin} channels")
    if cin % 4 or cmid % 4:
        cin, cmid = ceil4(cin), ceil4(cmid)
        x, q = pad_to(x, -1, cin), pad_transition_int8(q, cin, cmid)
    if x.device.type == "cpu":
        out = transition_block_int8_plain(x, q)
        return out[0] if squeeze else out
    cout = q["w_expand_q"].shape[1]
    f32 = [("x", x, x.shape)] + [
        (k, q[k], (c,)) for k, c in (
            ("w_reduce_s", cmid), ("s_reduce", cmid), ("b_reduce", cmid),
            ("w9_mid_s", cmid), ("s_mid", cmid), ("b_mid", cmid),
            ("w_expand_s", cout), ("s_expand", cout), ("b_expand", cout),
            ("w_proj_s", cout), ("s_proj", cout), ("b_proj", cout))]
    int8 = [("w_reduce_q", q["w_reduce_q"], (cin, cmid)),
            ("w9_mid_q", q["w9_mid_q"], (9 * cmid, cmid)),
            ("w_expand_q", q["w_expand_q"], (cmid, cout)),
            ("w_proj_q", q["w_proj_q"], (cin, cout))]
    _check_shapes(f32 + int8)
    _build.check_tensors(*(t for _, t, _ in f32))
    _build.check_tensors(*(t for _, t, _ in int8), dtype=torch.int8, device=x.device)
    out = transition_block_int8_planned(
        x, q, transition_int8_plan(n, h, w, cin, cmid, cout, _build.sm_count(x.device)))
    return out[0] if squeeze else out


def transition_block_int8_planned(x, q: Dict, plan: TransitionInt8Plan) -> torch.Tensor:
    """transition_block_int8's launch on CUDA tensors under an explicit plan
    (the wrapper passes transition_int8_plan's; tools/chip_split_sweep.py
    times others). x: (N, H, W, Cin); Cin and Cmid multiples of 4; operands
    as transition_block_int8 checks them."""
    n, h, w, cin = x.shape
    cmid, cout = q["w_expand_q"].shape
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads rows as float4s
    words = _workspace_words("transition_int8", "transition_block_int8", x.device.index,
                             n, h, w, cin, cmid, cout, *plan.args())
    ws = torch.empty(words, device=x.device, dtype=torch.float32)
    out = torch.empty(n, -(-h // 2), -(-w // 2), cout, device=x.device, dtype=torch.float32)
    ptr, c = _build.ptr, _build.cint
    _build.launch(
        "transition_int8", "transition_block_int8", (n, h, w, cin, cmid, cout), x.device,
        ptr(x), *(ptr(q[k]) for k in (
            "w_reduce_q", "w_reduce_s", "s_reduce", "b_reduce",
            "w9_mid_q", "w9_mid_s", "s_mid", "b_mid",
            "w_expand_q", "w_expand_s", "s_expand", "b_expand",
            "w_proj_q", "w_proj_s", "s_proj", "b_proj")),
        ptr(out), ptr(ws), ctypes.c_longlong(words),
        c(n), c(h), c(w), c(cin), c(cmid), c(cout), *map(c, plan.args()),
    )
    return out
