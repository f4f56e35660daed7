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
arithmetic and csrc/wgmma_s8.cuh's s8 wgmma, the int8 pointwise's one pass
on csrc/mma_int8.cuh's s8 mma.sync; every one takes any channel count, see
pad_to):

* conv1x1_bn_int8 -> csrc/pointwise_int8.cu (_quant_matmul_kernel): a
  GEMV at a few rows, else s8 wgmma tiles whose K splits are the blocks of
  one thread-block cluster (each row's scale from the maxima its blocks
  exchange through distributed shared memory, the int32 partials added
  there too), or one pass a tile on s8 mma.sync, the path and split by
  pointwise_int8_plan;
* conv3x3_bn_int8 -> csrc/direct_int8.cu (_direct_int8_kernel and its
  row-banded twin): the int8 pointwise's cluster kernel
  (csrc/wgmma_s8_cluster.cuh) on the implicit im2col rows, each row's scale
  from the maxima its cluster's blocks exchange, the tile and K split by
  direct_int8_plan (the pointwise's cluster rule);
* resnet_stage_int8 -> csrc/stage_int8.cu (_stage_int8_kernel, its
  resident twin, and _block_int8_kernel at one block) on s8 wgmma tiles
  that quantize their rows as they stage them, each row's scale from the
  maxima its producers published (the folded quantization, below); the
  mid-layer is the int8 direct 3x3 or, on maps of 28x28 and up, F(2,3) on
  bf16 filters; the grid and splits by stage_int8_plan;
* transition_block_int8 -> csrc/transition_int8.cu (_transition_int8_kernel
  and its resident twin): the int8 stage's folded phases on s8 wgmma (x's
  rows quantized by the reduce's blocks, the mid's and the expand's rows
  from published maxima, the projection reading x's quantized rows), the
  weights' k-contiguous copies made once (transition_int8_kmajor), the
  grid and the phases' K splits by transition_int8_plan;
* conv3x3_bn_winograd_int8 -> csrc/winograd_int8.cu (_winograd_int8_kernel):
  F(2,3) with V quantized per row (a 4x4 tile at one of its 16 positions)
  and per-position filter scales (quantize_winograd_filter); work items of
  8 x 128, 16 x 128 or 32 x 256 tiles by output channels over all 16 positions, one
  thread-block cluster each (a position a warpgroup: V transformed and
  quantized once, the products on s8 wgmma), the inverse from the
  cluster's shared memory, the item shape and grid by winograd_int8_plan.

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

from winograd_tpu_torch.kernels import _build, transforms
from winograd_tpu_torch.kernels import pointwise as pw
from winograd_tpu_torch.kernels.direct import im2col3x3
from winograd_tpu_torch.kernels.splitk import H100_SMS, Split, pow2_split, split_k
from winograd_tpu_torch.kernels.stage import WINOGRAD_MIN_PIXELS
from winograd_tpu_torch.kernels.transition import strided_im2col
from winograd_tpu_torch.kernels.winograd import (
    _apply_const, winograd2_mid_plain, winograd_fp64_plan,
)

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


# The int8 transition's and basic stage's weights as their s8 wgmma tiles
# read them: s8 wgmma takes both operands K-major and TMA cannot transpose
# bytes, so the kernels read a k-contiguous copy (..., N, Kp) of each
# (..., K, N) matrix w_q, zero past K, Kp = K padded to the kernel's
# alignment. The copy is made at a weight's first launch (a plain
# transpose, before it) and kept on the weight tensor itself for as long as
# it lives: a served forward's first, eager call makes them, its captured
# graph replays none of it.
TRANSITION_INT8_WEIGHTS = ("w_reduce", "w9_mid", "w_expand", "w_proj")


def kmajor_int8(w_q: torch.Tensor, align: int) -> torch.Tensor:
    """(..., K, N) int8 -> (..., N, Kp) int8, k-contiguous, zero past K, Kp =
    K padded to a multiple of `align`."""
    *lead, k, n = w_q.shape
    out = torch.zeros(*lead, n, _round_up(k, align), dtype=torch.int8, device=w_q.device)
    out[..., :k] = w_q.transpose(-1, -2)
    return out


def kmajor_kept(w_q: torch.Tensor, align: int, prepare=None) -> torch.Tensor:
    """kmajor_int8 of w_q (of prepare(w_q) where given, e.g. a padding),
    made at the weight's first call and kept on it (as its attribute
    _kmajor_int8, with the _version it was made at: a weight changed in
    place is copied anew; an inference tensor, which keeps no version, is
    copied once)."""
    version = None if w_q.is_inference() else w_q._version
    kept = getattr(w_q, "_kmajor_int8", None)
    if kept is None or kept[0] != version:
        kept = (version, kmajor_int8(w_q if prepare is None else prepare(w_q), align))
        w_q._kmajor_int8 = kept
    return kept[1]


def transition_int8_kmajor(q: Dict) -> Dict[str, torch.Tensor]:
    """The k-contiguous copies of a quantized transition's four weight
    matrices, f"{name}_kt", each kept on its weight (kmajor_kept)."""
    return {f"{name}_kt": kmajor_kept(q[f"{name}_q"], TRANSITION_INT8_K_ALIGN)
            for name in TRANSITION_INT8_WEIGHTS}


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


# The folded quantization of csrc/stage_int8.cu, in plain PyTorch: a row's
# scale comes from a maximum that its producers published in pieces (each
# tile's epilogue folds max |y| over the values it stored of a row into one
# word, by atomicMax on the bits of |y|), not from one pass over the row.
# The bits of |v| as an integer order as |v| does, with a NaN above every
# number, so the folded maximum is torch.amax's, NaN and inf included.


def abs_bits(x: torch.Tensor) -> torch.Tensor:
    """The float32 bits of |x| as int64: what a producer publishes."""
    return x.float().contiguous().view(torch.int32).to(torch.int64) & 0x7FFFFFFF


def max_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """The float32 value of a published maximum."""
    return bits.to(torch.int32).view(torch.float32)


def row_max_in_pieces(x: torch.Tensor, piece: int) -> torch.Tensor:
    """The row maxima of x (..., K) as bits, folded from pieces of `piece`
    columns (the tiles of the producing GEMM), each piece's maximum taken
    first."""
    parts = [abs_bits(x[..., c:c + piece]).amax(dim=-1) for c in range(0, x.shape[-1], piece)]
    return torch.stack(parts, dim=-1).amax(dim=-1)


def im2col_row_max(pixel_max: torch.Tensor) -> torch.Tensor:
    """The maxima of the pad-1 3x3 im2col rows of an (N, H, W, C) map from
    its pixels' maxima (N, H, W) as bits: the max of the nine pixels', 0
    for a tap outside the map (the zero padding)."""
    n, h, w = pixel_max.shape
    padded = F.pad(pixel_max, (1, 1, 1, 1))
    taps = [padded[:, r:r + h, s:s + w] for r in range(3) for s in range(3)]
    return torch.stack(taps, dim=-1).amax(dim=-1).reshape(n * h * w)


def strided_im2col_row_max(pixel_max: torch.Tensor) -> torch.Tensor:
    """The maxima of the stride-2 3x3 im2col rows of an (N, H, W, C) map
    (transition.py::strided_im2col's: output (oy, ox) takes the taps (2 oy +
    r - 1, 2 ox + s - 1)) from its pixels' maxima (N, H, W) as bits: the max
    of the nine taps', 0 for a tap outside the map (the zero padding). The
    int8 transition's mid scales its rows so (csrc/transition_int8.cu)."""
    n, h, w = pixel_max.shape
    ho, wo = -(-h // 2), -(-w // 2)
    padded = F.pad(pixel_max, (1, 1 + 2 * wo - w, 1, 1 + 2 * ho - h))
    taps = [padded[:, r:r + 2 * ho:2, s:s + 2 * wo:2] for r in range(3) for s in range(3)]
    return torch.stack(taps, dim=-1).amax(dim=-1).reshape(n * ho * wo)


def group_row_max(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The maxima of x (..., K) per row and group of K / groups channels as
    bits (..., groups): the grouped expand's scales."""
    return abs_bits(x.reshape(*x.shape[:-1], groups, -1)).amax(dim=-1)


def quantize_with_max(x: torch.Tensor, max_bits: torch.Tensor):
    """quantize_rows' arithmetic on a published row maximum (bits, x's
    leading shape): (q, s) with s = m / 127 (1 where 0) by true division."""
    m = max_of_bits(max_bits)[..., None].to(x.dtype)
    s = m / torch.full_like(m, 127.0)
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
    float64 over the matrices' nonzero entries only (winograd.py::
    _apply_const: a NaN in x reaches just the rows and outputs that read
    it, as in the JAX kernel), each rounded to x's dtype once; V quantized
    per (tile, position) row, per WINO_INT8_GROUP channels with the groups'
    dequantized products added in order, or over all of Cin with one int32
    sum (wino_int8_stash: scale max|V| / 127, 1 / 127 for a zero row); the
    product dequantized by (s_v * s_u). x: (N, H, W, Cin)."""
    n, h, w, cin = x.shape
    cout = u_q.shape[2]
    th, tw = -(-h // 2), -(-w // 2)
    bt, _, at = (mat.tolist() for mat in transforms.matrices(2))
    xp = F.pad(x.double(), (0, 0, 1, 2 * tw + 1 - w, 1, 2 * th + 1 - h))
    d = xp.unfold(1, 4, 2).unfold(2, 4, 2)                 # (n, th, tw, cin, 4, 4)
    v = _apply_const(bt, _apply_const(bt, d, -2), -1)      # (n, th, tw, cin, 4, 4)
    v = v.permute(0, 1, 2, 4, 5, 3).reshape(-1, 16, cin).to(x.dtype)
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
    mm = mm.double().reshape(-1, 4, 4, cout)
    y = _apply_const(at, _apply_const(at, mm, 1), 2).to(x.dtype)  # At M At^T: (t, 2, 2, cout)
    y = y.reshape(n, th, tw, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
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


# K of the int8 kernels' quantized operands is padded to this (s8::kKAlign,
# the s8 tensor cores' k step).
DIRECT_INT8_K_ALIGN = 32


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


# The plan of a csrc/transition_int8.cu launch. The kernel's geometry, which
# its C entry checks every plan against (tests/test_torch_transition_int8_plan.py
# reads it from the sources): a cooperative grid of at most
# TRANSITION_INT8_BLOCKS_PER_SM blocks an SM, each of STAGE_INT8_WARPGROUPS
# warpgroups walking work items of its own (wgmma_s8.cuh's 64 x 64 tiles),
# K padded to TRANSITION_INT8_K_ALIGN, K splits each a whole number of
# STAGE_INT8_STEP (the tile's stage) but the last, at most
# TRANSITION_INT8_MAX_SPLITS. The plan's own rule is stage_int8_plan's, per
# phase: split K only where the phase's tiles are fewer than
# 1 / STAGE_INT8_FEW_TILES of the warpgroups, and then into walks of at
# most STAGE_INT8_WALK (a split costs a grid barrier and a pass of int32
# partials through device memory); the last phase splits its expand and its
# projection each that way, or neither (one item a tile then runs both).
TRANSITION_INT8_BLOCKS_PER_SM = 1
TRANSITION_INT8_K_ALIGN = 32
TRANSITION_INT8_MAX_SPLITS = 16


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


def transition_int8_phase(kp: int, tiles: int, grid: int, max_walk: int = 0) -> Split:
    """The K split of a transition phase of `tiles` output tiles over its
    padded K kp on a grid of `grid` blocks: one range where the tiles give
    the warpgroups enough items (max_walk 0, the plan's rule), else walks of
    at most STAGE_INT8_WALK (or max_walk), each a whole number of
    STAGE_INT8_STEP but the last, at most TRANSITION_INT8_MAX_SPLITS."""
    if not max_walk:
        few = tiles * STAGE_INT8_FEW_TILES < grid * STAGE_INT8_WARPGROUPS
        max_walk = STAGE_INT8_WALK if few else kp
    splits = min(-(-kp // max_walk), kp // STAGE_INT8_STEP, TRANSITION_INT8_MAX_SPLITS)
    if splits < 2:
        return Split(1, kp)
    chunk = _round_up(-(-kp // splits), STAGE_INT8_STEP)
    return Split(-(-kp // chunk), chunk)


def transition_int8_plan(n: int, h: int, w: int, cin: int, cmid: int, cout: int,
                         sms: int = H100_SMS, max_walk: int = 0) -> TransitionInt8Plan:
    """The grid and K splits of an (n, h, w, cin) -> cmid -> cout int8
    transition (cin, cmid multiples of 4) on a card with `sms` SMs
    (max_walk: transition_int8_phase's, for every phase)."""
    p1, p2 = n * h * w, n * -(-h // 2) * -(-w // 2)
    kpr, kpm, kpe = (_round_up(k, TRANSITION_INT8_K_ALIGN) for k in (cin, 9 * cmid, cmid))
    grid = TRANSITION_INT8_BLOCKS_PER_SM * sms

    def tiles(p: int, cols: int) -> int:
        return -(-p // STAGE_INT8_TILE_M) * -(-cols // STAGE_INT8_TILE_N)

    last = tiles(p2, cout)
    return TransitionInt8Plan(
        kpr, kpm, kpe, grid, transition_int8_phase(kpr, tiles(p1, cmid), grid, max_walk),
        transition_int8_phase(kpm, tiles(p2, cmid), grid, max_walk),
        transition_int8_phase(kpe, last, grid, max_walk),
        transition_int8_phase(kpr, last, grid, max_walk))


# The plan of a csrc/pointwise_int8.cu launch. The kernel's geometry, which
# its C entry checks every plan against (tests/test_torch_splitk.py reads
# it from the sources): rows at or below POINTWISE_INT8_GEMV_MAX_ROWS may
# take the GEMV (csrc/gemv_cluster.cuh's form, shared with csrc/pointwise.cu:
# column tiles POINTWISE_INT8_GEMV_COLS or half of it wide, a power of two
# of K splits in multiples of POINTWISE_INT8_GEMV_STEP, at most
# pointwise.py::GEMV_CLUSTER_MAX, one cluster); a padded K of at most
# POINTWISE_INT8_ONE_PASS_MAX_K may take the one-pass form (one block a
# 64 x 64 tile on s8 mma.sync); any shape the cluster form (s8 wgmma tiles
# of 64 rows by POINTWISE_INT8_CLUSTER_COLS columns, K padded to
# DIRECT_INT8_K_ALIGN, a tile's K splits the blocks of one cluster: at most
# POINTWISE_INT8_CLUSTER_MAX, each a multiple of POINTWISE_INT8_CLUSTER_STEP
# but the last). No path takes a workspace. The plan's own rule, from the
# paths, widths and splits timed against each other at the served shapes
# (tools/chip_split_sweep.py, PERF.md): the GEMV for the heads (P at most
# POINTWISE_INT8_GEMV_MAX_ROWS, K at least POINTWISE_INT8_GEMV_MIN_K) under
# pointwise.py::gemv_split's rule; the one pass where its K fits and the
# rows are many (at least POINTWISE_INT8_ONE_PASS_ROWS: its tiles then
# fill the card without a split), unless N passes 128 over more than
# POINTWISE_INT8_ONE_PASS_WIDE_ROWS rows (there its 64-column tiles read x
# four times or more, the cluster path's 128-column tiles half as often);
# else the cluster path, 128 columns wide where N passes 64 and those tiles
# times their most splits reach half the SMs (else 64), its K split until
# tiles x splits reach about POINTWISE_INT8_CLUSTER_BLOCKS_PER_SM blocks an
# SM.
POINTWISE_INT8_GEMV_MAX_ROWS = 8
POINTWISE_INT8_GEMV_COLS = 128
POINTWISE_INT8_GEMV_STEP = 32
POINTWISE_INT8_GEMV_MIN_K = 512
POINTWISE_INT8_ONE_PASS_MAX_K = 256
POINTWISE_INT8_TILE = 64
POINTWISE_INT8_CLUSTER_COLS = (64, 128)
POINTWISE_INT8_CLUSTER_MAX = 8
# The int8 direct 3x3's cluster takes up to 16 splits (past 8 a non-portable
# cluster, wgmma_s8_cluster.cuh's kClusterMax), a power of two of them: its
# K walk is 9 Cin long, and the 7x7x512 b-leg's 8 tiles at N=1 ran 24% faster
# at 16 than at 8; at 5 and 9 blocks a cluster the walks ran slower than at
# 4 and 8 (tools/chip_split_sweep.py, PERF.md).
DIRECT_INT8_CLUSTER_MAX = 16
POINTWISE_INT8_CLUSTER_STEP = 32
POINTWISE_INT8_CLUSTER_MIN_CHUNK = 32
POINTWISE_INT8_CLUSTER_BLOCKS_PER_SM = 2
POINTWISE_INT8_ONE_PASS_ROWS = 1024
POINTWISE_INT8_ONE_PASS_WIDE_ROWS = 4096
POINTWISE_INT8_PATHS = ("gemv", "one_pass", "cluster")  # the C entry's numbering


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

    def args(self) -> tuple:
        """The plan as the C entry takes it: path, Kp, tile, blocks, splits,
        chunk."""
        return (POINTWISE_INT8_PATHS.index(self.path), self.kp, self.tile, self.blocks,
                self.splits, self.chunk)


def pointwise_int8_plan(p: int, k: int, n: int, sms: int = H100_SMS,
                        path: str | None = None, want: int = 0,
                        cols: int = 0, cap: int = 0,
                        wide_clusters: int | None = None) -> PointwiseInt8Plan:
    """The path, grid and K split of a (p, k) x (k, n) int8 product (k a
    multiple of 4) on a card with `sms` SMs; `path` forces a path that
    takes the shape, `want` a number of K ranges (split_k's: the GEMV's,
    a power of two of them, and the cluster's), `cols` the GEMV's or the
    cluster tiles' width and `cap` the cluster's most splits
    (POINTWISE_INT8_CLUSTER_MAX where 0) (tools/chip_split_sweep.py times
    the others); `wide_clusters` the GEMV's as pointwise.py::gemv_split
    takes it."""
    kp = _round_up(k, DIRECT_INT8_K_ALIGN)
    if path is None:
        one_pass = (kp <= POINTWISE_INT8_ONE_PASS_MAX_K and p >= POINTWISE_INT8_ONE_PASS_ROWS
                    and (n <= 2 * POINTWISE_INT8_TILE or p <= POINTWISE_INT8_ONE_PASS_WIDE_ROWS))
        path = ("gemv" if p <= POINTWISE_INT8_GEMV_MAX_ROWS and k >= POINTWISE_INT8_GEMV_MIN_K
                else "one_pass" if one_pass else "cluster")
    if (path not in POINTWISE_INT8_PATHS or path == "gemv" and p > POINTWISE_INT8_GEMV_MAX_ROWS
            or path == "one_pass" and kp > POINTWISE_INT8_ONE_PASS_MAX_K):
        raise ValueError(f"path {path!r} does not take a ({p}, {k}) x ({k}, {n}) product")
    if path == "gemv":
        width, tiles, split = pw.gemv_split(k, n, sms, wide_clusters, cols, want)
        return PointwiseInt8Plan(path, k, width, tiles, tiles * split.splits, split.splits,
                                 split.chunk)
    if path == "one_pass":
        tiles = -(-p // POINTWISE_INT8_TILE) * -(-n // POINTWISE_INT8_TILE)
        return PointwiseInt8Plan(path, kp, POINTWISE_INT8_TILE, tiles, tiles, 1, kp)
    narrow, wide = POINTWISE_INT8_CLUSTER_COLS
    cap = cap or POINTWISE_INT8_CLUSTER_MAX
    if not cols:
        wide_tiles = -(-p // POINTWISE_INT8_TILE) * -(-n // wide)
        most = min(cap, max(1, kp // POINTWISE_INT8_CLUSTER_MIN_CHUNK))
        cols = wide if n > narrow and 2 * wide_tiles * most >= sms else narrow
    if cols not in POINTWISE_INT8_CLUSTER_COLS:
        raise ValueError(f"cluster tiles are {POINTWISE_INT8_CLUSTER_COLS} columns wide, not {cols}")
    tiles = -(-p // POINTWISE_INT8_TILE) * -(-n // cols)
    want = want or POINTWISE_INT8_CLUSTER_BLOCKS_PER_SM * sms // tiles
    split = split_k(kp, min(want, cap), POINTWISE_INT8_CLUSTER_STEP,
                    POINTWISE_INT8_CLUSTER_MIN_CHUNK)
    return PointwiseInt8Plan(path, kp, cols, tiles, tiles * split.splits, split.splits,
                             split.chunk)


def direct_int8_plan(n: int, h: int, w: int, cin: int, cout: int, sms: int = H100_SMS,
                     want: int = 0, cols: int = 0) -> PointwiseInt8Plan:
    """The plan of an (n, h, w, cin) -> cout int8 3x3 (cin a multiple of 4)
    on a card with `sms` SMs: csrc/direct_int8.cu runs the int8 pointwise's
    cluster kernel on the im2col rows, so the plan is pointwise_int8_plan's
    cluster path on P = n h w, K = 9 cin (its padded K, tile width, grid and
    K split), at most DIRECT_INT8_CLUSTER_MAX splits and, unless `want`
    names a number of K ranges, a power of two of them (as direct.py::
    direct_plan's clusters); `want` and `cols` as pointwise_int8_plan takes
    them (tools/chip_split_sweep.py times the others)."""
    p, k = n * h * w, 9 * cin
    plan = pointwise_int8_plan(p, k, cout, sms, "cluster", want, cols, DIRECT_INT8_CLUSTER_MAX)
    if want:
        return plan
    fill = POINTWISE_INT8_CLUSTER_BLOCKS_PER_SM * sms // plan.tiles
    split = pow2_split(plan.kp, min(fill, DIRECT_INT8_CLUSTER_MAX), POINTWISE_INT8_CLUSTER_STEP,
                       POINTWISE_INT8_CLUSTER_MIN_CHUNK)
    return plan._replace(blocks=plan.tiles * split.splits, splits=split.splits, chunk=split.chunk)


# The plan of a csrc/winograd_int8.cu launch. The kernel's geometry, which
# its C entry checks every plan against (tests/test_torch_splitk.py reads it
# from the source): a work item is a block of Winograd tiles (s8 wgmma's N)
# by output channels (two or four m64 A tiles; 256 only in the stash), one
# of WINO_INT8_ITEMS, over all 16 positions, run by one cluster
# of WINO_INT8_CLUSTER blocks (two positions a block, one a warpgroup), one
# item a cluster: the grid is WINO_INT8_CLUSTER blocks an item. The padded
# Cin is a multiple of DIRECT_INT8_K_ALIGN and is multiplied in stages of
# WINO_INT8_STEP (one scale group). An item stages K in spans of the plan's
# chunk: the padded Cin itself up to WINO_INT8_CHUNK, past it spans of a
# multiple of the scale group WINO_INT8_GROUP, so a block's shared memory
# (winograd_int8_smem) stays within H100_SMEM_PER_BLOCK at any Cin. A block
# of 128-channel items of at most WINO_INT8_TWO_BLOCK_TILES tiles in one span
# is held to 128 registers a thread (csrc/winograd_int8.cu's kMinBlocks), so
# two fit an SM where their shared memory does; every other item takes one.
# The plan's own rule: of the items whose grid fills WINO_INT8_FILL of the
# blocks the card holds at once, the one with the most work an SM (wider
# channel blocks first: V is transformed once an item; then tiles times
# blocks an SM), else the most items with the fewest tiles
# (tools/chip_split_sweep.py times every item shape: PERF.md).
WINO_INT8_ITEMS = ((8, 128), (16, 128), (32, 256))  # (tiles, channels) an item
WINO_INT8_TWO_BLOCK_TILES = 16
WINO_INT8_FILL = 0.75
WINO_INT8_CLUSTER = 8
WINO_INT8_STEP = 128
WINO_INT8_CHUNK = 512
H100_SMEM_PER_SM = 233472     # bytes of shared memory an SM holds (228 KB)
H100_SMEM_PER_BLOCK = 232448  # the most one block may take (227 KB)
SMEM_RESERVED_PER_BLOCK = 1024


def wino_int8_groups(cin: int, cout: int) -> int:
    """The int8 Winograd's row-scale groups: one in the stash branch, else
    Cin / WINO_INT8_GROUP where that divides Cin, else one."""
    return 1 if wino_int8_stash(cout) or cin % WINO_INT8_GROUP else cin // WINO_INT8_GROUP


def winograd_int8_smem(tiles: int, cols: int, chunk: int, groups: int) -> int:
    """Bytes of dynamic shared memory a block of csrc/winograd_int8.cu takes
    (its Layout) for items of `tiles` tiles and `cols` channels and spans of
    `chunk` of K holding `groups` scale groups: per warpgroup, 1024-aligned,
    two weight slots (cols x WINO_INT8_STEP bytes), the quantized rows, V in
    f32 or M (rows of cols + 4 floats), the rows' scales; two warpgroups and
    1024 bytes to align them."""
    vq = 2 * cols * WINO_INT8_STEP
    vf = vq + -(-chunk // WINO_INT8_STEP) * tiles * WINO_INT8_STEP
    sc = vf + _round_up(max(tiles * chunk, tiles * (cols + 4)) * 4, 16)
    return 1024 + 2 * _round_up(sc + tiles * groups * 4, 1024)


class WinogradInt8Plan(NamedTuple):
    """How csrc/winograd_int8.cu runs one conv: the padded Cin, the K an
    item stages at once, the map's Winograd tiles, an item's tiles and
    output channels, the items' tile and column blocks, and the grid's
    blocks (WINO_INT8_CLUSTER an item)."""

    kp: int
    chunk: int
    tiles: int
    item_tiles: int
    cols: int
    tile_blocks: int
    col_blocks: int
    blocks: int

    def items(self) -> int:
        """Work items (clusters): tile blocks x column blocks."""
        return self.tile_blocks * self.col_blocks

    def smem(self, cin: int, cout: int) -> int:
        """Bytes of shared memory a block takes: a span's scale groups are
        one where a scale covers the whole row, else chunk / WINO_INT8_GROUP."""
        groups = wino_int8_groups(cin, cout)
        return winograd_int8_smem(self.item_tiles, self.cols, self.chunk,
                                  1 if groups == 1 else self.chunk // WINO_INT8_GROUP)

    def args(self) -> tuple:
        """The plan as the C entry takes it: Kp, an item's tiles and
        columns, the chunk, blocks."""
        return (self.kp, self.item_tiles, self.cols, self.chunk, self.blocks)

    def blocks_per_sm(self, cin: int, cout: int) -> int:
        """Blocks an SM holds at once: two where the kernel holds the item
        to 128 registers a thread and two blocks' shared memory fit, else
        one."""
        regs = 2 if (self.cols == 128 and self.item_tiles <= WINO_INT8_TWO_BLOCK_TILES
                     and self.chunk == self.kp) else 1
        return min(regs, H100_SMEM_PER_SM // (self.smem(cin, cout) + SMEM_RESERVED_PER_BLOCK))


def winograd_int8_item(n: int, h: int, w: int, cin: int, cout: int, item_tiles: int,
                       cols: int) -> WinogradInt8Plan | None:
    """The plan for items of `item_tiles` tiles by `cols` channels: K in one
    span where it fits the block's shared memory, else in the widest spans
    of whole scale groups that do; None where the kernel has no such item
    (not one of WINO_INT8_ITEMS, or cols above 128 outside the stash) or
    no span fits."""
    if (item_tiles, cols) not in WINO_INT8_ITEMS or (
            cols > WINO_INT8_TILE_CO and not wino_int8_stash(cout)):
        return None
    kp = _round_up(cin, DIRECT_INT8_K_ALIGN)
    tiles = n * -(-h // 2) * -(-w // 2)
    tile_blocks, col_blocks = -(-tiles // item_tiles), -(-cout // cols)
    spans = [kp] if kp <= WINO_INT8_CHUNK else []
    spans += [c for c in range(WINO_INT8_CHUNK, 0, -WINO_INT8_GROUP) if c < kp]
    for chunk in spans:
        plan = WinogradInt8Plan(kp, chunk, tiles, item_tiles, cols, tile_blocks, col_blocks,
                                WINO_INT8_CLUSTER * tile_blocks * col_blocks)
        if plan.smem(cin, cout) <= H100_SMEM_PER_BLOCK:
            return plan
    return None


def winograd_int8_plan(n: int, h: int, w: int, cin: int, cout: int,
                       sms: int = H100_SMS) -> WinogradInt8Plan:
    """The item shape, span and grid of an (n, h, w, cin) -> cout int8 F(2,3)
    on a card with `sms` SMs, by the rule above."""
    plans = [plan for tiles, cols in WINO_INT8_ITEMS
             if (plan := winograd_int8_item(n, h, w, cin, cout, tiles, cols)) is not None]
    per_sm = {plan: plan.blocks_per_sm(cin, cout) for plan in plans}
    full = [plan for plan in plans if plan.blocks >= WINO_INT8_FILL * sms * per_sm[plan]]
    if full:
        return max(full, key=lambda p: (p.cols, p.item_tiles * per_sm[p], per_sm[p]))
    return max(plans, key=lambda p: (p.items(), -p.item_tiles))


# The int8 kernels pack four k to a 32-bit word and take channel counts that
# are multiples of 4. The wrappers pad any other count with zero channels
# before they dispatch: zero input channels and zero weight rows; a padded
# output channel gets a zero weight column, a zero weight scale and a zero
# BN scale and bias. A zero column changes neither a row's max|a| nor its
# int32 sum, and a padded output channel ends as relu(0) = 0 (plus a zero
# residual), so the padded call gives the unpadded one's bits, and the
# wrappers slice the padded channels off. Counts that are multiples of 4
# (every served width) are passed through untouched.


# The plan of a csrc/stage_int8.cu launch. The kernel's geometry, which its
# C entry checks every plan against (tests/test_torch_stage_int8_plan.py
# reads them from the sources): a cooperative grid of at most
# STAGE_INT8_BLOCKS_PER_SM blocks an SM (kMaxBlocksPerSm), each of
# STAGE_INT8_WARPGROUPS warpgroups walking work items of its own (64 x 64
# output tiles, csrc/wgmma_s8.cuh's kBM, kBN), K padded to
# STAGE_INT8_K_ALIGN, K splits each a multiple of STAGE_INT8_STEP (the
# tile's stage, kBK) but the last, at most STAGE_INT8_MAX_SPLITS
# (kSplitCap). The plan's own rule, per GEMM phase: split K only where the
# phase's tiles are fewer than 1 / STAGE_INT8_FEW_TILES of the warpgroups,
# and then into walks of at most STAGE_INT8_WALK (a split's partial sums
# cost a grid barrier and a pass over device memory, more than the
# parallelism buys elsewhere: tools/chip_split_sweep.py, PERF.md); the
# winograd2 route's grouped expand does not split.
STAGE_INT8_FEW_TILES = 8
STAGE_INT8_WALK = 512
STAGE_INT8_WARPGROUPS = 2
STAGE_INT8_TILE_M = 64
STAGE_INT8_TILE_N = 64
STAGE_INT8_STEP = 128
STAGE_INT8_K_ALIGN = 32
STAGE_INT8_MAX_SPLITS = 16
STAGE_INT8_BLOCKS_PER_SM = 1


class StageInt8Plan(NamedTuple):
    """How csrc/stage_int8.cu runs one stage: its grid and each GEMM
    phase's K split over its padded K; on the winograd2 route, whose FP64
    mid is no GEMM, the mid is (1, its items' Cout block,
    winograd.py::winograd_fp64_plan's cols)."""

    grid: int
    reduce: Split
    mid: Split
    expand: Split

    def phases(self) -> tuple:
        """The six integers the C entry takes: each phase's splits, chunk."""
        return (*self.reduce, *self.mid, *self.expand)


def stage_int8_phase(p: int, k: int, n: int, grid: int, max_walk: int = 0) -> Split:
    """The K split of a (p, k) x (k, n) int8 GEMM phase on a grid of `grid`
    blocks, over k padded to STAGE_INT8_K_ALIGN: the plan's rule (max_walk
    0) or no item walking more than max_walk of K, splits a multiple of
    STAGE_INT8_STEP but the last, at most STAGE_INT8_MAX_SPLITS."""
    kp = _round_up(k, STAGE_INT8_K_ALIGN)
    tiles = -(-p // STAGE_INT8_TILE_M) * -(-n // STAGE_INT8_TILE_N)
    if not max_walk:
        few = tiles * STAGE_INT8_FEW_TILES < grid * STAGE_INT8_WARPGROUPS
        max_walk = STAGE_INT8_WALK if few else kp
    want = -(-kp // max_walk)
    splits = min(want, kp // STAGE_INT8_STEP, STAGE_INT8_MAX_SPLITS)
    if splits < 2:
        return Split(1, kp)
    chunk = _round_up(-(-kp // splits), STAGE_INT8_STEP)
    return Split(-(-kp // chunk), chunk)


def stage_int8_plan(n: int, h: int, w: int, cio: int, cmid: int, mid_algo: str, groups: int,
                    sms: int = H100_SMS, max_walk: int = 0) -> StageInt8Plan:
    """The grid and the reduce, direct-mid and expand splits of an int8
    stage over (n, h, w, cio) with cmid bottleneck channels (multiples of
    4), mid_algo "direct" or "winograd2" and the expand's quantization
    groups, on a card with `sms` SMs (max_walk: stage_int8_phase's, for
    every phase)."""
    wino = mid_algo == "winograd2"
    grid = STAGE_INT8_BLOCKS_PER_SM * sms
    p = n * h * w
    mid = (Split(1, winograd_fp64_plan(n, h, w, cmid, grid).cols) if wino
           else stage_int8_phase(p, 9 * cmid, cmid, grid, max_walk))
    expand = (stage_int8_phase(p, cmid, cio, grid, max_walk) if groups == 1
              else Split(1, _round_up(cmid, STAGE_INT8_K_ALIGN)))
    return StageInt8Plan(grid, stage_int8_phase(p, cio, cmid, grid, max_walk), mid, expand)


@functools.lru_cache(maxsize=None)
def _stage_int8_workspace(device_index: int, n, h, w, cio, cmid, nb, wino, groups, grid,
                          phases: tuple) -> int:
    """4-byte words of workspace csrc/stage_int8.cu needs for this shape and
    plan on the device."""
    lib = _build.library("stage_int8")
    words = ctypes.c_longlong(0)
    c = _build.cint
    with torch.cuda.device(device_index):
        err = lib.resnet_stage_int8_workspace(
            c(n), c(h), c(w), c(cio), c(cmid), c(nb), c(wino), c(groups), c(grid),
            (ctypes.c_int * 6)(*phases), ctypes.byref(words))
    _build.check_error(lib, "resnet_stage_int8_workspace", err)
    return words.value


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
    wide = (pw.gemv_clusters(x.device, "pointwise_int8")
            if p <= POINTWISE_INT8_GEMV_MAX_ROWS else None)
    return conv1x1_bn_int8_planned(
        x, w_q, s_w, scale, bias, relu,
        pointwise_int8_plan(p, cin, cout, _build.sm_count(x.device), wide_clusters=wide))


def conv1x1_bn_int8_planned(x, w_q, s_w, scale, bias, relu: bool,
                            plan: PointwiseInt8Plan) -> torch.Tensor:
    """conv1x1_bn_int8's launch on CUDA tensors under an explicit plan (the
    wrapper passes pointwise_int8_plan's; tools/chip_split_sweep.py times
    others). Cin a multiple of 4; operands as conv1x1_bn_int8 checks them."""
    cin, cout = w_q.shape
    p = x.numel() // cin
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads rows as float4s
    out = torch.empty(*x.shape[:-1], cout, device=x.device, dtype=torch.float32)
    ptr, c = _build.ptr, _build.cint
    _build.launch(
        "pointwise_int8", "pointwise_int8_conv1x1_bn", (p, cin, cout, bool(relu)), x.device,
        ptr(x), ptr(w_q), ptr(s_w), ptr(scale), ptr(bias), ptr(out),
        c(p), c(cin), c(cout), c(relu), *map(c, plan.args()),
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
                            plan: PointwiseInt8Plan) -> torch.Tensor:
    """conv3x3_bn_int8's launch on CUDA tensors under an explicit plan (the
    wrapper passes direct_int8_plan's; tools/chip_split_sweep.py times
    others). x: (N, H, W, Cin), Cin a multiple of 4; operands as
    conv3x3_bn_int8 checks them."""
    n, h, w, cin = x.shape
    cout = w9_q.shape[1]
    if plan.path != "cluster":
        raise ValueError(f"csrc/direct_int8.cu runs the cluster path, not {plan.path!r}")
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads pixels as float4s
    out = torch.empty(n, h, w, cout, device=x.device, dtype=torch.float32)
    ptr, c = _build.ptr, _build.cint
    _build.launch(
        "direct_int8", "direct_int8_conv3x3_bn", (n, h, w, cin, cout, bool(relu)),
        x.device, ptr(x), ptr(w9_q), ptr(s_w9), ptr(scale), ptr(bias), ptr(out),
        c(n), c(h), c(w), c(cin), c(cout), c(relu), *map(c, plan.args()[1:]),
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
    out = torch.empty(n, h, w, cout, device=x.device, dtype=torch.float32)
    ptr, c = _build.ptr, _build.cint
    _build.launch(
        "winograd_int8", "winograd_int8_conv3x3_bn", (n, h, w, cin, cout, bool(relu)),
        x.device, ptr(x), ptr(u_q), ptr(s_u), ptr(scale), ptr(bias), ptr(out),
        c(n), c(h), c(w), c(cin), c(cout), c(wino_int8_stash(cout)), c(relu),
        *map(c, plan.args()),
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


def resnet_stage_int8_planned(x, qstacked: Dict, mid_algo: str,
                              plan: StageInt8Plan) -> torch.Tensor:
    """resnet_stage_int8's launch on CUDA tensors (N, H, W, Cio), channels
    multiples of 4, under an explicit plan (the wrapper passes
    stage_int8_plan's; tools/chip_split_sweep.py times others); mid_algo
    "direct" or "winograd2"."""
    cmid = qstacked["w_reduce_q"].shape[2]
    return _stage_int8_launch(x, qstacked, mid_algo, expand_groups(cmid, mid_algo), plan)


def _stage_int8_launch(x, q: Dict, mid_algo: str, groups: int,
                       plan: StageInt8Plan = None) -> torch.Tensor:
    """resnet_stage_int8's launch on CUDA tensors; channels multiples of 4;
    plan: stage_int8_plan's when None. The winograd2 mid copies its filter
    in 16-byte pieces: Cmid is padded to a multiple of 8 with zero channels
    and an unaligned u2_mid_bf16 copied."""
    n, h, w, cio = x.shape
    nb, _, cmid = q["w_reduce_q"].shape
    wino = mid_algo == "winograd2"
    if wino and cmid % 8:
        cmid = -(-cmid // 8) * 8
        q = pad_stage_int8(q, cio, cmid)
    if wino and q["u2_mid_bf16"].data_ptr() % 16:
        q = dict(q, u2_mid_bf16=q["u2_mid_bf16"].clone())
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
    if plan is None:
        plan = stage_int8_plan(n, h, w, cio, cmid, mid_algo, groups, _build.sm_count(x.device))
    phases = plan.phases()
    words = _stage_int8_workspace(x.device.index, n, h, w, cio, cmid, nb, int(wino), groups,
                                  plan.grid, phases)
    ws = torch.empty(words, device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    ptr, c = _build.ptr, _build.cint
    _build.launch(
        "stage_int8", "resnet_stage_int8", (n, h, w, cio, cmid, nb, mid_algo), x.device,
        ptr(x), ptr(q["w_reduce_q"]), ptr(q["w_reduce_s"]), ptr(q["s_reduce"]),
        ptr(q["b_reduce"]), ptr(q[mid_key]), ptr(q["w9_mid_s"]), ptr(q["s_mid"]),
        ptr(q["b_mid"]), ptr(q["w_expand_q"]), ptr(q["w_expand_s"]), ptr(q["s_expand"]),
        ptr(q["b_expand"]), ptr(out), ptr(ws), ctypes.c_longlong(words),
        c(n), c(h), c(w), c(cio), c(cmid), c(nb), c(wino), c(groups), c(plan.grid),
        (ctypes.c_int * 6)(*phases),
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
    as transition_block_int8 checks them. The kernel reads the weights'
    k-contiguous copies (transition_int8_kmajor: made at a weight's first
    launch, kept after)."""
    n, h, w, cin = x.shape
    cmid, cout = q["w_expand_q"].shape
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads rows as float4s
    kt = transition_int8_kmajor(q)  # fresh allocations: 16-byte aligned, as TMA needs
    words = _workspace_words("transition_int8", "transition_block_int8", x.device.index,
                             n, h, w, cin, cmid, cout, *plan.args())
    ws = torch.empty(words, device=x.device, dtype=torch.float32)
    out = torch.empty(n, -(-h // 2), -(-w // 2), cout, device=x.device, dtype=torch.float32)
    ptr, c = _build.ptr, _build.cint
    _build.launch(
        "transition_int8", "transition_block_int8", (n, h, w, cin, cmid, cout), x.device,
        ptr(x), *(ptr(kt[k] if k.endswith("_kt") else q[k]) for k in (
            "w_reduce_kt", "w_reduce_s", "s_reduce", "b_reduce",
            "w9_mid_kt", "w9_mid_s", "s_mid", "b_mid",
            "w_expand_kt", "w_expand_s", "s_expand", "b_expand",
            "w_proj_kt", "w_proj_s", "s_proj", "b_proj")),
        ptr(out), ptr(ws), ctypes.c_longlong(words),
        c(n), c(h), c(w), c(cin), c(cmid), c(cout), *map(c, plan.args()),
    )
    return out
