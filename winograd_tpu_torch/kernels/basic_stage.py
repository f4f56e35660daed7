"""A run of identity basic blocks (ResNet-18/34) over all images in one launch,
at f32, at bf16w and at the int8 tier.

Port of winograd_tpu/kernels/basic_stage.py: basic_stage_fused_pallas
(_basic_stage_kernel) and basic_stage_int8_pallas (_basic_stage_int8_kernel).
Each block is two stride-1 SAME 3x3 convs as im2col GEMMs,
h1 = relu(conv_a(x) * s_a + b_a), out = relu(conv_b(h1) * s_b + b_b + x).
The CUDA kernels are csrc/basic_stage.cu and csrc/basic_stage_int8.cu,
persistent kernels whose conv phases run over all N*H*W rows one grid
barrier apart (the f32 one on the stage's 3xTF32 wgmma phases over an
implicit im2col, weights by TMA, its grid and K split by basic_stage_plan;
the int8 one on the int8 stage's folded s8 wgmma phases, each im2col row
quantized once from its pixels' published maxima, the weights' k-contiguous
copies made once per weight by basic_stage_int8_kmajor, its grid and K
split by basic_stage_int8_plan); the plain twins run the same chain block
by block with the plain versions of the per-layer direct kernels. Parameters arrive stacked
per block: w9_a/w9_b (B, 9C, C), BN rows s_a/b_a/s_b/b_b (B, 1, C)
(stack_basic_stage_params); at int8 w9_a_q/w9_b_q (B, 9C, C) int8 with
weight scales w9_a_s/w9_b_s (B, 1, C) (quantize_basic_stage_params).

A bfloat16 stack (w9_a, w9_b bfloat16, BN float32; models/convert.py::
cast_basicnet_bf16w) selects the bf16w tier (the JAX kernel at
precision="bf16w"): the same plan runs csrc/basic_stage.cu's bf16w
instantiation (bf16 wgmma), each im2col row split into two bf16 halves on
the bf16 weights; the plain twin runs the direct 3x3's bf16w plain
arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct_plain
from winograd_tpu_torch.kernels.quantized import (
    STAGE_INT8_STEP, STAGE_INT8_TILE_M, STAGE_INT8_TILE_N, STAGE_INT8_WARPGROUPS, _numpy,
    _round_up, _workspace_words, ceil4, conv3x3_bn_int8_plain, kmajor_kept, pad_to, pad_windows,
    quantize_weights,
)
from winograd_tpu_torch.kernels.splitk import H100_SMS, Split
from winograd_tpu_torch.kernels.transition import phase_split

STACK_KEYS = ("w9_a", "s_a", "b_a", "w9_b", "s_b", "b_b")
QSTACK_KEYS = ("w9_a_q", "w9_a_s", "s_a", "b_a", "w9_b_q", "w9_b_s", "s_b", "b_b")


def stack_basic_stage_params(blocks: List[Dict]) -> Dict[str, torch.Tensor]:
    """Stack per-block identity basic-block params on a leading block axis
    (BN rows as (B, 1, C)), in the blocks' dtype. A copy of the JAX
    package's stack_basic_stage_params, on tensors."""
    out = {}
    for key in STACK_KEYS:
        ts = [torch.as_tensor(p[key]) for p in blocks]
        if ts[0].dim() == 1:
            ts = [t.reshape(1, -1) for t in ts]
        out[key] = torch.stack(ts).contiguous()
    return out


def quantize_basic_stage_params(blocks: List[Dict]) -> Dict[str, torch.Tensor]:
    """Offline int8 quantization of a run of identity basic blocks:
    per-output-channel weight scales (quantize_weights), stacked per block;
    BN rows stay float32, as (B, 1, C). A copy of the JAX package's
    quantize_basic_stage_params."""
    out = {}
    for leg in ("a", "b"):
        qs = [quantize_weights(_numpy(p[f"w9_{leg}"])) for p in blocks]
        out[f"w9_{leg}_q"] = torch.from_numpy(np.stack([w for w, _ in qs]))
        out[f"w9_{leg}_s"] = torch.from_numpy(np.stack([s.reshape(1, -1) for _, s in qs]))
        for key in (f"s_{leg}", f"b_{leg}"):
            rows = [np.asarray(_numpy(p[key]), np.float32).reshape(1, -1) for p in blocks]
            out[key] = torch.from_numpy(np.stack(rows))
    return out


def basic_stage_fused_plain(x, stacked: Dict) -> torch.Tensor:
    """The run block by block in plain PyTorch (the bf16w arithmetic on
    bfloat16 weights, conv3x3_bn_direct_plain's). x: (N, H, W, C)."""
    s = stacked
    for b in range(s["w9_a"].shape[0]):
        h = conv3x3_bn_direct_plain(x, s["w9_a"][b], s["s_a"][b, 0], s["b_a"][b, 0], True)
        h = conv3x3_bn_direct_plain(h, s["w9_b"][b], s["s_b"][b, 0], s["b_b"][b, 0], False)
        x = torch.relu(h + x)
    return x


def basic_stage_int8_plain(x, qstacked: Dict) -> torch.Tensor:
    """The int8 run block by block in plain PyTorch: each conv an int8 3x3
    with per-im2col-row scales. x: (N, H, W, C)."""
    q = qstacked
    for b in range(q["w9_a_q"].shape[0]):
        h = conv3x3_bn_int8_plain(x, q["w9_a_q"][b], q["w9_a_s"][b, 0], q["s_a"][b, 0],
                                  q["b_a"][b, 0], True)
        h = conv3x3_bn_int8_plain(h, q["w9_b_q"][b], q["w9_b_s"][b, 0], q["s_b"][b, 0],
                                  q["b_b"][b, 0], False)
        x = torch.relu(h + x)
    return x


def pad_basic_stage_int8(q: Dict, c: int) -> Dict:
    """quantize_basic_stage_params' stack padded to c channels (zero
    channels, see kernels/quantized.py::pad_to)."""
    q = dict(q)
    for leg in ("a", "b"):
        q[f"w9_{leg}_q"] = pad_windows(q[f"w9_{leg}_q"], c, c)
        for key in (f"w9_{leg}_s", f"s_{leg}", f"b_{leg}"):
            q[key] = pad_to(q[key], 2, c)
    return q


# The plan of a csrc/basic_stage.cu launch. The kernel's geometry is the f32
# transition's (the same wgmma_phase.cuh phases on wgmma_tile.cuh's tile,
# splits whole stages of it, TRANSITION_STEP; kernels/transition.py), its
# grid at most BASIC_STAGE_BLOCKS_PER_SM blocks an SM (basic_stage.cu's
# kMaxBlocksPerSm); its C entry checks every plan. The K split is the
# transition's phase rule (transition.py::phase_split, TRANSITION_MAX_SUM
# included), whose N=1 14->7 mid is this conv's product, (49, 4608) x
# (4608, 512); both convs of every block share it (tools/chip_split_sweep.py
# times the others at the served shapes, PERF.md).
BASIC_STAGE_BLOCKS_PER_SM = 2


class BasicStagePlan(NamedTuple):
    """How csrc/basic_stage.cu runs one stage: the cooperative grid's blocks
    and the K split (K = 9 * C) of its convs."""

    blocks: int
    conv: Split

    def args(self) -> tuple:
        """The plan as the C entry takes it: blocks, splits, chunk."""
        return (self.blocks,) + self.conv


def basic_stage_plan(n: int, h: int, w: int, c: int, sms: int = H100_SMS) -> BasicStagePlan:
    """The grid and K split of csrc/basic_stage.cu's convs at (n, h, w, c)
    on a card with `sms` SMs."""
    blocks = BASIC_STAGE_BLOCKS_PER_SM * sms
    return BasicStagePlan(blocks, phase_split(n * h * w, 9 * c, c, blocks))


# The plan of a csrc/basic_stage_int8.cu launch. The kernel's geometry,
# which its C entry checks every plan against (tests/test_torch_splitk.py
# and tests/test_torch_basic_stage_plan.py read it from the source): a
# cooperative grid of at most BASIC_STAGE_INT8_BLOCKS_PER_SM blocks an SM
# (kBlocksPerSm), each of two warpgroups walking work items of its own
# (wgmma_s8.cuh's 64 x 64 tiles), K = 9 * C padded to
# BASIC_STAGE_INT8_K_ALIGN (kKAlign), K splits each a whole number of the
# tile's stage (quantized.py::STAGE_INT8_STEP, kBK) but the last, at most
# BASIC_STAGE_INT8_MAX_SPLITS (kSplitCap). The plan's own rule: K split
# until the tiles times the splits reach the grid's warpgroups, one item
# each (both convs of every block share the split). The int8 stage's and
# transition's rule (quantized.py::stage_int8_phase: a split only below an
# eighth of the warpgroups, then walks of at most STAGE_INT8_WALK) left 56
# tiles unsplit at N=8, 21% slower than four ranges of 1152
# (tools/chip_split_sweep.py, PERF.md).
BASIC_STAGE_INT8_BLOCKS_PER_SM = 1
BASIC_STAGE_INT8_K_ALIGN = 32
BASIC_STAGE_INT8_MAX_SPLITS = 16


class BasicStageInt8Plan(NamedTuple):
    """How csrc/basic_stage_int8.cu runs one stage: the padded K (9 * C),
    the cooperative grid's blocks and the K split of its convs."""

    kp: int
    blocks: int
    splits: int
    chunk: int

    def args(self) -> tuple:
        """The plan as the C entry takes it: blocks, splits, chunk."""
        return self.blocks, self.splits, self.chunk


def basic_stage_int8_plan(n: int, h: int, w: int, c: int,
                          sms: int = H100_SMS) -> BasicStageInt8Plan:
    """The cooperative grid and the K split of csrc/basic_stage_int8.cu's
    convs, (n h w, 9 c) x (9 c, c), at (n, h, w, c) (c a multiple of 4) on
    a card with `sms` SMs."""
    blocks = BASIC_STAGE_INT8_BLOCKS_PER_SM * sms
    kp = _round_up(9 * c, BASIC_STAGE_INT8_K_ALIGN)
    tiles = -(-n * h * w // STAGE_INT8_TILE_M) * -(-c // STAGE_INT8_TILE_N)
    want = min(STAGE_INT8_WARPGROUPS * blocks // tiles, BASIC_STAGE_INT8_MAX_SPLITS,
               kp // STAGE_INT8_STEP)
    if want < 2:
        return BasicStageInt8Plan(kp, blocks, 1, kp)
    chunk = _round_up(-(-kp // want), STAGE_INT8_STEP)
    return BasicStageInt8Plan(kp, blocks, -(-kp // chunk), chunk)


def basic_stage_int8_kmajor(q: Dict, c: int) -> Dict[str, torch.Tensor]:
    """The k-contiguous (B, c, Kp) copies of a quantized stack's w9_a_q and
    w9_b_q, f"{name}_kt", padded to c channels where the stack has fewer
    (pad_windows), each made at its weight's first call and kept on it
    (quantized.py::kmajor_kept)."""
    def prepare(w):
        return pad_windows(w, c, c)

    return {f"{leg}_kt": kmajor_kept(q[f"{leg}_q"], BASIC_STAGE_INT8_K_ALIGN, prepare)
            for leg in ("w9_a", "w9_b")}


def _check_stack(stacked: Dict, keys, nb: int, c: int) -> None:
    for key in keys:
        want = (nb, 9 * c, c) if key.startswith("w9_") and not key.endswith("_s") else (nb, 1, c)
        if tuple(stacked[key].shape) != want:
            raise ValueError(f"{key} {tuple(stacked[key].shape)}, want {want}")


@functools.lru_cache(maxsize=None)
def _workspace_floats(device_index: int, n, h, w, c, *plan) -> int:
    lib = _build.library("basic_stage")
    floats = ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        err = lib.basic_stage_workspace(*map(_build.cint, (n, h, w, c) + plan),
                                        ctypes.byref(floats))
    _build.check_error(lib, "basic_stage_workspace", err)
    return floats.value


def _images(x):
    return (x[None], True) if x.dim() == 3 else (x, False)


@_build.checked("basic_stage", "basic_stage_bf16w")
def basic_stage_fused(x, stacked: Dict) -> torch.Tensor:
    """B identity basic blocks in one launch.

    x: (H, W, C) or (N, H, W, C) float32; stacked from
    stack_basic_stage_params, its w9_a and w9_b float32, or bfloat16 for the
    bf16w tier. CPU tensors run the plain version; CUDA tensors launch
    csrc/basic_stage.cu, counted as "basic_stage_bf16w" on bfloat16
    weights."""
    x, squeeze = _images(x)
    n, h, w, c = x.shape
    nb = stacked["w9_a"].shape[0]
    _check_stack(stacked, STACK_KEYS, nb, c)
    bf16w = stacked["w9_a"].dtype == torch.bfloat16
    if bf16w:
        _build.check_bf16w(x)
    if x.device.type == "cpu":
        out = basic_stage_fused_plain(x, stacked)
    else:
        weights = ("w9_a", "w9_b")
        _build.check_tensors(x, *(stacked[k] for k in STACK_KEYS if k not in weights))
        _build.check_tensors(*(stacked[k] for k in weights),
                             dtype=torch.bfloat16 if bf16w else torch.float32, device=x.device)
        out = basic_stage_fused_planned(
            x, stacked, basic_stage_plan(n, h, w, c, _build.sm_count(x.device)))
    return out[0] if squeeze else out


def basic_stage_fused_planned(x, stacked: Dict, plan: BasicStagePlan) -> torch.Tensor:
    """basic_stage_fused's launch on CUDA tensors under an explicit plan (the
    wrapper passes basic_stage_plan's; tools/chip_split_sweep.py times
    others); bfloat16 weights launch the bf16w instantiation, counted as
    "basic_stage_bf16w". x: (N, H, W, C); operands as basic_stage_fused
    checks them."""
    n, h, w, c = x.shape
    nb = stacked["w9_a"].shape[0]
    floats = _workspace_floats(x.device.index, n, h, w, c, *plan.args())
    ws = torch.empty(floats, device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    bf16w = stacked["w9_a"].dtype == torch.bfloat16
    _build.launch(
        "basic_stage", "basic_stage_bf16w" if bf16w else "basic_stage", (n, h, w, c, nb),
        x.device, *(_build.ptr(t) for t in (x, *(stacked[k] for k in STACK_KEYS))),
        _build.ptr(out), _build.ptr(ws), ctypes.c_longlong(floats),
        *map(_build.cint, (n, h, w, c, nb) + plan.args()),
        counter="basic_stage_bf16w" if bf16w else None,
    )
    return out


@_build.checked("basic_stage_int8")
def basic_stage_int8(x, qstacked: Dict) -> torch.Tensor:
    """B int8 identity basic blocks in one launch.

    x: (H, W, C) or (N, H, W, C) float32; qstacked from
    quantize_basic_stage_params. Any C (padded to a multiple of 4, see
    kernels/quantized.py::pad_to). CPU tensors run the plain version; CUDA
    tensors launch csrc/basic_stage_int8.cu."""
    x, squeeze = _images(x)
    c_x = x.shape[-1]
    q = qstacked
    nb = q["w9_a_q"].shape[0]
    _check_stack(q, QSTACK_KEYS, nb, c_x)
    if c_x % 4:
        x, q = pad_to(x, -1, ceil4(c_x)), pad_basic_stage_int8(q, ceil4(c_x))
    n, h, w, c = x.shape
    if x.device.type == "cpu":
        out = basic_stage_int8_plain(x, q)
    else:
        f32 = [x] + [q[k] for k in QSTACK_KEYS if not k.endswith("_q")]
        _build.check_tensors(*f32)
        _build.check_tensors(q["w9_a_q"], q["w9_b_q"], dtype=torch.int8, device=x.device)
        # the copies kept on the caller's weights, also where q is padded
        kt = basic_stage_int8_kmajor(qstacked, c)
        out = _int8_launch(x, q, kt, basic_stage_int8_plan(n, h, w, c, _build.sm_count(x.device)))
    if c != c_x:
        out = out[..., :c_x].contiguous()
    return out[0] if squeeze else out


def basic_stage_int8_planned(x, q: Dict, plan: BasicStageInt8Plan) -> torch.Tensor:
    """basic_stage_int8's launch on CUDA tensors under an explicit plan (the
    wrapper passes basic_stage_int8_plan's; tools/chip_split_sweep.py times
    others). x: (N, H, W, C), C a multiple of 4; operands as
    basic_stage_int8 checks them. The kernel reads the weights' k-contiguous
    copies (basic_stage_int8_kmajor: made at a weight's first launch, kept
    after)."""
    return _int8_launch(x, q, basic_stage_int8_kmajor(q, x.shape[-1]), plan)


def _int8_launch(x, q: Dict, kt: Dict, plan: BasicStageInt8Plan) -> torch.Tensor:
    n, h, w, c = x.shape
    nb = q["w9_a_q"].shape[0]
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads im2col rows as float4s
    words = _workspace_words("basic_stage_int8", "basic_stage_int8", x.device.index,
                             n, h, w, c, nb, *plan.args())
    ws = torch.empty(words, device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    operands = (x, kt["w9_a_kt"], *(q[k] for k in ("w9_a_s", "s_a", "b_a")),
                kt["w9_b_kt"], *(q[k] for k in ("w9_b_s", "s_b", "b_b")))
    _build.launch(
        "basic_stage_int8", "basic_stage_int8", (n, h, w, c, nb), x.device,
        *map(_build.ptr, operands), _build.ptr(out), _build.ptr(ws), ctypes.c_longlong(words),
        *map(_build.cint, (n, h, w, c, nb, *plan.args())),
    )
    return out
