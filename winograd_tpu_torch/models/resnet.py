"""Identity bottleneck block and stage, on the JAX package's routes.

Port of winograd_tpu/models/resnet.py::bottleneck_block_pallas and
::resnet_stage_pallas with their route choice. A uniform run of identity
blocks whose weights pass the stage gate runs as one stage kernel launch
(kernels/stage.py); otherwise each block runs alone, as one block kernel
launch when its weights pass the block gate (kernels/block.py), else per
layer: pointwise reduce, the 3x3 (direct or Winograd F(2,3)), pointwise
expand, then the skip add and ReLU. Block params: w_reduce (Cio, Cmid),
s_reduce, b_reduce, u2_mid (16, Cmid, Cmid) and w9_mid (9*Cmid, Cmid)
layouts of the 3x3 filter, s_mid, b_mid, w_expand (Cmid, Cio), s_expand,
b_expand.

At precision "bf16w" (bfloat16 weights) a stage takes the JAX package's
bf16w gate: every uniform stage whose 2-byte weights pass a looser budget
runs as one stage kernel launch, single-block stages and conv5_x included,
and a stage that would run per block raises, as in the JAX package.

bottleneck_block_train is the port of bottleneck_block_train: the block
differentiable on its raw trainable parameters (w_mid OIHW, no offline
layouts) through kernels/vjp.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from winograd_tpu_torch.kernels import _build, vjp
from winograd_tpu_torch.kernels.block import bottleneck_block_fused
from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.stage import (
    WINOGRAD_MIN_PIXELS,
    resnet_stage_fused,
    stack_stage_params,
)
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd

__all__ = [
    "BF16W_STAGE_FUSED_MAX_WEIGHT_BYTES", "BLOCK_FUSED_MAX_WEIGHT_BYTES",
    "PRECISIONS", "STAGE_FUSED_MAX_WEIGHT_BYTES", "WINOGRAD_MIN_PIXELS", "block_algo",
    "bottleneck_block", "bottleneck_block_train", "check_precision", "conv3x3_mid",
    "resnet_stage", "stage_algo", "train_input",
]

# The model functions' precisions: the f32 tier, and the bf16w tier, whose
# weights are bfloat16 (models/convert.py::cast_bf16w).
PRECISIONS = ("f32", "bf16w")

# A block runs as one fused launch when its f32 weights take at most this
# many bytes (conv5_x's 17.8 MB do not). The JAX package's rule
# (models/resnet.py bottleneck_block_pallas, a VMEM budget on the TPU); not
# re-derived on the H100.
BLOCK_FUSED_MAX_WEIGHT_BYTES = 8 * 2**20

# A uniform stage of more than one block runs as one fused launch when two
# blocks' f32 weights take at most this many bytes (conv4_x's 8.9 MB do,
# conv5_x's 35.7 MB do not). The JAX package's rule (models/resnet.py
# resnet_stage_pallas, a double-buffered VMEM budget on the TPU); not
# re-derived on the H100.
STAGE_FUSED_MAX_WEIGHT_BYTES = 10 * 2**20

# At bf16w a uniform stage of any number of blocks runs as one fused launch
# when two blocks' bf16 weights take at most this many bytes (conv5_x's
# 17.8 MB do). The JAX package's rule (models/resnet.py resnet_stage_pallas,
# the bf16 tier's looser VMEM cap on the TPU); not re-derived on the H100.
BF16W_STAGE_FUSED_MAX_WEIGHT_BYTES = 40 * 2**20


def check_precision(precision: str, *weights: torch.Tensor) -> None:
    """Raise unless `precision` is one of PRECISIONS and the weights are in
    its storage: bfloat16 at "bf16w" and only there."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; choose from {PRECISIONS}")
    for w in weights:
        if (w.dtype == torch.bfloat16) != (precision == "bf16w"):
            raise ValueError(f"{w.dtype} weights at precision {precision!r}; the bf16w tier "
                             "serves bfloat16 weights (models/convert.py::cast_bf16w)")


def _weight_elems(params: Dict) -> int:
    cio, cmid = params["w_reduce"].shape
    return 2 * cio * cmid + 9 * cmid * cmid


def block_algo(params: Dict) -> str:
    """The route bottleneck_block's "auto" takes: "fused", or "direct" when
    the weights fail the block gate, or "winograd" without w9_mid."""
    if "w9_mid" not in params:
        return "winograd"
    return "fused" if 4 * _weight_elems(params) <= BLOCK_FUSED_MAX_WEIGHT_BYTES else "direct"


def stage_algo(blocks: List[Dict], precision: str = "f32") -> str:
    """The route resnet_stage's "auto" takes: "fused_stage" for more than
    one block (at "bf16w" one or more) of one geometry, all with w9_mid,
    within the precision's stage gate; else "per_block"."""
    bf16w = precision == "bf16w"
    uniform = (
        (len(blocks) > 1 or bf16w)
        and all("w9_mid" in p for p in blocks)
        and len({tuple(p["w_reduce"].shape) for p in blocks}) == 1
    )
    if not uniform:
        return "per_block"
    if bf16w:
        fits = 2 * 2 * _weight_elems(blocks[0]) <= BF16W_STAGE_FUSED_MAX_WEIGHT_BYTES
    else:
        fits = 4 * 2 * _weight_elems(blocks[0]) <= STAGE_FUSED_MAX_WEIGHT_BYTES
    return "fused_stage" if fits else "per_block"


def conv3x3_mid(h: torch.Tensor, params: Dict) -> torch.Tensor:
    """A block's stride-1 3x3 + BN + ReLU as one per-layer launch, on the
    route its map size picks: Winograd F(2,3) from WINOGRAD_MIN_PIXELS up,
    direct below."""
    if h.shape[-3] * h.shape[-2] >= WINOGRAD_MIN_PIXELS:
        return conv3x3_bn_winograd(h, params["u2_mid"], params["s_mid"], params["b_mid"])
    return conv3x3_bn_direct(h, params["w9_mid"], params["s_mid"], params["b_mid"])


def bottleneck_block(x: torch.Tensor, params: Dict, algo3x3: str = "auto") -> torch.Tensor:
    """1x1 reduce (+ReLU) -> 3x3 (+ReLU) -> 1x1 expand, identity skip, ReLU.

    algo3x3: "fused" (one block kernel launch, kernels/block.py), "direct"
    or "winograd" (three per-layer launches with that 3x3; "winograd" runs
    F(2,3) on u2_mid; the JAX package's route runs F(4,3) on u_mid, a
    layout the port's params do not carry), or "auto" (block_algo)."""
    p = params
    if algo3x3 == "auto":
        algo3x3 = block_algo(p)
    if algo3x3 == "fused":
        return bottleneck_block_fused(x, p)
    h = conv1x1_bn(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], relu=True)
    if algo3x3 == "direct":
        h = conv3x3_bn_direct(h, p["w9_mid"], p["s_mid"], p["b_mid"])
    elif algo3x3 == "winograd":
        h = conv3x3_bn_winograd(h, p["u2_mid"], p["s_mid"], p["b_mid"])
    else:
        raise ValueError(f"unknown algo3x3 {algo3x3!r}")
    h = conv1x1_bn(h, p["w_expand"], p["s_expand"], p["b_expand"], relu=False)
    return torch.relu(h + x)


def resnet_stage(x: torch.Tensor, blocks: List[Dict], algo: str = "auto",
                 stacked: Optional[Dict] = None, precision: str = "f32") -> torch.Tensor:
    """A run of identity bottleneck blocks.

    algo: "fused_stage" (one stage kernel launch, kernels/stage.py),
    "per_block" (bottleneck_block each), or "auto" (stage_algo at
    `precision`). stacked: the blocks' params from stack_stage_params, made
    once at conversion (models/convert.py); stacked here when absent.
    precision "bf16w" (bfloat16 weights) needs the fused stage and raises
    where the route is per_block, as the JAX package does."""
    check_precision(precision, *(p["w_reduce"] for p in blocks))
    if algo == "auto":
        algo = stage_algo(blocks, precision)
    if precision == "bf16w" and algo != "fused_stage":
        raise ValueError(
            "precision='bf16w' requires the fused stage kernel, but this stage resolved to "
            f"{algo} (non-uniform block geometries, a missing w9_mid, or weights past "
            "BF16W_STAGE_FUSED_MAX_WEIGHT_BYTES); serve it at f32 or make the stage uniform")
    if algo == "fused_stage":
        return resnet_stage_fused(x, stacked if stacked is not None else stack_stage_params(blocks))
    if algo != "per_block":
        raise ValueError(f"unknown algo {algo!r}")
    for params in blocks:
        x = bottleneck_block(x, params)
    return x


def train_input(x, like: torch.Tensor, device="cuda") -> torch.Tensor:
    """A train forward's input on `device` (CUDA by default, which must
    exist; the CPU only on request), in the dtype of the parameter `like`.
    A tensor keeps its autograd history through the conversion."""
    return torch.as_tensor(x, dtype=like.dtype, device=_build.require_device(device))


def bottleneck_block_train(x, params: Dict, algo3x3: str = "fused", precision=None,
                           device="cuda") -> torch.Tensor:
    """Differentiable identity bottleneck on the raw trainable parameters
    (w_reduce, w_mid (Cmid, Cmid, 3, 3), w_expand and their BN pairs).

    algo3x3 "fused" (the default): the block kernel forward
    (kernels/vjp.py::bottleneck_block_train_fused), the forward serving
    runs; "winograd": three per-layer Functions, the 3x3 at F(4,3), at the
    f32 tier only (the bf16w Winograd runs F(2,3)). precision None or
    "bf16w" (kernels/vjp.py)."""
    x = train_input(x, params["s_reduce"], device)
    if algo3x3 == "fused":
        return vjp.bottleneck_block_train_fused(x, params, precision)
    if algo3x3 != "winograd":
        raise ValueError(f"unknown algo3x3 {algo3x3!r}")
    if precision is not None:
        raise ValueError("algo3x3='winograd' runs F(4,3) at the f32 tier only")
    p = params
    h = vjp.conv1x1_bn_train(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], True)
    h = vjp.conv3x3_bn_winograd_train(h, p["w_mid"], p["s_mid"], p["b_mid"], True, 4)
    h = vjp.conv1x1_bn_train(h, p["w_expand"], p["s_expand"], p["b_expand"], False)
    return torch.relu(h + x)
