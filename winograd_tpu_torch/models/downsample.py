"""Projection and stride-2 transition blocks, and the multi-stage trunk.

Port of winograd_tpu/models/downsample.py. The transition runs as one
transition kernel launch (algo "fused", kernels/transition.py), or per
layer (algo "composed"): a stride-2 1x1 is a subsample and the pointwise
kernel, a stride-2 3x3 a strided im2col and the pointwise kernel.
Transition params are the identity block's plus w_proj (Cin, Cout), s_proj,
b_proj, with the 3x3 filter as w9_mid, and the fused wep/bep
(models/convert.py). The projection block (conv2_x's entry) runs per layer,
its 3x3 Winograd F(2,3) on u2_mid, as in the JAX package.

At precision "bf16w" (bfloat16 weights, models/convert.py::cast_bf16w) the
same routes run the kernels' bf16w instantiations, every identity run as one
stage kernel launch (models/resnet.py::stage_algo's bf16w gate).

resnet50_stages_train (the JAX package's resnet50_stages_train) is the
trunk differentiable on the raw trainable parameters through
kernels/vjp.py: each transition through the transition kernel forward, each
identity run of maps wider than 28 or of io width 2048 and up (conv2_x,
conv5_x) through one stage kernel forward, every other block through the
stage kernel at one block. The gate is the JAX package's, a TPU VMEM rule
kept as it is.

At the int8 tier (quantize_backbone, resnet50_stages_int8) every
transition is one int8 transition kernel launch and every identity run one
int8 stage kernel launch (kernels/quantized.py), with no weight gate.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from winograd_tpu_torch.kernels import vjp
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.quantized import (
    quantize_stage_params,
    quantize_transition_params,
    resnet_stage_int8,
    transition_block_int8,
)
from winograd_tpu_torch.kernels.transition import strided_im2col, transition_block_fused
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd
from winograd_tpu_torch.models.resnet import check_precision, resnet_stage, train_input


def conv3x3_s2_bn_relu(x, w9, scale, bias, relu: bool = True) -> torch.Tensor:
    """Stride-2 3x3 conv + BN (+ReLU): strided im2col + the pointwise kernel.
    x: (N, H, W, Cin); w9: (9*Cin, Cout)."""
    return conv1x1_bn(strided_im2col(x), w9, scale, bias, relu=relu)


def projection_bottleneck_block(x: torch.Tensor, params: Dict,
                                precision: str = "f32") -> torch.Tensor:
    """Stride-1 projection bottleneck (conv2_x's entry): 1x1 reduce -> F(2,3)
    3x3 -> 1x1 expand, plus a 1x1 projection shortcut; add, ReLU. At
    "bf16w" the 1x1s run the pointwise kernel's bf16w instantiation and the
    3x3 the Winograd's (kernels/winograd.py's "bf16w")."""
    p = params
    check_precision(precision, p["w_reduce"], p["u2_mid"], p["w_expand"], p["w_proj"])
    h = conv1x1_bn(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], relu=True)
    h = conv3x3_bn_winograd(h, p["u2_mid"], p["s_mid"], p["b_mid"], relu=True,
                            precision=precision)
    h = conv1x1_bn(h, p["w_expand"], p["s_expand"], p["b_expand"], relu=False)
    skip = conv1x1_bn(x, p["w_proj"], p["s_proj"], p["b_proj"], relu=False)
    return torch.relu(h + skip)


def downsample_bottleneck_block(x: torch.Tensor, params: Dict, algo: str = "fused") -> torch.Tensor:
    """ResNet v1.5 transition: 1x1 reduce -> stride-2 3x3 -> 1x1 expand,
    stride-2 1x1 projection shortcut; add, ReLU. algo "fused" (one launch)
    or "composed" (per layer)."""
    if algo == "fused":
        return transition_block_fused(x, params)
    if algo != "composed":
        raise ValueError(f"unknown algo {algo!r}")
    p = params
    h = conv1x1_bn(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], relu=True)
    h = conv3x3_s2_bn_relu(h, p["w9_mid"], p["s_mid"], p["b_mid"], relu=True)
    h = conv1x1_bn(h, p["w_expand"], p["s_expand"], p["b_expand"], relu=False)
    skip = x[..., ::2, ::2, :].contiguous()
    skip = conv1x1_bn(skip, p["w_proj"], p["s_proj"], p["b_proj"], relu=False)
    return torch.relu(h + skip)


def resnet50_stages(x: torch.Tensor, stages: List[Dict], precision: str = "f32") -> torch.Tensor:
    """Each stage: its optional stride-2 "transition", then its identity
    "blocks" (with their "stacked" params where the stage runs fused), at
    `precision` ("f32" or "bf16w")."""
    for stage in stages:
        if stage.get("transition") is not None:
            check_precision(precision, stage["transition"]["w_reduce"])
            x = downsample_bottleneck_block(x, stage["transition"])
        x = resnet_stage(x, stage["blocks"], stacked=stage.get("stacked"), precision=precision)
    return x


def resnet50_stages_train(x, stages: List[Dict], precision=None, device="cuda") -> torch.Tensor:
    """The trunk differentiable on the raw trainable parameters: each
    stage's optional "transition" (raw w_mid) through
    kernels/vjp.py::transition_block_train_fused; its identity "blocks"
    through one resnet_stage_train_streamed where the map is wider than 28
    or the io width is 2048 or more, else each through
    bottleneck_block_train_fused. precision None or "bf16w"."""
    for stage in stages:
        if stage.get("transition") is not None:
            x = vjp.transition_block_train_fused(
                train_input(x, stage["transition"]["s_reduce"], device), stage["transition"],
                precision)
        blocks = stage["blocks"]
        if not blocks:
            continue
        x = train_input(x, blocks[0]["s_reduce"], device)
        if x.shape[-2] > 28 or blocks[0]["w_reduce"].shape[0] >= 2048:
            x = vjp.resnet_stage_train_streamed(x, blocks, precision)
        else:
            for b in blocks:
                x = vjp.bottleneck_block_train_fused(x, b, precision)
    return x


def quantize_backbone(stages: List[Dict]) -> List[Dict]:
    """The port's f32 stages -> their int8 form for resnet50_stages_int8:
    each transition quantized, each stage's blocks quantized and stacked."""
    return [{
        "transition": None if st.get("transition") is None
        else quantize_transition_params(st["transition"]),
        "blocks": quantize_stage_params(st["blocks"]),
    } for st in stages]


def resnet50_stages_int8(x: torch.Tensor, qstages: List[Dict]) -> torch.Tensor:
    """The multi-stage backbone at the int8 tier: each stage's transition
    through the int8 transition kernel, its identity blocks through the
    int8 stage kernel (mid-layer by map size, kernels/quantized.py)."""
    for st in qstages:
        if st.get("transition") is not None:
            x = transition_block_int8(x, st["transition"])
        x = resnet_stage_int8(x, st["blocks"])
    return x
