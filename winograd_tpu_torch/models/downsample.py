"""Projection and stride-2 transition blocks, and the multi-stage trunk.

Port of winograd_tpu/models/downsample.py's per-layer ("composed") route:
a stride-2 1x1 is a subsample and the pointwise kernel; a stride-2 3x3 is a
strided im2col and the pointwise kernel. Transition params are the identity
block's plus w_proj (Cin, Cout), s_proj, b_proj, with the 3x3 filter as
w9_mid; the projection block's 3x3 runs Winograd F(2,3) on u2_mid.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd
from winograd_tpu_torch.models.resnet import resnet_stage


def _strided_im2col(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, ceil(H/2), ceil(W/2), 9*C) stride-2 3x3 patches
    (pad 1 top/left, zeros past the bottom/right), columns ordered
    (3r + s) * C + c like direct_filter's rows."""
    _, h, w, _ = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    xp = F.pad(x, (0, 0, 1, 1 + 2 * wo - w, 1, 1 + 2 * ho - h))
    return torch.cat(
        [
            xp[:, r : r + 2 * ho : 2, s : s + 2 * wo : 2, :]
            for r in range(3)
            for s in range(3)
        ],
        dim=-1,
    )


def conv3x3_s2_bn_relu(x, w9, scale, bias, relu: bool = True) -> torch.Tensor:
    """Stride-2 3x3 conv + BN (+ReLU): strided im2col + the pointwise kernel.
    x: (N, H, W, Cin); w9: (9*Cin, Cout)."""
    return conv1x1_bn(_strided_im2col(x), w9, scale, bias, relu=relu)


def projection_bottleneck_block(x: torch.Tensor, params: Dict) -> torch.Tensor:
    """Stride-1 projection bottleneck (conv2_x's entry): 1x1 reduce -> F(2,3)
    3x3 -> 1x1 expand, plus a 1x1 projection shortcut; add, ReLU."""
    p = params
    h = conv1x1_bn(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], relu=True)
    h = conv3x3_bn_winograd(h, p["u2_mid"], p["s_mid"], p["b_mid"], relu=True)
    h = conv1x1_bn(h, p["w_expand"], p["s_expand"], p["b_expand"], relu=False)
    skip = conv1x1_bn(x, p["w_proj"], p["s_proj"], p["b_proj"], relu=False)
    return torch.relu(h + skip)


def downsample_bottleneck_block(x: torch.Tensor, params: Dict) -> torch.Tensor:
    """ResNet v1.5 transition: 1x1 reduce -> stride-2 3x3 -> 1x1 expand,
    stride-2 1x1 projection shortcut; add, ReLU."""
    p = params
    h = conv1x1_bn(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], relu=True)
    h = conv3x3_s2_bn_relu(h, p["w9_mid"], p["s_mid"], p["b_mid"], relu=True)
    h = conv1x1_bn(h, p["w_expand"], p["s_expand"], p["b_expand"], relu=False)
    skip = x[:, ::2, ::2, :].contiguous()
    skip = conv1x1_bn(skip, p["w_proj"], p["s_proj"], p["b_proj"], relu=False)
    return torch.relu(h + skip)


def resnet50_stages(x: torch.Tensor, stages: List[Dict]) -> torch.Tensor:
    """Each stage: its optional stride-2 "transition", then its identity
    "blocks"."""
    for stage in stages:
        if stage.get("transition") is not None:
            x = downsample_bottleneck_block(x, stage["transition"])
        x = resnet_stage(x, stage["blocks"])
    return x
