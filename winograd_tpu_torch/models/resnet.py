"""Identity bottleneck block and stage, composed from the per-layer kernels.

Port of winograd_tpu/models/resnet.py::bottleneck_block_pallas with
algo3x3 "winograd" / "direct" (the per-layer route) and the identity-stage
loop. Block params: w_reduce (Cio, Cmid), s_reduce, b_reduce, u2_mid
(16, Cmid, Cmid) and w9_mid (9*Cmid, Cmid) layouts of the 3x3 filter,
s_mid, b_mid, w_expand (Cmid, Cio), s_expand, b_expand.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd

# Stride-1 3x3s on maps of at least this many pixels run Winograd F(2,3);
# smaller maps run the direct implicit GEMM. The JAX package's rule
# (kernels/stage.py mid_algo="auto"); not yet re-measured on the H100.
WINOGRAD_MIN_PIXELS = 28 * 28


def conv3x3_mid(h: torch.Tensor, params: Dict) -> torch.Tensor:
    """The block's stride-1 3x3 + BN + ReLU on the route its map size picks."""
    if h.shape[-3] * h.shape[-2] >= WINOGRAD_MIN_PIXELS:
        return conv3x3_bn_winograd(h, params["u2_mid"], params["s_mid"], params["b_mid"])
    return conv3x3_bn_direct(h, params["w9_mid"], params["s_mid"], params["b_mid"])


def bottleneck_block(x: torch.Tensor, params: Dict) -> torch.Tensor:
    """1x1 reduce (+ReLU) -> 3x3 (+ReLU) -> 1x1 expand, identity skip, ReLU."""
    p = params
    h = conv1x1_bn(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], relu=True)
    h = conv3x3_mid(h, p)
    h = conv1x1_bn(h, p["w_expand"], p["s_expand"], p["b_expand"], relu=False)
    return torch.relu(h + x)


def resnet_stage(x: torch.Tensor, blocks: List[Dict]) -> torch.Tensor:
    """A run of identity bottleneck blocks."""
    for params in blocks:
        x = bottleneck_block(x, params)
    return x
