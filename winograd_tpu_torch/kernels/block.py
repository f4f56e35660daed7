"""One identity bottleneck block in one launch: the stage kernel at B = 1.

Port of winograd_tpu/kernels/block.py::bottleneck_block_fused_pallas (its
kernels _block_kernel, direct mid, and _block_kernel_winograd, F(2,3) mid).
On Hopper both are csrc/stage.cu run over one block; the block's params
become a stack of one through views, so nothing is copied per call.
"""

from __future__ import annotations

from typing import Dict

import torch

from winograd_tpu_torch.kernels.stage import (
    STAGE_KEYS,
    resnet_stage_fused,
    resnet_stage_fused_plain,
)


def _stack_of_one(params: Dict) -> Dict[str, torch.Tensor]:
    keys = STAGE_KEYS + (("u2_mid",) if "u2_mid" in params else ())
    return {k: params[k].reshape(1, 1, -1) if params[k].dim() == 1 else params[k][None]
            for k in keys}


def bottleneck_block_fused_plain(x, params: Dict, mid_algo: str = "auto") -> torch.Tensor:
    """The block in plain PyTorch (the stage twin at B = 1). x: (N, H, W, Cio)."""
    return resnet_stage_fused_plain(x, _stack_of_one(params), mid_algo)


def bottleneck_block_fused(x, params: Dict, mid_algo: str = "auto") -> torch.Tensor:
    """Fused identity bottleneck: 1x1 reduce (+ReLU) -> 3x3 (+ReLU) -> 1x1
    expand, identity skip, ReLU. x: (H, W, Cio) or (N, H, W, Cio); params
    w_reduce, u2_mid and/or w9_mid, w_expand and their BN pairs. mid_algo as
    in kernels/stage.py. CPU tensors run the plain version; CUDA tensors
    launch csrc/stage.cu with one block."""
    return resnet_stage_fused(x, _stack_of_one(params), mid_algo)
