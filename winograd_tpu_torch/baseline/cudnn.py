"""The vendor-library path: the same math through cuDNN and cuBLAS.

The twin of winograd_tpu/baseline/xla.py. The reference runs every
benchmark case twice, its own CUDA kernels against cuDNN (convolution,
batch norm and activation); the JAX package's vendor path is XLA. Here it
is ops/torch_ops.py (F.conv2d for the convolutions, torch.matmul for the
1x1s and the head), which on a CUDA tensor calls cuDNN and cuBLAS. The
benchmark times the port's kernels against these, and checks both against
the float64 golden. It is never an in-house path.

TF32 is off in every call (full_float32): PyTorch lets cuDNN use TF32 by
default, and TF32 products fail the f32 bar of 1e-4.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict

import numpy as np
import torch

from winograd_tpu_torch.ops import torch_ops


@contextlib.contextmanager
def full_float32():
    """cuDNN and cuBLAS compute in full float32 (no TF32) within the scope;
    the flags are restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def tf32_enabled() -> bool:
    """Whether cuDNN or cuBLAS may use TF32 now."""
    return bool(torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)


def _float32(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_float32():
            return fn(*args, **kwargs)
    return wrapped


def tensors(tree, device, dtype=torch.float32):
    """A parameter tree of numpy arrays (dicts, lists, None) as tensors on
    `device`."""
    if isinstance(tree, dict):
        return {k: tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensors(v, device, dtype) for v in tree]
    if tree is None:
        return None
    return torch.as_tensor(np.asarray(tree), dtype=dtype, device=device).contiguous()


conv3x3_bn_relu = _float32(torch_ops.conv3x3_bn_relu)
conv1x1_bn = _float32(torch_ops.conv1x1_bn)
bottleneck_block = _float32(torch_ops.bottleneck_block)
downsample_bottleneck_block = _float32(torch_ops.downsample_bottleneck_block)
stem = _float32(torch_ops.stem)


@_float32
def bottleneck_stages(x: torch.Tensor, stages) -> torch.Tensor:
    """The bottleneck trunk (backbone_stages' structure, raw w_mid): each
    stage's optional stride-2 transition, then its identity blocks."""
    for st in stages:
        if st.get("transition") is not None:
            x = torch_ops.downsample_bottleneck_block(x, st["transition"])
        for b in st["blocks"]:
            x = torch_ops.bottleneck_block(x, b)
    return x


@_float32
def resnet50_forward_cudnn(x: torch.Tensor, params: Dict) -> torch.Tensor:
    """The complete ResNet-50 (models/resnet50.py::resnet50_arrays' tree, as
    tensors): the twin of the JAX package's resnet50_forward_xla."""
    h = torch_ops.stem(x, params["stem"])
    h = torch_ops.downsample_bottleneck_block(h, params["proj"], stride=1)
    h = bottleneck_stages(h, params["stages"])
    return torch_ops.head(h, params["head"])


@_float32
def basicnet_forward_cudnn(x: torch.Tensor, params: Dict) -> torch.Tensor:
    """The complete ResNet-18/34 (models/basic.py::basicnet_arrays' tree, as
    tensors): the twin of the JAX package's basicnet_forward_xla."""
    h = torch_ops.stem(x, params["stem"])
    for st in params["stages"]:
        if st.get("entry") is not None:
            h = torch_ops.downsample_basic_block(h, st["entry"])
        for b in st["blocks"]:
            h = torch_ops.basic_block(h, b)
    return torch_ops.head(h, params["head"])
