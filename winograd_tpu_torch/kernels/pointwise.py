"""Fused 1x1 conv + folded BN (+ReLU): the pointwise kernel and its plain twin.

Port of winograd_tpu/kernels/pointwise.py::conv1x1_bn_pallas. The CUDA
kernel is csrc/pointwise.cu.
"""

from __future__ import annotations

import torch

from winograd_tpu_torch.kernels import _build


def conv1x1_bn_plain(x, w, scale, bias, relu: bool) -> torch.Tensor:
    """(..., Cin) @ (Cin, Cout) * scale + bias (+ReLU), in x's dtype."""
    y = torch.matmul(x, w) * scale + bias
    return torch.relu(y) if relu else y


def conv1x1_bn(x, w, scale, bias, relu: bool) -> torch.Tensor:
    """Fused pointwise conv + BN (+ReLU).

    x: (..., Cin); w: (Cin, Cout); scale, bias: (Cout,). Returns
    x.shape[:-1] + (Cout,). CPU tensors run the plain version; CUDA tensors
    launch csrc/pointwise.cu (contiguous float32 operands)."""
    cin, cout = w.shape
    if x.shape[-1] != cin:
        raise ValueError(f"x channels {x.shape[-1]} != weight Cin {cin}")
    if x.device.type == "cpu":
        return conv1x1_bn_plain(x, w, scale, bias, relu)
    _build.check_operands(scale, bias, cout, x, w)
    p = x.numel() // cin
    out = torch.empty(*x.shape[:-1], cout, device=x.device, dtype=torch.float32)
    _build.launch(
        "pointwise", "pointwise_conv1x1_bn", (p, cin, cout, bool(relu)), x.device,
        _build.ptr(x), _build.ptr(w), _build.ptr(scale), _build.ptr(bias),
        _build.ptr(out), _build.cint(p), _build.cint(cin), _build.cint(cout),
        _build.cint(relu),
    )
    return out

