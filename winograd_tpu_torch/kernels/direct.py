"""Fused 3x3 conv (pad 1, stride 1) + folded BN (+ReLU) as an implicit GEMM.

Port of winograd_tpu/kernels/direct.py::conv3x3_bn_direct_pallas. The CUDA
kernel is csrc/direct.cu; the plain twin builds the im2col matrix and
multiplies.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from winograd_tpu_torch.kernels import _build


def direct_filter(w: np.ndarray) -> np.ndarray:
    """(Cout, Cin, 3, 3) OIHW -> (9*Cin, Cout) im2col GEMM layout, row index
    (3r + s) * Cin + c."""
    cout, cin = w.shape[0], w.shape[1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)).reshape(9 * cin, cout))


def im2col3x3(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W, 9*C) stride-1 pad-1 patches, columns ordered
    (3r + s) * C + c."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat(
        [xp[:, r : r + h, s : s + w, :] for r in range(3) for s in range(3)], dim=-1
    )


def conv3x3_bn_direct_plain(x, w9, scale, bias, relu: bool = True) -> torch.Tensor:
    """im2col, then one matmul, BN (+ReLU). x: (N, H, W, Cin)."""
    y = torch.matmul(im2col3x3(x), w9) * scale + bias
    return torch.relu(y) if relu else y


def conv3x3_bn_direct(x, w9, scale, bias, relu: bool = True) -> torch.Tensor:
    """Fused 3x3 conv + BN (+ReLU), direct implicit GEMM.

    x: (H, W, Cin) or (N, H, W, Cin); w9: (9*Cin, Cout) from direct_filter;
    scale, bias: (Cout,). CPU tensors run the plain version; CUDA tensors
    launch csrc/direct.cu."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, cin = x.shape
    if w9.shape[0] != 9 * cin:
        raise ValueError(f"w9 {tuple(w9.shape)} does not take {cin} input channels")
    if x.device.type == "cpu":
        out = conv3x3_bn_direct_plain(x, w9, scale, bias, relu)
    else:
        cout = w9.shape[1]
        _build.check_operands(scale, bias, cout, x, w9)
        out = torch.empty(n, h, w, cout, device=x.device, dtype=torch.float32)
        c = _build.cint
        _build.launch(
            "direct", "direct_conv3x3_bn", (n, h, w, cin, cout, bool(relu)), x.device,
            _build.ptr(x), _build.ptr(w9), _build.ptr(scale), _build.ptr(bias),
            _build.ptr(out), c(n), c(h), c(w), c(cin), c(cout), c(relu),
        )
    return out[0] if squeeze else out
