"""Fused 3x3 conv (pad 1, stride 1) + folded BN (+ReLU) as an implicit GEMM.

Port of winograd_tpu/kernels/direct.py::conv3x3_bn_direct_pallas. The CUDA
kernel is csrc/direct.cu: the pointwise kernel's split-K 3xTF32 tiles with
A an implicit im2col, K split over blocks by direct_plan; the plain twin
builds the im2col matrix and multiplies.

A bfloat16 w9 selects the bf16w tier (the JAX op at precision="bf16w"):
the same plan runs csrc/direct.cu's bf16w instantiation, the f32 im2col
split into two bf16 halves, each multiplied by the bf16 weights in f32
(pointwise.py::split_dot_bf16w, the plain twin's arithmetic).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.pointwise import (
    MMA_SPLIT_MIN_K, MMA_TILE, SPLIT_STEP, Plan, weight_matmul,
)
from winograd_tpu_torch.kernels.splitk import H100_SMS, split_k

# The plan's rule for csrc/direct.cu (its geometry is the pointwise MMA
# path's, csrc/mma_tf32.cuh's 64 x 64 tiles and 32-deep stages, which its C
# entry checks every plan against): K = 9 * Cin is split, not below
# MMA_SPLIT_MIN_K, until tiles x splits fill a wave of SMs and no block
# walks more than DIRECT_MAX_CHUNK of K (a block's walk is latency bound,
# so blocks beyond one an SM still pay at N=8), in ranges at least
# DIRECT_MIN_CHUNK long. Tuned on the served 7x7x512 shapes by
# tools/chip_split_sweep.py (PERF.md): at N=1 16 splits (one wave), at N=8
# 9 (of 8 to 16, within 2% of each other, against 0.14 ms at one wave).
DIRECT_MAX_CHUNK = 512
DIRECT_MIN_CHUNK = 256


def direct_plan(n: int, h: int, w: int, cin: int, cout: int, sms: int = H100_SMS) -> Plan:
    """The output tiles and the K split of an (n, h, w, cin) -> cout 3x3 on
    a card with `sms` SMs (a pointwise Plan on the MMA path)."""
    k = 9 * cin
    tiles = -(-n * h * w // MMA_TILE) * -(-cout // MMA_TILE)
    want = max(sms // tiles, -(-k // DIRECT_MAX_CHUNK)) if k >= MMA_SPLIT_MIN_K else 1
    split = split_k(k, want, SPLIT_STEP, DIRECT_MIN_CHUNK)
    return Plan(False, MMA_TILE, tiles, split.splits, split.chunk)


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
    """im2col, then one matmul (weight_matmul: bf16w for a bfloat16 w9, the
    plain arithmetic of the bf16w stage's direct mid), BN (+ReLU).
    x: (N, H, W, Cin)."""
    y = weight_matmul(im2col3x3(x), w9) * scale + bias
    return torch.relu(y) if relu else y


@_build.checked("direct", "direct_bf16w")
def conv3x3_bn_direct(x, w9, scale, bias, relu: bool = True) -> torch.Tensor:
    """Fused 3x3 conv + BN (+ReLU), direct implicit GEMM.

    x: (H, W, Cin) or (N, H, W, Cin); w9: (9*Cin, Cout) from direct_filter,
    float32, or bfloat16 for the bf16w tier (x float32); scale, bias:
    (Cout,). CPU tensors run the plain version; CUDA tensors launch
    csrc/direct.cu (contiguous operands, float32 but for a bfloat16 w9)."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, cin = x.shape
    if w9.shape[0] != 9 * cin:
        raise ValueError(f"w9 {tuple(w9.shape)} does not take {cin} input channels")
    if w9.dtype == torch.bfloat16:
        _build.check_bf16w(x)
    if x.device.type == "cpu":
        out = conv3x3_bn_direct_plain(x, w9, scale, bias, relu)
    else:
        cout = w9.shape[1]
        if w9.dtype == torch.bfloat16:
            _build.check_tensors(w9, dtype=torch.bfloat16, device=x.device)
            _build.check_operands(scale, bias, cout, x)
        else:
            _build.check_operands(scale, bias, cout, x, w9)
        out = conv3x3_bn_direct_planned(
            x, w9, scale, bias, relu, direct_plan(n, h, w, cin, cout, _build.sm_count(x.device)))
    return out[0] if squeeze else out


def conv3x3_bn_direct_planned(x, w9, scale, bias, relu: bool, plan: Plan) -> torch.Tensor:
    """conv3x3_bn_direct's launch on CUDA tensors under an explicit plan (the
    wrapper passes direct_plan's; tools/chip_split_sweep.py times others);
    a bfloat16 w9 launches the bf16w instantiation, counted as
    "direct_bf16w". x: (N, H, W, Cin); operands as conv3x3_bn_direct checks
    them."""
    n, h, w, cin = x.shape
    cout = w9.shape[1]
    words = plan.workspace_words(n * h * w, cout)
    ws = torch.empty(words, device=x.device, dtype=torch.float32) if words else None
    out = torch.empty(n, h, w, cout, device=x.device, dtype=torch.float32)
    c = _build.cint
    bf16w = w9.dtype == torch.bfloat16
    _build.launch(
        "direct", "direct_conv3x3_bn_bf16w" if bf16w else "direct_conv3x3_bn",
        (n, h, w, cin, cout, bool(relu)), x.device,
        _build.ptr(x), _build.ptr(w9), _build.ptr(scale), _build.ptr(bias), _build.ptr(out),
        _build.ptr(ws) if ws is not None else ctypes.c_void_p(0), ctypes.c_longlong(words),
        ctypes.c_longlong(plan.counter_words()), c(n), c(h), c(w), c(cin), c(cout), c(relu),
        c(plan.tile), c(plan.splits), c(plan.chunk),
        counter="direct_bf16w" if bf16w else None,
    )
    return out
