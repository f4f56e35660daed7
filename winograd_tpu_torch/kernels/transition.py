"""The stride-2 ResNet transition block in one launch.

Port of winograd_tpu/kernels/transition.py::transition_block_fused_pallas
(both its kernels, _transition_kernel and _transition_kernel_resident). The
CUDA kernel is csrc/transition.cu: reduce GEMM, stride-2 3x3 through a
strided im2col gathered in shared memory, and one GEMM over the combined
[h2 | x[::2, ::2]] rows with the expand and projection weights fused
offline; the plain twin runs the same three products in PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn_plain


def fuse_transition_weights(params: Dict):
    """Fold the expand and projection BN scales into their weights and
    stack them: wep = [w_expand * s_expand; w_proj * s_proj] (Cmid + Cin,
    Cout), bep = b_expand + b_proj as (1, Cout), so that
    (h2 @ we) * s3 + b3 + (xs @ wp) * sp + bp == [h2 | xs] @ wep + bep.
    A copy of the JAX package's fuse_transition_weights, on tensors."""
    cout = params["w_expand"].shape[1]
    wep = torch.cat([params["w_expand"] * params["s_expand"][None, :],
                     params["w_proj"] * params["s_proj"][None, :]], dim=0)
    bep = (params["b_expand"] + params["b_proj"]).reshape(1, cout)
    return wep.contiguous(), bep


def strided_im2col(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, ceil(H/2), ceil(W/2), 9*C) stride-2 3x3 patches
    (pad 1 top/left, zeros past the bottom/right), columns ordered
    (3r + s) * C + c like direct_filter's rows."""
    _, h, w, _ = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    xp = F.pad(x, (0, 0, 1, 1 + 2 * wo - w, 1, 1 + 2 * ho - h))
    return torch.cat(
        [xp[:, r : r + 2 * ho : 2, s : s + 2 * wo : 2, :] for r in range(3) for s in range(3)],
        dim=-1,
    )


def _fused(params: Dict):
    if "wep" in params:
        return params["wep"], params["bep"]
    return fuse_transition_weights(params)


def transition_block_fused_plain(x, params: Dict) -> torch.Tensor:
    """Reduce GEMM, strided im2col GEMM, then [h2 | x[::2, ::2]] @ wep + bep
    and ReLU, in plain PyTorch. x: (N, H, W, Cin)."""
    wep, bep = _fused(params)
    h = conv1x1_bn_plain(x, params["w_reduce"], params["s_reduce"], params["b_reduce"], True)
    h = conv1x1_bn_plain(strided_im2col(h), params["w9_mid"], params["s_mid"], params["b_mid"], True)
    h2xs = torch.cat([h, x[:, ::2, ::2, :]], dim=-1)
    return torch.relu(torch.matmul(h2xs, wep) + bep[0])


@functools.lru_cache(maxsize=None)
def _workspace_floats(device_index: int, n, h, w, cin, cmid, cout) -> int:
    lib = _build.library("transition")
    floats = ctypes.c_longlong(0)
    c = _build.cint
    with torch.cuda.device(device_index):
        err = lib.transition_block_workspace(
            c(n), c(h), c(w), c(cin), c(cmid), c(cout), ctypes.byref(floats))
    _build.check_error(lib, "transition_block_workspace", err)
    return floats.value


def transition_block_fused(x, params: Dict, resident=None) -> torch.Tensor:
    """One-launch stride-2 transition block. x: (H, W, Cin) or
    (N, H, W, Cin); params w_reduce/s_reduce/b_reduce, w9_mid/s_mid/b_mid
    and either the fused wep/bep or w_expand/s_expand/b_expand with
    w_proj/s_proj/b_proj. Returns (..., ceil(H/2), ceil(W/2), Cout).
    resident is accepted for parity with the JAX package's tile-outer
    layout and changes nothing: the CUDA kernel already reads each weight
    once for the whole batch. CPU tensors run the plain version; CUDA
    tensors launch csrc/transition.cu."""
    del resident
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, cin = x.shape
    cin_w, cmid = params["w_reduce"].shape
    if cin_w != cin:
        raise ValueError(f"w_reduce {tuple(params['w_reduce'].shape)} does not take {cin} channels")
    if x.device.type == "cpu":
        out = transition_block_fused_plain(x, params)
        return out[0] if squeeze else out
    wep, bep = _fused(params)
    cout = wep.shape[1]
    for t, shape in ((params["w9_mid"], (9 * cmid, cmid)), (wep, (cmid + cin, cout)),
                     (bep, (1, cout))):
        if tuple(t.shape) != shape:
            raise ValueError(f"operand {tuple(t.shape)}, want {shape}")
    _build.check_operands(params["s_reduce"], params["b_reduce"], cmid, x, params["w_reduce"])
    _build.check_operands(params["s_mid"], params["b_mid"], cmid, x, params["w9_mid"], wep, bep)
    floats = _workspace_floats(x.device.index, n, h, w, cin, cmid, cout)
    ws = torch.empty(floats, device=x.device, dtype=torch.float32)
    out = torch.empty(n, -(-h // 2), -(-w // 2), cout, device=x.device, dtype=torch.float32)
    p, c = _build.ptr, _build.cint
    _build.launch(
        "transition", "transition_block", (n, h, w, cin, cmid, cout), x.device,
        p(x), p(params["w_reduce"]), p(params["s_reduce"]), p(params["b_reduce"]),
        p(params["w9_mid"]), p(params["s_mid"]), p(params["b_mid"]), p(wep), p(bep),
        p(out), p(ws), ctypes.c_longlong(floats),
        c(n), c(h), c(w), c(cin), c(cmid), c(cout),
    )
    return out[0] if squeeze else out
