"""Fused 1x1 conv + folded BN (+ReLU): the pointwise kernel and its plain twin.

Port of winograd_tpu/kernels/pointwise.py::conv1x1_bn_pallas. The CUDA
kernel is csrc/pointwise.cu: 3xTF32 tensor-core tiles, or a GEMV at a few
rows, with K split over blocks by split_plan.

A bfloat16 weight selects the bf16w tier (the JAX op at precision="bf16w"):
the f32 activation is split into two bf16 halves and each is multiplied by
the bf16 weight in f32 (split_dot_bf16w, the plain arithmetic, which the
port's other plain GEMMs share through weight_matmul); on the card the same
plan runs csrc/pointwise.cu's bf16w instantiation.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.splitk import H100_SMS, split_k

# The plan of a csrc/pointwise.cu launch. The kernel's geometry, which its
# C entry checks every plan against (kGemvMaxP, kGemvCols, tc::kBM,
# kSplitStep; tests/test_torch_splitk.py reads them from the sources): rows
# at or below GEMV_MAX_ROWS take the GEMV (blocks of GEMV_COLS columns);
# above, MMA_TILE x MMA_TILE tiles. The plan's own rule: K is split until
# tiles x splits reach about one block an SM, in multiples of SPLIT_STEP
# (the MMA tile's cp.async stage) at least MIN_CHUNK long, and not below
# MMA_SPLIT_MIN_K, where a split costs more (workspace, counter, reduction)
# than it saves; the tile counters' room is rounded up to COUNTER_WORDS.
# The split rule was tuned on the served shapes by tools/chip_split_sweep.py
# (PERF.md).
GEMV_MAX_ROWS = 8
GEMV_COLS = 128
MMA_TILE = 64
SPLIT_STEP = 32
MMA_SPLIT_MIN_K = 256
MIN_CHUNK = 64
COUNTER_WORDS = 64


class Plan(NamedTuple):
    """How csrc/pointwise.cu runs one (P, K, N) product."""

    gemv: bool
    tile: int    # width of the output tiles: GEMV_COLS or MMA_TILE
    tiles: int   # output tiles: column tiles of the GEMV, MMA tiles else
    splits: int
    chunk: int

    def counter_words(self) -> int:
        """Words of the tile counters at the workspace's start, where the
        partial sums begin; none at one split."""
        return 0 if self.splits == 1 else -(-self.tiles // COUNTER_WORDS) * COUNTER_WORDS

    def workspace_words(self, p: int, n: int) -> int:
        """4-byte words of workspace: the tile counters, then splits x P x N
        partial sums; none at one split."""
        return 0 if self.splits == 1 else self.counter_words() + self.splits * p * n


def split_plan(p: int, k: int, n: int, sms: int = H100_SMS) -> Plan:
    """The path, the output tiles and the K split of a (p, k) x (k, n)
    product on a card with `sms` SMs."""
    gemv = p <= GEMV_MAX_ROWS
    if gemv:
        tile, tiles = GEMV_COLS, -(-n // GEMV_COLS)
    else:
        tile, tiles = MMA_TILE, -(-p // MMA_TILE) * -(-n // MMA_TILE)
    want = sms // tiles if gemv or k >= MMA_SPLIT_MIN_K else 1
    split = split_k(k, want, SPLIT_STEP, MIN_CHUNK)
    return Plan(gemv, tile, tiles, split.splits, split.chunk)


def split_dot_bf16w(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w at the bf16w tier, in float32: a_hi = bf16(a) and a_lo =
    bf16(a - a_hi) (round to nearest even), then a_hi @ w + a_lo @ w with
    every product exact. The port of winograd_tpu/kernels/direct.py::
    split_dot(a, w, "bf16w"). w: bfloat16; a: float32, else ValueError."""
    if w.dtype != torch.bfloat16:
        raise ValueError(f"split_dot_bf16w takes bfloat16 weights, got {w.dtype}")
    if a.dtype != torch.float32:
        raise ValueError(f"bfloat16 weights take a float32 activation, got {a.dtype}")
    a_hi = a.to(torch.bfloat16).float()
    a_lo = (a - a_hi).to(torch.bfloat16).float()
    wf = w.float()
    return torch.matmul(a_hi, wf) + torch.matmul(a_lo, wf)


def weight_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w as the plain versions compute it: torch.matmul, or
    split_dot_bf16w for a bfloat16 weight."""
    return split_dot_bf16w(a, w) if w.dtype == torch.bfloat16 else torch.matmul(a, w)


def conv1x1_bn_plain(x, w, scale, bias, relu: bool) -> torch.Tensor:
    """(..., Cin) @ (Cin, Cout) * scale + bias (+ReLU), in x's dtype
    (weight_matmul: bf16w for a bfloat16 w)."""
    y = weight_matmul(x, w) * scale + bias
    return torch.relu(y) if relu else y


@_build.checked("pointwise", "pointwise_bf16w")
def conv1x1_bn(x, w, scale, bias, relu: bool) -> torch.Tensor:
    """Fused pointwise conv + BN (+ReLU).

    x: (..., Cin); w: (Cin, Cout), float32, or bfloat16 for the bf16w tier
    (x float32); scale, bias: (Cout,). Returns x.shape[:-1] + (Cout,). CPU
    tensors run the plain version; CUDA tensors launch csrc/pointwise.cu
    (contiguous operands, float32 but for a bfloat16 w)."""
    cin, cout = w.shape
    if x.shape[-1] != cin:
        raise ValueError(f"x channels {x.shape[-1]} != weight Cin {cin}")
    if x.device.type == "cpu":
        return conv1x1_bn_plain(x, w, scale, bias, relu)
    if w.dtype == torch.bfloat16:
        _build.check_bf16w(x)
        _build.check_tensors(w, dtype=torch.bfloat16, device=x.device)
        _build.check_operands(scale, bias, cout, x)
    else:
        _build.check_operands(scale, bias, cout, x, w)
    p = x.numel() // cin
    return conv1x1_bn_planned(x, w, scale, bias, relu,
                              split_plan(p, cin, cout, _build.sm_count(x.device)))


def conv1x1_bn_planned(x, w, scale, bias, relu: bool, plan: Plan) -> torch.Tensor:
    """conv1x1_bn's launch on CUDA tensors under an explicit plan (the
    wrapper passes split_plan's; tools/chip_split_sweep.py times others);
    a bfloat16 w launches the bf16w instantiation, counted as
    "pointwise_bf16w". Operands as conv1x1_bn checks them."""
    cin, cout = w.shape
    p = x.numel() // cin
    words = plan.workspace_words(p, cout)
    ws = torch.empty(words, device=x.device, dtype=torch.float32) if words else None
    out = torch.empty(*x.shape[:-1], cout, device=x.device, dtype=torch.float32)
    c = _build.cint
    bf16w = w.dtype == torch.bfloat16
    _build.launch(
        "pointwise", "pointwise_conv1x1_bn_bf16w" if bf16w else "pointwise_conv1x1_bn",
        (p, cin, cout, bool(relu)), x.device,
        _build.ptr(x), _build.ptr(w), _build.ptr(scale), _build.ptr(bias),
        _build.ptr(out), _build.ptr(ws) if ws is not None else ctypes.c_void_p(0),
        ctypes.c_longlong(words), ctypes.c_longlong(plan.counter_words()), c(p), c(cin),
        c(cout), c(relu), c(plan.gemv), c(plan.tile), c(plan.splits), c(plan.chunk),
        counter="pointwise_bf16w" if bf16w else None,
    )
    return out
