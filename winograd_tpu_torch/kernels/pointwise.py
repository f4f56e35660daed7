"""Fused 1x1 conv + folded BN (+ReLU): the pointwise kernel and its plain twin.

Port of winograd_tpu/kernels/pointwise.py::conv1x1_bn_pallas. The CUDA
kernel is csrc/pointwise.cu: 3xTF32 wgmma tiles (csrc/wgmma_tile.cuh), or
a GEMV at a few rows (csrc/gemv_cluster.cuh), the K splits of a tile one
thread-block cluster on both, K split by split_plan.

A bfloat16 weight selects the bf16w tier (the JAX op at precision="bf16w"):
the f32 activation is split into two bf16 halves and each is multiplied by
the bf16 weight in f32 (split_dot_bf16w, the plain arithmetic, which the
port's other plain GEMMs share through weight_matmul); on the card the same
plan runs csrc/pointwise.cu's bf16w instantiation.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.splitk import H100_SMS, pow2_split, split_k

# The plan of a csrc/pointwise.cu launch. The kernel's geometry, which its
# C entry checks every plan against (kGemvCols, gemv_cluster.cuh's kMaxP,
# kStep and kClusterMax, wg::kBM, wg::kBK, wgc::kClusterPortable;
# tests/test_torch_splitk.py reads them from the sources): rows at or below
# GEMV_MAX_ROWS take the GEMV, on column tiles GEMV_COLS or GEMV_COLS // 2
# wide; above, MMA_TILE x MMA_TILE tiles. On both paths the K splits of a
# tile are the blocks of one thread-block cluster and meet in its shared
# memory: no workspace. The GEMV's rule: a power of two of K splits, each
# a multiple of SPLIT_STEP at least MIN_CHUNK long, until the column tiles
# x splits reach about one block an SM, at most GEMV_CLUSTER_MAX (past
# CLUSTER_MAX a non-portable cluster, taken only where the card holds all
# the tiles' clusters at once; else the tiles are halved, twice as many,
# and a portable cluster each). The MMA path's rule: K is split until tiles
# x splits reach about MMA_BLOCKS_PER_SM blocks an SM (two of its blocks fit
# an SM), in ranges of at least SPLIT_STEP (the tile's stage), at most
# CLUSTER_MAX (a portable cluster). Both rules were tuned on the served
# shapes by tools/chip_split_sweep.py (PERF.md). csrc/direct.cu runs the
# MMA path's kernel (csrc/wgmma_cluster.cuh) on an implicit im2col under a
# rule of its own (kernels/direct.py::direct_plan).
GEMV_MAX_ROWS = 8
GEMV_COLS = 128
MMA_TILE = 64
SPLIT_STEP = 32
MIN_CHUNK = 64
CLUSTER_MAX = 8
GEMV_CLUSTER_MAX = 16
MMA_BLOCKS_PER_SM = 2


class Plan(NamedTuple):
    """How csrc/pointwise.cu runs one (P, K, N) product."""

    gemv: bool
    tile: int    # width of the output tiles: GEMV_COLS or half of it, or MMA_TILE
    tiles: int   # output tiles: column tiles of the GEMV, MMA tiles else
    splits: int
    chunk: int


def gemv_split(k: int, n: int, sms: int, wide_clusters: int | None = None, cols: int = 0,
               want: int = 0) -> tuple:
    """The heads' GEMV rule (csrc/gemv_cluster.cuh, shared with the int8
    GEMV): (column width, column tiles, Split) of a K x N product on `sms`
    SMs; `wide_clusters`: the clusters of GEMV_CLUSTER_MAX blocks the card
    holds at once (None: not asked, taken to hold them all); `cols` and
    `want` force a width and a number of wanted K ranges (a power of two
    of them is taken)."""
    width = cols or GEMV_COLS
    tiles = -(-n // width)
    split = pow2_split(k, min(want or sms // tiles, GEMV_CLUSTER_MAX), SPLIT_STEP,
                       SPLIT_STEP if want else MIN_CHUNK)
    if (not cols and split.splits > CLUSTER_MAX and wide_clusters is not None
            and wide_clusters < tiles):
        width = GEMV_COLS // 2
        tiles = -(-n // width)
        split = pow2_split(k, min(want or sms // tiles, CLUSTER_MAX), SPLIT_STEP, MIN_CHUNK)
    return width, tiles, split


def split_plan(p: int, k: int, n: int, sms: int = H100_SMS,
               wide_clusters: int | None = None) -> Plan:
    """The path, the output tiles and the K split of a (p, k) x (k, n)
    product on a card with `sms` SMs (the GEMV's `wide_clusters` as
    gemv_split takes it)."""
    if p <= GEMV_MAX_ROWS:
        width, tiles, split = gemv_split(k, n, sms, wide_clusters)
        return Plan(True, width, tiles, split.splits, split.chunk)
    tiles = -(-p // MMA_TILE) * -(-n // MMA_TILE)
    split = split_k(k, min(MMA_BLOCKS_PER_SM * sms // tiles, CLUSTER_MAX), SPLIT_STEP,
                    SPLIT_STEP)
    return Plan(False, MMA_TILE, tiles, split.splits, split.chunk)


@functools.lru_cache(maxsize=None)
def _gemv_clusters(index: int, name: str, entry: str, *args) -> int:
    lib = _build.library(name)
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = getattr(lib, entry)(*map(_build.cint, args), ctypes.byref(count))
    _build.check_error(lib, entry, err)
    return count.value


def gemv_clusters(device: torch.device, name: str = "pointwise", *args) -> int | None:
    """The clusters of GEMV_CLUSTER_MAX blocks on GEMV_COLS-wide tiles that
    a CUDA device holds at once (cudaOccupancyMaxActiveClusters of the GEMV
    of library `name`: "pointwise", args (1,) for its bf16w instantiation,
    or "pointwise_int8"); None for another device, which has none to ask."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _gemv_clusters(index, name, f"{name}_gemv_clusters", *args, GEMV_COLS,
                          GEMV_CLUSTER_MAX)


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
    wide = (gemv_clusters(x.device, "pointwise", int(w.dtype == torch.bfloat16))
            if p <= GEMV_MAX_ROWS else None)
    return conv1x1_bn_planned(x, w, scale, bias, relu,
                              split_plan(p, cin, cout, _build.sm_count(x.device), wide))


def conv1x1_bn_planned(x, w, scale, bias, relu: bool, plan: Plan) -> torch.Tensor:
    """conv1x1_bn's launch on CUDA tensors under an explicit plan (the
    wrapper passes split_plan's; tools/chip_split_sweep.py times others);
    a bfloat16 w launches the bf16w instantiation, counted as
    "pointwise_bf16w". Operands as conv1x1_bn checks them."""
    cin, cout = w.shape
    p = x.numel() // cin
    out = torch.empty(*x.shape[:-1], cout, device=x.device, dtype=torch.float32)
    c = _build.cint
    bf16w = w.dtype == torch.bfloat16
    _build.launch(
        "pointwise", "pointwise_conv1x1_bn_bf16w" if bf16w else "pointwise_conv1x1_bn",
        (p, cin, cout, bool(relu)), x.device,
        _build.ptr(x), _build.ptr(w), _build.ptr(scale), _build.ptr(bias), _build.ptr(out),
        c(p), c(cin), c(cout), c(relu), c(plan.gemv), c(plan.tile), c(plan.splits),
        c(plan.chunk),
        counter="pointwise_bf16w" if bf16w else None,
    )
    return out
