"""A run of identity bottleneck blocks over all images in one launch.

Port of winograd_tpu/kernels/stage.py::resnet_stage_fused_pallas (both its
kernels, _stage_kernel and _stage_kernel_resident). The CUDA kernel is
csrc/stage.cu, a persistent kernel whose phases (reduce GEMM, 3x3, expand
GEMM + residual + ReLU) run over all N*H*W rows, one grid barrier apart,
its GEMM phases on csrc/wgmma_tile.cuh's tiles; its grid and every GEMM
phase's K split are stage_plan's. The plain twin runs the same chain block
by block with the plain versions of the per-layer kernels.

bfloat16 weights (w_reduce, the mid's w9_mid or u2_mid, w_expand; BN stays
float32) select the bf16w tier, the JAX kernel at precision="bf16w": the
kernel's bf16w instantiation (every product on the f32 activation split
into two bf16 halves, csrc/wgmma_tile.cuh's bf16 tile), and in the plain twin
pointwise.py::split_dot_bf16w's arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple

import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct_plain
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn_plain
from winograd_tpu_torch.kernels.splitk import H100_SMS, Split
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd_plain, winograd_plan

# Stride-1 3x3s on maps of at least this many pixels run Winograd F(2,3);
# smaller maps run the direct implicit GEMM. The JAX package's rule
# (kernels/stage.py mid_algo="auto"); not re-derived on the H100.
WINOGRAD_MIN_PIXELS = 28 * 28

STAGE_KEYS = (
    "w_reduce", "s_reduce", "b_reduce", "w9_mid", "s_mid", "b_mid",
    "w_expand", "s_expand", "b_expand",
)


def stack_stage_params(blocks: List[Dict]) -> Dict[str, torch.Tensor]:
    """Stack per-block params on a leading block axis (BN as (B, 1, C)),
    each in its own dtype (bfloat16 weights stay bfloat16); the F(2,3)
    filter u2_mid is stacked too when every block has it, enabling the
    winograd2 mid-layer. A copy of the JAX package's stack_stage_params, on
    tensors."""
    keys = STAGE_KEYS + (("u2_mid",) if all("u2_mid" in p for p in blocks) else ())
    out = {}
    for key in keys:
        ts = [torch.as_tensor(p[key]) for p in blocks]
        if ts[0].dim() == 1:
            ts = [t.reshape(1, -1) for t in ts]
        out[key] = torch.stack(ts).contiguous()
    return out


def resolve_mid_algo(mid_algo: str, stacked: Dict, h: int, w: int) -> str:
    """"auto" takes F(2,3) ("winograd2") when u2_mid is there and the map
    has at least WINOGRAD_MIN_PIXELS pixels, else "direct"."""
    if mid_algo == "auto":
        return "winograd2" if "u2_mid" in stacked and h * w >= WINOGRAD_MIN_PIXELS else "direct"
    if mid_algo not in ("direct", "winograd2"):
        raise ValueError(f"unknown mid_algo {mid_algo!r}")
    if mid_algo == "winograd2" and "u2_mid" not in stacked:
        raise ValueError("mid_algo 'winograd2' needs the F(2,3) filter u2_mid")
    return mid_algo


def resnet_stage_fused_plain(x, stacked: Dict, mid_algo: str = "auto") -> torch.Tensor:
    """The stage block by block in plain PyTorch; the F(2,3) mid runs the
    Winograd algebra on u2_mid. x: (N, H, W, Cio)."""
    mid_algo = resolve_mid_algo(mid_algo, stacked, x.shape[-3], x.shape[-2])
    for b in range(stacked["w_reduce"].shape[0]):
        h = conv1x1_bn_plain(
            x, stacked["w_reduce"][b], stacked["s_reduce"][b, 0], stacked["b_reduce"][b, 0], True)
        if mid_algo == "winograd2":
            h = conv3x3_bn_winograd_plain(
                h, stacked["u2_mid"][b], stacked["s_mid"][b, 0], stacked["b_mid"][b, 0])
        else:
            h = conv3x3_bn_direct_plain(
                h, stacked["w9_mid"][b], stacked["s_mid"][b, 0], stacked["b_mid"][b, 0])
        h = conv1x1_bn_plain(
            h, stacked["w_expand"][b], stacked["s_expand"][b, 0], stacked["b_expand"][b, 0], False)
        x = torch.relu(h + x)
    return x


# The plan of a csrc/stage.cu launch. The kernel's geometry, which its C
# entry checks every plan against (kMaxBlocksPerSm, wg::kBM, wg::kBN, wg::kBK;
# tests/test_torch_stage_plan.py reads them from the sources):
# a cooperative grid of at most STAGE_BLOCKS_PER_SM blocks an SM, 64 x 64
# output tiles, K splits each a multiple of STAGE_STEP but the last. The
# plan's own rule, per GEMM phase: about one work item (tile, split) a
# block, and K cut further until no item walks more than STAGE_MAX_WALK of
# it while the phase's tiles leave blocks idle, or STAGE_FULL_WALK once they
# fill the grid; at least STAGE_MIN_CHUNK of K a split and at most
# STAGE_MAX_SPLITS splits (their partial sums cross device memory behind a
# grid barrier). Re-derived for the wgmma tile by tools/chip_split_sweep.py
# at N = 1, 8 and 32 (PERF.md).
STAGE_BLOCKS_PER_SM = 2
STAGE_TILE = 64
STAGE_STEP = 32
STAGE_MIN_CHUNK = 128
STAGE_MAX_SPLITS = 16
STAGE_MAX_WALK = 512
STAGE_FULL_WALK = 2048


class StagePlan(NamedTuple):
    """How csrc/stage.cu runs one stage: its grid and the K split of each
    GEMM phase (the mid's is unused under the F(2,3) mid, which takes the
    per-layer Winograd's Cin cut)."""

    grid: int
    reduce: Split
    mid: Split
    expand: Split

    def phases(self) -> tuple:
        """The six integers the C entry takes: each phase's splits, chunk."""
        return (*self.reduce, *self.mid, *self.expand)


def stage_phase(p: int, k: int, n: int, grid: int, max_walk: int = STAGE_MAX_WALK,
                full_walk: int = STAGE_FULL_WALK) -> Split:
    """The K split of a (p, k) x (k, n) GEMM phase on a grid of `grid`
    blocks: about one item a block, no item walking more than max_walk of K
    (full_walk once the tiles fill the grid), splits at least
    STAGE_MIN_CHUNK long and a multiple of STAGE_STEP but the last, at most
    STAGE_MAX_SPLITS."""
    tiles = -(-p // STAGE_TILE) * -(-n // STAGE_TILE)
    walk = max_walk if tiles < grid else full_walk
    want = max(grid // tiles, -(-k // walk))
    splits = min(want, k // STAGE_MIN_CHUNK, STAGE_MAX_SPLITS)
    if splits < 2:
        return Split(1, k)
    chunk = -(-k // splits)
    chunk = -(-chunk // STAGE_STEP) * STAGE_STEP
    return Split(-(-k // chunk), chunk)


def stage_plan(n: int, h: int, w: int, cio: int, cmid: int, sms: int = H100_SMS,
               max_walk: int = STAGE_MAX_WALK, full_walk: int = STAGE_FULL_WALK) -> StagePlan:
    """The grid and the reduce, direct-mid and expand splits of a stage over
    (n, h, w, cio) with cmid bottleneck channels on a card with `sms` SMs."""
    grid = STAGE_BLOCKS_PER_SM * sms
    p = n * h * w
    return StagePlan(grid, stage_phase(p, cio, cmid, grid, max_walk, full_walk),
                     stage_phase(p, 9 * cmid, cmid, grid, max_walk, full_walk),
                     stage_phase(p, cmid, cio, grid, max_walk, full_walk))


@functools.lru_cache(maxsize=None)
def _workspace_floats(device_index: int, n, h, w, cio, cmid, wino, splits, chunk, grid,
                      phases: tuple) -> int:
    lib = _build.library("stage")
    floats = ctypes.c_longlong(0)
    c = _build.cint
    with torch.cuda.device(device_index):
        err = lib.resnet_stage_workspace(
            c(n), c(h), c(w), c(cio), c(cmid), c(wino), c(splits), c(chunk), c(grid),
            (ctypes.c_int * 6)(*phases), ctypes.byref(floats))
    _build.check_error(lib, "resnet_stage_workspace", err)
    return floats.value


@_build.checked("stage", "stage_bf16w")
def resnet_stage_fused(x, stacked: Dict, mid_algo: str = "auto",
                       resident=None) -> torch.Tensor:
    """B identity bottleneck blocks in one launch.

    x: (H, W, Cio) or (N, H, W, Cio); stacked from stack_stage_params.
    mid_algo: "winograd2" (F(2,3) on u2_mid), "direct" (w9_mid) or "auto"
    (resolve_mid_algo). resident is accepted for parity with the JAX
    package's weight-resident layout and changes nothing: the CUDA kernel
    already reads each block's weights once for the whole batch. bfloat16
    weights run the bf16w tier (module docstring; x float32). CPU tensors
    run the plain version; CUDA tensors launch csrc/stage.cu."""
    del resident
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, cio = x.shape
    nb, cio_w, cmid = stacked["w_reduce"].shape
    if cio_w != cio:
        raise ValueError(f"w_reduce {tuple(stacked['w_reduce'].shape)} does not take {cio} channels")
    mid_algo = resolve_mid_algo(mid_algo, stacked, h, w)
    if x.device.type == "cpu":
        out = resnet_stage_fused_plain(x, stacked, mid_algo)
        return out[0] if squeeze else out
    wino = mid_algo == "winograd2"
    mid_key, mid_shape = (
        ("u2_mid", (nb, 16, cmid, cmid)) if wino else ("w9_mid", (nb, 9 * cmid, cmid)))
    keys = ("w_reduce", "s_reduce", "b_reduce", mid_key, "s_mid", "b_mid",
            "w_expand", "s_expand", "b_expand")
    want = (None, (nb, 1, cmid), (nb, 1, cmid), mid_shape, (nb, 1, cmid), (nb, 1, cmid),
            (nb, cmid, cio), (nb, 1, cio), (nb, 1, cio))
    for key, shape in zip(keys, want):
        if shape is not None and tuple(stacked[key].shape) != shape:
            raise ValueError(f"{key} {tuple(stacked[key].shape)}, want {shape}")
    ops = [x] + [stacked[k] for k in keys]
    bf16w = stacked["w_reduce"].dtype == torch.bfloat16
    if bf16w:
        _build.check_bf16w(x)
        weight_keys = ("w_reduce", mid_key, "w_expand")
        _build.check_tensors(*(stacked[k] for k in weight_keys), dtype=torch.bfloat16,
                             device=x.device)
        _build.check_tensors(x, *(stacked[k] for k in keys if k not in weight_keys))
    else:
        _build.check_tensors(*ops)
    out = _launch(x, ops, wino, bf16w,
                  stage_plan(n, h, w, cio, cmid, _build.sm_count(x.device)))
    return out[0] if squeeze else out


def resnet_stage_fused_planned(x, stacked: Dict, mid_algo: str, plan: StagePlan):
    """resnet_stage_fused's launch on CUDA tensors (N, H, W, Cio) under an
    explicit plan (the wrapper passes stage_plan's; tools/chip_split_sweep.py
    times others); mid_algo "direct" or "winograd2", operands as the wrapper
    checks them."""
    wino = resolve_mid_algo(mid_algo, stacked, x.shape[1], x.shape[2]) == "winograd2"
    keys = ("w_reduce", "s_reduce", "b_reduce", "u2_mid" if wino else "w9_mid", "s_mid",
            "b_mid", "w_expand", "s_expand", "b_expand")
    return _launch(x, [x] + [stacked[k] for k in keys], wino,
                   stacked["w_reduce"].dtype == torch.bfloat16, plan)


def _launch(x, ops, wino: bool, bf16w: bool, plan: StagePlan):
    n, h, w, cio = x.shape
    nb, _, cmid = ops[1].shape
    # The F(2,3) mid's Cin split: the per-layer Winograd's plan for Cmid
    # (the kernel's grid is as many blocks an SM as that plan's).
    cut = winograd_plan(n, h, w, cmid, cmid, 2, _build.sm_count(x.device))
    phases = plan.phases()
    floats = _workspace_floats(x.device.index, n, h, w, cio, cmid, int(wino), cut.splits,
                               cut.chunk, plan.grid, phases)
    ws = torch.empty(floats, device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    c = _build.cint
    _build.launch(
        "stage", "resnet_stage_bf16w" if bf16w else "resnet_stage",
        (n, h, w, cio, cmid, nb, "winograd2" if wino else "direct"), x.device,
        *map(_build.ptr, ops), _build.ptr(out),
        _build.ptr(ws), ctypes.c_longlong(floats),
        c(n), c(h), c(w), c(cio), c(cmid), c(nb), c(wino), c(cut.splits), c(cut.chunk),
        c(plan.grid), (ctypes.c_int * 6)(*phases),
        counter="stage_bf16w" if bf16w else None,
    )
    return out
