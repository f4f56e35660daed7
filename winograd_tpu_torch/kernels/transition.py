"""The stride-2 ResNet transition block in one launch.

Port of winograd_tpu/kernels/transition.py::transition_block_fused_pallas
(both its kernels, _transition_kernel and _transition_kernel_resident). The
CUDA kernel is csrc/transition.cu: a cooperative launch of three GEMM
phases on the wgmma tiles (csrc/wgmma_phase.cuh, shared with the stage:
3xTF32 wgmma, weights by TMA): the reduce, the stride-2 3x3 on an implicit
strided im2col, and one GEMM over the combined [h2 | x[::2, ::2]] rows with
the expand and projection weights fused offline, each phase's K split by
transition_plan; the plain twin runs the same three products in PyTorch.

bfloat16 weights (w_reduce, w9_mid and the fused wep; BN and bep stay
float32) select the bf16w tier, the JAX kernel at precision="bf16w": the
kernel's bf16w instantiation (bf16 wgmma on the weights' TMA boxes, the
activation split into two bf16 halves, under the same plan), and in the
plain twin pointwise.py::split_dot_bf16w's arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn_plain, weight_matmul
from winograd_tpu_torch.kernels.splitk import H100_SMS, Split, split_k


def fuse_transition_weights(params: Dict):
    """Fold the expand and projection BN scales into their weights and
    stack them: wep = [w_expand * s_expand; w_proj * s_proj] (Cmid + Cin,
    Cout), bep = b_expand + b_proj as (1, Cout), so that
    (h2 @ we) * s3 + b3 + (xs @ wp) * sp + bp == [h2 | xs] @ wep + bep.
    A copy of the JAX package's fuse_transition_weights, on tensors. wep
    keeps the weights' dtype: bfloat16 weights are folded in float32 and
    the fold rounded to bfloat16 once (the bf16w tier's cast_bf16w folds
    the float32 weights first, as the JAX kernel does)."""
    cout = params["w_expand"].shape[1]
    wdt = params["w_expand"].dtype
    s3, sp = params["s_expand"][None, :], params["s_proj"][None, :]
    wep = torch.cat([params["w_expand"].to(s3.dtype) * s3,
                     params["w_proj"].to(sp.dtype) * sp], dim=0).to(wdt)
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
    return torch.relu(weight_matmul(h2xs, wep) + bep[0])


# The plan of a csrc/transition.cu launch. The kernel's geometry, which its
# C entry checks every plan against (tests/test_torch_splitk.py and
# tests/test_torch_transition_plan.py read it from the sources):
# TRANSITION_TILE x TRANSITION_TILE output tiles (wgmma_tile.cuh's kBM, kBN),
# splits in multiples of TRANSITION_STEP (its kBK, a stage of the tile), a
# cooperative grid of at most TRANSITION_BLOCKS_PER_SM blocks an SM
# (transition.cu's kMaxBlocksPerSm). The plan's own rule: each phase splits
# K until tiles x splits reach about one item a block; a phase whose tiles
# fill less than half the grid splits further, until no item walks more
# than TRANSITION_MAX_WALK of K (a walk is latency bound); and whatever the
# tiles, no item sums more than TRANSITION_MAX_SUM of K (the tensor cores'
# f32 accumulation drifts with a walk's length: unsplit at N=32, the basic
# stage's (1568, 4608) x (4608, 512) convs came 1.8e-3 from their plain twin
# against a bar of 1.76e-3, 1.9e-4 at N=8 in ranges of 512; PERF.md, fault
# C2); at most TRANSITION_MAX_SPLITS ranges, each at least
# TRANSITION_MIN_CHUNK long. tools/chip_split_sweep.py timed one phase's
# split at a time at the served shapes (PERF.md): the walk cap pays where
# the tiles are few (the N=8 14->7 mid) and costs where they fill the grid
# (its reduce and expand), and 29 ranges beat 16 for the N=1 14->7 mid.
TRANSITION_TILE = 64
TRANSITION_STEP = 32
TRANSITION_BLOCKS_PER_SM = 2
TRANSITION_MAX_WALK = 512
TRANSITION_MAX_SUM = 2048
TRANSITION_MAX_SPLITS = 32
TRANSITION_MIN_CHUNK = 128


class TransitionPlan(NamedTuple):
    """How csrc/transition.cu runs one transition: the cooperative grid's
    blocks and the K split of its reduce (K = Cin), mid (9 * Cmid) and
    expand (Cmid + Cin)."""

    blocks: int
    reduce: Split
    mid: Split
    expand: Split

    def args(self) -> tuple:
        """The plan as the C entry takes it: blocks, then (splits, chunk) of
        the reduce, the mid and the expand."""
        return (self.blocks,) + self.reduce + self.mid + self.expand


def phase_split(p: int, k: int, cols: int, blocks: int) -> Split:
    """The K split of a (p, k) x (k, cols) GEMM phase of a persistent
    3xTF32 kernel on a grid of `blocks` blocks, by the rule above (also
    csrc/basic_stage.cu's, kernels/basic_stage.py::basic_stage_plan)."""
    tiles = -(-p // TRANSITION_TILE) * -(-cols // TRANSITION_TILE)
    want = max(blocks // tiles, -(-k // TRANSITION_MAX_SUM))
    if 2 * tiles < blocks:
        want = max(want, -(-k // TRANSITION_MAX_WALK))
    return split_k(k, min(want, TRANSITION_MAX_SPLITS), TRANSITION_STEP, TRANSITION_MIN_CHUNK)


def transition_plan(n: int, h: int, w: int, cin: int, cmid: int, cout: int,
                    sms: int = H100_SMS) -> TransitionPlan:
    """The grid and K splits of an (n, h, w, cin) -> cmid -> cout transition
    on a card with `sms` SMs."""
    p1, p2 = n * h * w, n * -(-h // 2) * -(-w // 2)
    blocks = TRANSITION_BLOCKS_PER_SM * sms
    return TransitionPlan(blocks, phase_split(p1, cin, cmid, blocks),
                          phase_split(p2, 9 * cmid, cmid, blocks),
                          phase_split(p2, cmid + cin, cout, blocks))


@functools.lru_cache(maxsize=None)
def _workspace_floats(device_index: int, n, h, w, cin, cmid, cout, *plan) -> int:
    lib = _build.library("transition")
    floats = ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        err = lib.transition_block_workspace(
            *map(_build.cint, (n, h, w, cin, cmid, cout) + plan), ctypes.byref(floats))
    _build.check_error(lib, "transition_block_workspace", err)
    return floats.value


@_build.checked("transition", "transition_bf16w")
def transition_block_fused(x, params: Dict, resident=None) -> torch.Tensor:
    """One-launch stride-2 transition block. x: (H, W, Cin) or
    (N, H, W, Cin); params w_reduce/s_reduce/b_reduce, w9_mid/s_mid/b_mid
    and either the fused wep/bep or w_expand/s_expand/b_expand with
    w_proj/s_proj/b_proj. Returns (..., ceil(H/2), ceil(W/2), Cout).
    resident is accepted for parity with the JAX package's tile-outer
    layout and changes nothing: the CUDA kernel already reads each weight
    once for the whole batch. bfloat16 weights run the bf16w tier (module
    docstring; x float32). CPU tensors run the plain version; CUDA tensors
    launch csrc/transition.cu."""
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
    if params["w_reduce"].dtype == torch.bfloat16:
        _build.check_bf16w(x)
        _build.check_tensors(params["w_reduce"], params["w9_mid"], wep, dtype=torch.bfloat16,
                             device=x.device)
        _build.check_operands(params["s_reduce"], params["b_reduce"], cmid, x)
        _build.check_operands(params["s_mid"], params["b_mid"], cmid, x, bep)
    else:
        _build.check_operands(params["s_reduce"], params["b_reduce"], cmid, x, params["w_reduce"])
        _build.check_operands(params["s_mid"], params["b_mid"], cmid, x, params["w9_mid"], wep,
                              bep)
    out = transition_block_fused_planned(
        x, params["w_reduce"], params["s_reduce"], params["b_reduce"], params["w9_mid"],
        params["s_mid"], params["b_mid"], wep, bep,
        transition_plan(n, h, w, cin, cmid, cout, _build.sm_count(x.device)))
    return out[0] if squeeze else out


def transition_block_fused_planned(x, wr, s1, b1, w9, s2, b2, wep, bep,
                                   plan: TransitionPlan) -> torch.Tensor:
    """transition_block_fused's launch on CUDA tensors under an explicit plan
    (the wrapper passes transition_plan's; tools/chip_split_sweep.py times
    others); bfloat16 weights launch the bf16w instantiation, counted as
    "transition_bf16w". x: (N, H, W, Cin); operands as
    transition_block_fused checks them."""
    n, h, w, cin = x.shape
    cmid, cout = wr.shape[1], wep.shape[1]
    floats = _workspace_floats(x.device.index, n, h, w, cin, cmid, cout, *plan.args())
    ws = torch.empty(floats, device=x.device, dtype=torch.float32)
    out = torch.empty(n, -(-h // 2), -(-w // 2), cout, device=x.device, dtype=torch.float32)
    p, c = _build.ptr, _build.cint
    bf16w = wr.dtype == torch.bfloat16
    _build.launch(
        "transition", "transition_block_bf16w" if bf16w else "transition_block",
        (n, h, w, cin, cmid, cout), x.device,
        p(x), p(wr), p(s1), p(b1), p(w9), p(s2), p(b2), p(wep), p(bep),
        p(out), p(ws), ctypes.c_longlong(floats),
        c(n), c(h), c(w), c(cin), c(cmid), c(cout), *map(c, plan.args()),
        counter="transition_bf16w" if bf16w else None,
    )
    return out
