"""Data-parallel inference and training over a ("data", "model") mesh.

Port of winograd_tpu/parallel/data_parallel.py. Every function takes the
whole batch on every rank and returns the whole result on every rank; the
batch is cut over "data" (the ranks of a "model" row compute the same
shard) and gathered back with one all_gather.

sharded_block_inference is the JAX package's XLA block (ops/torch_ops.py,
the plain operators) under block_shardings' layout, with the collectives
XLA inserts from the shardings written out: the reduce on the rank's Cin
shard, one psum, the 3x3 replicated, the expand on the rank's Cout shard
with the skip added on the local shard. sharded_block_inference_fused runs
the port's block (models/resnet.py::bottleneck_block, its kernels) on each
rank's batch shard, the weights whole on every rank.

make_train_step is the MSE-distillation step over one bottleneck block with
SGD and momentum: each rank computes the loss and the gradients of its
batch shard, and one psum over "data" averages them (pmean: the loss is a
mean over the batch, so with equal shards the step is the single-device
step on the whole batch). The JAX step also cuts the channels over "model"
through XLA's automatic partitioning of the jitted step, a collective
no code of the package writes; the port replicates the step on the ranks of
a "model" row instead (ROADMAP.md lists the channel-sharded step as still
to port). Params and momentum are updated in place, as models/train.py's
step does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from winograd_tpu_torch.baseline.cudnn import full_float32
from winograd_tpu_torch.datagen.generate import _block_params_random
from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.models.resnet import bottleneck_block, bottleneck_block_train
from winograd_tpu_torch.ops import torch_ops
from winograd_tpu_torch.parallel.mesh import (
    Mesh, all_gather, block_shardings, local_shard, pmean, psum,
)
from winograd_tpu_torch.utils.tree import tree_leaves, tree_unflatten

__all__ = [
    "average_over_data", "batch_parallel", "init_train_state", "make_train_step",
    "sgd_update", "sharded_block_inference", "sharded_block_inference_fused",
]

# The trainable keys of a block: the raw 3x3 filter; the offline layouts
# (u_mid, u2_mid, w9_mid) are re-derived after training.
TRAIN_KEYS = ("w_reduce", "s_reduce", "b_reduce", "w_mid", "s_mid", "b_mid",
              "w_expand", "s_expand", "b_expand")


def batch_parallel(mesh: Mesh, fn: Callable, x) -> torch.Tensor:
    """fn on this rank's batch shard of x (cut over "data", on the mesh's
    device), the ranks' outputs gathered along the batch: the whole fn(x)
    on every rank. x: (N, ...), N divisible by the "data" axis."""
    x_l = local_shard(torch.as_tensor(x, dtype=torch.float32), ("data",), mesh)
    return all_gather(fn(x_l), mesh, "data", dim=0)


def sharded_block_inference(mesh: Mesh, params: Dict, x) -> torch.Tensor:
    """The XLA bottleneck block (ops/torch_ops.py::bottleneck_block's
    arithmetic, raw OIHW w_mid) under block_shardings(): x cut over "data"
    and its Cio over "model", w_reduce on its rows, w_expand and its BN on
    its columns; one psum after the reduce, one all_gather of the channels
    and one of the batch at the end. Returns the whole (N, H, W, Cio)."""
    x_spec, specs = block_shardings()
    p = {k: local_shard(torch.as_tensor(params[k], dtype=torch.float32), specs[k], mesh)
         for k in TRAIN_KEYS}
    x_l = local_shard(torch.as_tensor(x, dtype=torch.float32), x_spec, mesh)
    cmid = p["w_reduce"].shape[1]
    ones = torch.ones(cmid, device=mesh.device)
    partial = torch_ops.conv1x1_bn(x_l, p["w_reduce"], ones, torch.zeros_like(ones), False)
    h = torch_ops.bn_act(psum(partial, mesh, "model"), p["s_reduce"], p["b_reduce"], True)
    h = torch_ops.conv3x3_bn_relu(h, p["w_mid"], p["s_mid"], p["b_mid"], True)
    h = torch_ops.conv1x1_bn(h, p["w_expand"], p["s_expand"], p["b_expand"], False)
    out = torch.relu(h + x_l)
    return all_gather(all_gather(out, mesh, "model", dim=-1), mesh, "data", dim=0)


def sharded_block_inference_fused(mesh: Mesh, params: Dict, x,
                                  algo3x3: str = "auto") -> torch.Tensor:
    """The port's bottleneck block (models/resnet.py::bottleneck_block: the
    block kernel, or per layer by algo3x3) on each rank's batch shard over
    "data", params (the port's block layout: w_reduce, u2_mid, w9_mid,
    w_expand, BN) whole on every rank. Returns the whole output. For a
    channel-sharded block see tensor_parallel.py::bottleneck_block_tp."""
    p = {k: torch.as_tensor(v).to(mesh.device).contiguous() for k, v in params.items()}
    return batch_parallel(mesh, lambda x_l: bottleneck_block(x_l, p, algo3x3=algo3x3), x)


def init_train_state(seed: int, c_io: int, c_mid: int, device="cuda") -> Tuple[Dict, Dict]:
    """A block's trainable parameters (TRAIN_KEYS, seeded random, the
    datagen's draws) and zero momentum, float32 tensors on `device`."""
    device = _build.require_device(device)
    raw = _block_params_random(np.random.default_rng(seed), c_io, c_mid)
    params = {k: torch.as_tensor(raw[k], dtype=torch.float32, device=device)
              for k in TRAIN_KEYS}
    return params, {k: torch.zeros_like(v) for k, v in params.items()}


def _block_loss(params: Dict, x: torch.Tensor, target: torch.Tensor,
                use_kernels: bool) -> torch.Tensor:
    if use_kernels:
        pred = bottleneck_block_train(x, params, device=x.device)
    else:
        pred = torch_ops.bottleneck_block(x, params)
    return torch.mean((pred - target) ** 2)


def make_train_step(mesh: Optional[Mesh], lr: float = 1e-3, beta: float = 0.9,
                    use_kernels: bool = False) -> Callable:
    """step(params, momentum, x, target) -> (params, momentum, loss): one SGD
    step with momentum (m = beta m + g, p = p - lr m) on the MSE between the
    block's output and target, params and momentum (init_train_state)
    updated in place, loss a 0-d tensor. use_kernels runs the forward
    through the port's block kernel (models/resnet.py::
    bottleneck_block_train, kernels/vjp.py), else the plain operators
    (ops/torch_ops.py) with autograd. With a mesh, x and target (N, H, W,
    Cio), whole on every rank, are cut over "data" and the gradients and
    the loss averaged over it (module docstring); without one, the step
    runs on the params' device."""

    def step(params: Dict, momentum: Dict, x, target):
        leaves = tree_leaves(params)
        device = leaves[0].device
        x = torch.as_tensor(x, dtype=torch.float32)
        target = torch.as_tensor(target, dtype=torch.float32)
        if mesh is not None:
            x, target = (local_shard(t, ("data",), mesh) for t in (x, target))
        x, target = x.to(device), target.to(device)
        with full_float32(), torch.enable_grad():
            ps = [p.detach().requires_grad_() for p in leaves]
            loss = _block_loss(tree_unflatten(params, ps), x, target, use_kernels)
            grads = torch.autograd.grad(loss, ps)
        loss, grads = average_over_data(mesh, loss.detach(), grads)
        sgd_update(leaves, tree_leaves(momentum), grads, lr, beta)
        return params, momentum, loss

    return step


def average_over_data(mesh: Optional[Mesh], loss: torch.Tensor, grads):
    """(loss, grads) averaged over the mesh's "data" axis (pmean) in one
    all_reduce of a flat buffer; as they are without a mesh."""
    if mesh is None:
        return loss, grads
    flat = pmean(torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads]), mesh, "data")
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[0], out


def sgd_update(leaves, moms, grads, lr: float, beta: float) -> None:
    """SGD with momentum in place: m = beta m + g, p = p - lr m."""
    with torch.no_grad():
        torch._foreach_mul_(moms, beta)
        torch._foreach_add_(moms, list(grads))
        torch._foreach_add_(leaves, moms, alpha=-lr)
