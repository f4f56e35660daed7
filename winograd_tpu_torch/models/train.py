"""Training the classifier: its loss, its SGD step, its trainable set.

Port of winograd_tpu/models/train.py. resnet50_loss is the mean softmax
cross-entropy of models/resnet50.py::resnet50_forward_train, whose every
conv runs the serving kernels forward (kernels/vjp.py).
make_resnet50_train_step is SGD with momentum over the whole parameter
tree, m = beta * m + g, p = p - lr * m, with forward and backward inside
baseline/cudnn.py::full_float32() (the backward's matmuls full float32,
never TF32). Unlike the JAX package's pure step, it updates params and
momentum in place, so a CUDA graph of the step can be replayed on the same
tensors and no second copy of the weights is held. With a mesh the step is
data-parallel (parallel/data_parallel.py).

trainable_resnet50_params and trainable_basicnet_params are the dict strips
that define what a trained checkpoint holds (raw OIHW filters and folded
BN, without the serving layouts models/checkpoint.py::prepare_*_serving
derives); leaves pass through as they are (numpy arrays or tensors). So
train, save_model, ResNet50Engine.from_checkpoint is one pipeline
(examples/train_and_deploy_torch.py).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from winograd_tpu_torch.baseline.cudnn import full_float32
from winograd_tpu_torch.utils.tree import tree_leaves, tree_unflatten

_RESNET50_SERVING_KEYS = ("u_mid", "u2_mid", "w9_mid", "w49_stem", "w192_stem", "wep", "bep")
_BASICNET_SERVING_KEYS = ("u2_a", "u2_b", "w9_a", "w9_b", "w49_stem", "w192_stem")


def _keep(d: Dict, drop) -> Dict:
    return {k: v for k, v in d.items() if k not in drop}


def resnet50_loss(params: Dict, x, labels, precision=None, device="cuda") -> torch.Tensor:
    """Mean softmax cross-entropy of resnet50_forward_train's logits. x: (N,
    H, W, 3) or (H, W, 3); labels: integer class ids, (N,) or a scalar.
    precision None or "bf16w" (kernels/vjp.py)."""
    from winograd_tpu_torch.models.resnet50 import resnet50_forward_train

    logits = torch.atleast_2d(resnet50_forward_train(x, params, precision, device))
    logp = torch.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(labels, device=logp.device).reshape(-1, 1).long()
    return -logp.gather(-1, labels).mean()


def make_resnet50_train_step(lr: float = 1e-2, beta: float = 0.9, mesh=None,
                             precision=None) -> Callable:
    """SGD with momentum over the whole classifier: step(params, momentum, x,
    labels) -> (params, momentum, loss), params and momentum (start it at
    utils/tree.py::tree_map(torch.zeros_like, params)) updated in place and
    returned, loss a 0-d tensor. The forward and backward run on the
    params' device. precision "bf16w" trains through the bf16w kernels
    (f32 master weights; grads within config.BF16W_TRAIN_GRAD_RTOL of the
    f32 step).

    With a mesh (parallel/mesh.py, a ("data", "model") one) the step is
    data-parallel, the JAX package's: every rank passes the whole batch,
    trains on its shard over "data" (the ranks of a "model" row compute the
    same shard) on the mesh's device, and the gradients and the loss are
    averaged over "data" (pmean) before the update: the single-device step
    on the whole batch, the loss being a mean over it. Params and momentum
    live on the mesh's device; the collectives are host code, so this step
    is not captured in a CUDA graph."""
    from winograd_tpu_torch.parallel.data_parallel import average_over_data, sgd_update
    from winograd_tpu_torch.parallel.mesh import check_mesh, local_shard

    if mesh is not None:
        check_mesh(mesh)

    def step(params, momentum, x, labels):
        leaves = tree_leaves(params)
        if mesh is not None:
            x = local_shard(torch.as_tensor(x, dtype=torch.float32), ("data",), mesh)
            labels = local_shard(torch.as_tensor(labels).reshape(-1), ("data",), mesh)
        with full_float32(), torch.enable_grad():
            ps = [p.detach().requires_grad_() for p in leaves]
            loss = resnet50_loss(tree_unflatten(params, ps), x, labels, precision,
                                 leaves[0].device)
            grads = torch.autograd.grad(loss, ps)
        loss, grads = average_over_data(mesh, loss.detach(), grads)
        sgd_update(leaves, tree_leaves(momentum), grads, lr, beta)
        return params, momentum, loss

    return step


def trainable_resnet50_params(full: Dict) -> Dict:
    """A full ResNet-50 tree in the JAX package's structure (models/
    resnet50.py::init_resnet50_arrays or ::resnet50_arrays) without its
    serving-only layouts: the set prepare_resnet50_serving takes."""
    drop = _RESNET50_SERVING_KEYS
    return {
        "stem": _keep(full["stem"], drop),
        "proj": _keep(full["proj"], drop),
        "stages": [
            {"transition": None if st.get("transition") is None
             else _keep(st["transition"], drop),
             "blocks": [_keep(b, drop) for b in st["blocks"]]}
            for st in full["stages"]
        ],
        "head": _keep(full["head"], drop),
    }


def trainable_basicnet_params(full: Dict) -> Dict:
    """A full basic-family tree in the JAX package's structure (models/
    basic.py::basicnet_arrays) without its serving-only layouts and fused
    stacks: the set prepare_basicnet_serving takes."""
    drop = _BASICNET_SERVING_KEYS
    return {
        "stem": _keep(full["stem"], drop),
        "stages": [
            {"entry": None if st.get("entry") is None else _keep(st["entry"], drop),
             "blocks": [_keep(b, drop) for b in st["blocks"]]}
            for st in full["stages"]
        ],
        "head": _keep(full["head"], drop),
    }
