"""The port's training slice against the JAX package, on the CPU: the whole
ResNet-50 and basic-net train forwards (models/resnet50.py::
resnet50_forward_train, models/basic.py::basicnet_forward_train) at
tests/test_train_bf16w.py's tiny configs, their gradients against jax.grad
of the all-XLA forwards (resnet50_forward_xla, basicnet_forward_xla)
within 5e-4 * max(1, max|ref|), the rtol the JAX package holds its own
train route to; the bf16w tier's step scalar within BF16W_TRAIN_GRAD_RTOL
of JAX's f32 XLA step; two make_resnet50_train_step steps against the same
SGD update written over JAX's XLA gradients, params within 1e-4 * max(1,
max|p|); and the CPU refusal of the default device. Weights go from the
JAX package's seeded tree through numpy to the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.config import BasicNetConfig, ResNet50Config
from winograd_tpu.datagen.generate import make_basicnet_case, make_resnet50_case
from winograd_tpu.models import basic as jbasic
from winograd_tpu.models import resnet50 as jr50
from winograd_tpu.models.train import trainable_basicnet_params as jax_trainable_basic
from winograd_tpu.models.train import trainable_resnet50_params as jax_trainable_r50
from winograd_tpu_torch.config import BF16W_TRAIN_GRAD_RTOL
from winograd_tpu_torch.models.basic import basicnet_forward_train
from winograd_tpu_torch.models.resnet50 import resnet50_forward_train
from winograd_tpu_torch.models.train import (
    make_resnet50_train_step, resnet50_loss, trainable_resnet50_params,
)
from winograd_tpu_torch.utils.tree import tree_leaves, tree_map
from winograd_tpu_torch.parallel import make_mesh
from torch_parallel_ranks import one_rank_world

AUTODIFF_RTOL = 5e-4
SGD_RTOL = 1e-4


@dataclasses.dataclass(frozen=True)
class _Tiny(ResNet50Config):
    stages = ((32, 16, 8, 1), (64, 16, 4, 1))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


@dataclasses.dataclass(frozen=True)
class _TinyB(BasicNetConfig):
    stages = ((16, 16, 2), (32, 8, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


def _r50():
    cfg = _Tiny("tiny_r50_train")
    case = make_resnet50_case(cfg, seed=7)
    tree = jax.tree.map(np.asarray, jax_trainable_r50(jr50.resnet50_params(case, cfg)))
    return trainable_resnet50_params(tree), np.asarray(case["x"])


def _basic():
    cfg = _TinyB("tiny_basic_train")
    case = make_basicnet_case(cfg, seed=8)
    tree = jax.tree.map(np.asarray, jax_trainable_basic(jbasic.basicnet_params(case, cfg)))
    return tree, np.asarray(case["x"])


def _tensors(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _pairs(tree, other, path=""):
    """(path, leaf of tree, the same leaf of other), walking tree's keys."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _pairs(tree[k], other[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in _pairs(t, other[i], f"{path}/{i}")]
    return [] if tree is None else [(path, tree, other)]


def _port_grads(forward, tree, x, precision=None):
    """(step scalar, grads tree) of sum(out^2) through the port on the CPU:
    the scalar is the loss plus every grad leaf's squared norm (the bench's
    train-step protocol)."""
    params = tree_map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), tree)
    out = forward(torch.tensor(x), params, precision, device="cpu")
    loss = (out * out).sum()
    grads = torch.autograd.grad(loss, tree_leaves(params))
    scalar = loss.item() + sum((g * g).sum().item() for g in grads)
    it = iter(g.numpy() for g in grads)
    return scalar, tree_map(lambda _: next(it), tree)


def _jax_grads(forward, tree, x):
    def loss(p):
        out = forward(jnp.asarray(x), p)
        return jnp.sum(out * out)

    value, grads = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, tree))
    scalar = float(value) + sum(float(jnp.vdot(g, g)) for g in jax.tree_util.tree_leaves(grads))
    return scalar, grads


@pytest.mark.parametrize("model", ["resnet50", "basic", "basic_fused_stage"])
def test_train_forward_grads_match_jax_xla_autodiff(model):
    """basic_fused_stage: fused_min_channels=0 sends the tiny net's 8x8
    identity run through the basic-stage train route, as the JAX package's
    test_basicnet_streamed_stage_train_route does."""
    tree, x = _r50() if model == "resnet50" else _basic()
    port_fwd = resnet50_forward_train if model == "resnet50" else basicnet_forward_train
    if model == "basic_fused_stage":
        def port_fwd(x_, p_, precision=None, device="cuda"):
            return basicnet_forward_train(x_, p_, precision, device, fused_min_channels=0)
    xla_fwd = jr50.resnet50_forward_xla if model == "resnet50" else jbasic.basicnet_forward_xla
    scalar, grads = _port_grads(port_fwd, tree, x)
    ref_scalar, ref_grads = _jax_grads(xla_fwd, tree, x)
    pairs = _pairs(grads, ref_grads)
    assert len(pairs) == len(jax.tree_util.tree_leaves(ref_grads))
    for path, g, r in pairs:
        r = np.asarray(r)
        err, tol = np.abs(g - r).max(), AUTODIFF_RTOL * max(1.0, np.abs(r).max())
        assert np.isfinite(g).all() and err <= tol, (path, err, tol)
    assert abs(scalar - ref_scalar) / max(abs(ref_scalar), 1.0) < 1e-3


@pytest.mark.parametrize("model", ["resnet50", "basic"])
def test_bf16w_step_scalar_within_its_bar_of_the_jax_f32_step(model):
    tree, x = _r50() if model == "resnet50" else _basic()
    port_fwd = resnet50_forward_train if model == "resnet50" else basicnet_forward_train
    xla_fwd = jr50.resnet50_forward_xla if model == "resnet50" else jbasic.basicnet_forward_xla
    scalar, _ = _port_grads(port_fwd, tree, x, "bf16w")
    ref, _ = _jax_grads(xla_fwd, tree, x)
    assert abs(scalar - ref) / max(abs(ref), 1.0) < BF16W_TRAIN_GRAD_RTOL


def test_two_sgd_steps_match_the_same_update_over_jax_grads():
    tree, x1 = _r50()
    x = np.stack([x1, np.random.default_rng(3).random(x1.shape, np.float32) - 0.5])
    labels = np.arange(2) % _Tiny.num_classes
    lr, beta = 1e-2, 0.9

    def jax_loss(p):
        logp = jax.nn.log_softmax(jr50.resnet50_forward_xla(jnp.asarray(x), p), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=-1))

    jp = jax.tree.map(jnp.asarray, tree)
    jm = jax.tree.map(jnp.zeros_like, jp)
    jax_losses = []
    for _ in range(2):
        loss, g = jax.value_and_grad(jax_loss)(jp)
        jm = jax.tree.map(lambda m, g_: beta * m + g_, jm, g)
        jp = jax.tree.map(lambda p, m: p - lr * m, jp, jm)
        jax_losses.append(float(loss))

    params = _tensors(tree)
    momentum = tree_map(torch.zeros_like, params)
    step = make_resnet50_train_step(lr, beta)
    losses = []
    for _ in range(2):
        out_params, out_m, loss = step(params, momentum, x, labels)
        assert out_params is params and out_m is momentum  # updated in place
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    for path, p, r in _pairs(params, jp):
        p, r = p.numpy(), np.asarray(r)
        assert np.abs(p - r).max() <= SGD_RTOL * max(1.0, np.abs(r).max()), path
    # The loss is the mean cross-entropy of the train forward.
    logits = resnet50_forward_train(x, params, device="cpu")
    want = torch.nn.functional.cross_entropy(logits, torch.as_tensor(labels))
    assert resnet50_loss(params, x, labels, device="cpu").item() == pytest.approx(want.item(),
                                                                                   rel=1e-6)


def test_the_step_refuses_a_mesh_and_the_default_device_needs_a_card(tmp_path):
    """A mesh that is not a parallel.Mesh is refused; with a mesh (one rank
    in this process; larger ones in tests/test_torch_parallel.py and
    tests/test_torch_cuda.py) the step is data-parallel and equals the
    single-device step, loss and every leaf within 1e-6 relative."""
    with pytest.raises(TypeError, match="Mesh"):
        make_resnet50_train_step(mesh=object())
    tree, x1 = _r50()
    x = np.stack([x1, np.random.default_rng(3).random(x1.shape, np.float32) - 0.5])
    labels = np.arange(2) % _Tiny.num_classes
    single, momentum = _tensors(tree), tree_map(torch.zeros_like, _tensors(tree))
    _, _, want = make_resnet50_train_step()(single, momentum, x, labels)
    with one_rank_world(tmp_path):
        params, momentum = _tensors(tree), tree_map(torch.zeros_like, _tensors(tree))
        step = make_resnet50_train_step(mesh=make_mesh(1, 1, device="cpu"))
        _, _, loss = step(params, momentum, x, labels)
    assert loss.item() == pytest.approx(want.item(), rel=1e-6)
    for p, r in zip(tree_leaves(params), tree_leaves(single)):
        assert torch.allclose(p, r, rtol=1e-6, atol=1e-7)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    tree, x = _r50()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet50_forward_train(x, _tensors(tree))
