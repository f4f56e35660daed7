"""The port's per-layer training Functions (winograd_tpu_torch/kernels/
vjp.py) against the JAX package, on the CPU at tiny shapes: each against
the JAX custom_vjp it ports (the Pallas forward in interpret mode), output
and every gradient of sum(out^2) within 1e-4 * max(1, max|ref|); the
differentiable layouts against the offline transforms; the zero-scale
guard of the z recovery. Inputs are made with numpy from a seed and handed
to both. The Winograd Function is in test_torch_vjp_winograd.py, the
composites in test_torch_vjp_blocks.py and test_torch_vjp_stages.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.kernels import vjp as jvjp
from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels import vjp
from winograd_tpu_torch.kernels.direct import direct_filter
from winograd_tpu_torch.models.convert import stem_filter_s2d
from winograd_tpu_torch.utils.tree import tree_leaves, tree_map

LAYER_RTOL = 1e-4


def _rand(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def _bn(rng, c):
    return (0.8 + 0.4 * rng.random(c)).astype(np.float32), _rand(rng, c)


def _within(got, ref, rtol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, tol = np.abs(got - ref).max(), rtol * max(1.0, np.abs(ref).max())
    assert np.isfinite(got).all() and err <= tol, (what, err, tol)


def _port(fn, x, tree):
    """fn(x, tree) on CPU tensors and the grads of sum(out^2) wrt x and every
    leaf of tree, as numpy."""
    xt = torch.tensor(x, requires_grad=True)
    tt = tree_map(lambda a: torch.tensor(a, requires_grad=True), tree)
    out = fn(xt, tt)
    grads = torch.autograd.grad((out * out).sum(), [xt, *tree_leaves(tt)])
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax(fn, x, tree):
    xj, tj = jnp.asarray(x), jax.tree.map(jnp.asarray, tree)
    gx, gt = jax.grad(lambda a, b: jnp.sum(fn(a, b) ** 2), argnums=(0, 1))(xj, tj)
    return np.asarray(fn(xj, tj)), [np.asarray(gx)] + [np.asarray(g) for g in _leaves_in(tree, gt)]


def _leaves_in(tree, gtree):
    """gtree's leaves in tree_leaves' order (dict insertion order; jax.tree
    sorts keys)."""
    if isinstance(tree, dict):
        return [g for k in tree for g in _leaves_in(tree[k], gtree[k])]
    if isinstance(tree, list):
        return [g for t, gt in zip(tree, gtree) for g in _leaves_in(t, gt)]
    return [gtree]


def _compare(port_fn, jax_fn, x, tree, rtol):
    out, grads = _port(port_fn, x, tree)
    ref_out, ref_grads = _jax(jax_fn, x, tree)
    _within(out, ref_out, rtol, "forward")
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        _within(g, r, rtol, f"grad {i}")


# --- each Function against the JAX custom_vjp -----------------------------------


def _layer(rng, x_shape, w_shape, cout):
    s, b = _bn(rng, cout)
    return _rand(rng, *x_shape), {"w": _rand(rng, *w_shape), "s": s, "b": b}


@pytest.mark.parametrize("relu", [True, False])
def test_conv1x1_bn_train_matches_the_jax_custom_vjp(relu):
    x, p = _layer(np.random.default_rng(0), (2, 5, 5, 24), (24, 16), 16)
    _compare(lambda x_, p_: vjp.conv1x1_bn_train(x_, p_["w"], p_["s"], p_["b"], relu),
             lambda x_, p_: jvjp.conv1x1_bn_train(x_, p_["w"], p_["s"], p_["b"], relu),
             x, p, LAYER_RTOL)


@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_bn_direct_train_matches_the_jax_custom_vjp(relu):
    x, p = _layer(np.random.default_rng(2), (2, 6, 6, 16), (8, 16, 3, 3), 8)
    _compare(lambda x_, p_: vjp.conv3x3_bn_direct_train(x_, p_["w"], p_["s"], p_["b"], relu),
             lambda x_, p_: jvjp.conv3x3_bn_direct_train(x_, p_["w"], p_["s"], p_["b"], relu),
             x, p, LAYER_RTOL)


def test_layouts_match_the_offline_transforms():
    w = _rand(np.random.default_rng(3), 8, 4, 3, 3)
    w7 = _rand(np.random.default_rng(4), 16, 3, 7, 7)
    for m in (2, 4):
        np.testing.assert_allclose(vjp.filter_transform(torch.tensor(w), m).numpy(),
                                   transforms.transform_filter(w, m=m), atol=1e-6)
    np.testing.assert_array_equal(vjp.stem_filter_s2d(torch.tensor(w7)).numpy(),
                                  stem_filter_s2d(w7))
    np.testing.assert_array_equal(vjp.direct_filter_t(torch.tensor(w)).numpy(),
                                  direct_filter(w))


def test_recover_z_guards_a_zero_scale():
    """z = (y - b) / s is exact where the ReLU passes; a zero scale gives a
    finite z, as the JAX package's guard does, and the layer's d(scale)
    stays finite."""
    rng = np.random.default_rng(11)
    z = torch.tensor(rng.standard_normal((4, 4, 8)).astype(np.float32))
    scale = torch.tensor((rng.random(8) + 0.5).astype(np.float32))
    bias = torch.tensor(rng.standard_normal(8).astype(np.float32) * 0.1)
    y = torch.relu(z * scale + bias)
    mask = y > 0
    assert torch.allclose(vjp._recover_z(y, scale, bias)[mask], z[mask], atol=1e-6)
    s0 = scale.clone()
    s0[0] = 0.0
    y0 = torch.relu(z * s0 + bias)
    zr = vjp._recover_z(y0, s0, bias)
    want = np.asarray(jvjp._recover_z(jnp.asarray(y0.numpy()), jnp.asarray(s0.numpy()),
                                      jnp.asarray(bias.numpy())))
    assert torch.isfinite(zr).all()
    np.testing.assert_allclose(zr.numpy(), want, rtol=1e-6, atol=1e-6)
    x = torch.tensor(_rand(rng, 4, 4, 8))
    w = torch.tensor(_rand(rng, 8, 8))
    s0.requires_grad_(True)
    out = vjp.conv1x1_bn_train(x, w, s0, bias, True)
    (ds,) = torch.autograd.grad(out.sum(), [s0])
    assert torch.isfinite(ds).all()


def test_precision_is_checked():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="precision"):
        vjp.conv1x1_bn_train(x, torch.zeros(8, 8), torch.ones(8), torch.zeros(8), True, "int8")
