"""The port's rematerializing training composites (winograd_tpu_torch/
kernels/vjp.py: stem, block, transition, projection; the streamed stages
are in test_torch_vjp_stages.py), and models/resnet.py::
bottleneck_block_train on both its routes, against jax.grad of each one's
ops/jnp_ops.py twin, the reference the JAX package holds its own train
route to (tests/test_vjp.py: rtol 5e-4): every gradient of sum(out^2)
within 5e-4 * max(1, max|ref|); the forward against the JAX fused forward
(the Pallas kernels in interpret mode) within 1e-4 * max(1, max|ref|). On
the CPU at tiny shapes; inputs made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_vjp import LAYER_RTOL, _bn, _jax, _port, _rand, _within
from winograd_tpu.kernels import vjp as jvjp
from winograd_tpu.ops import jnp_ops
from winograd_tpu_torch.kernels import vjp

AUTODIFF_RTOL = 5e-4


def _block(rng, cio, cmid, cout=None, proj=False):
    cout = cout or cio
    p = {"w_reduce": _rand(rng, cio, cmid)}
    p["s_reduce"], p["b_reduce"] = _bn(rng, cmid)
    p["w_mid"] = _rand(rng, cmid, cmid, 3, 3)
    p["s_mid"], p["b_mid"] = _bn(rng, cmid)
    p["w_expand"] = _rand(rng, cmid, cout)
    p["s_expand"], p["b_expand"] = _bn(rng, cout)
    if proj:
        p["w_proj"] = _rand(rng, cio, cout)
        p["s_proj"], p["b_proj"] = _bn(rng, cout)
    return p


def _basic(rng, c):
    p = {}
    for leg in ("a", "b"):
        p[f"w_{leg}"] = _rand(rng, c, c, 3, 3)
        p[f"s_{leg}"], p[f"b_{leg}"] = _bn(rng, c)
    return p


def _chain(block_fn):
    def run(x, blocks):
        for b in blocks:
            x = block_fn(x, b)
        return x
    return run


def _check_composite(port_fn, fused_fn, xla_fn, x, tree):
    """Grads against jax.grad of the XLA twin at AUTODIFF_RTOL; the forward
    against the JAX fused forward at LAYER_RTOL."""
    out, grads = _port(port_fn, x, tree)
    _, ref_grads = _jax(xla_fn, x, tree)
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        _within(g, r, AUTODIFF_RTOL, f"grad {i}")
    _within(out, fused_fn(jnp.asarray(x), jax.tree.map(jnp.asarray, tree)), LAYER_RTOL,
            "forward")


def test_stem_train_fused_matches_jax():
    rng = np.random.default_rng(5)
    x = _rand(rng, 1, 20, 20, 3)
    s, b = _bn(rng, 16)
    p = {"w7_stem": _rand(rng, 16, 3, 7, 7), "s_stem": s, "b_stem": b}
    _check_composite(vjp.stem_train_fused, jvjp.stem_train_fused, jnp_ops.stem, x, p)


def test_bottleneck_block_train_fused_matches_jax():
    rng = np.random.default_rng(6)
    _check_composite(vjp.bottleneck_block_train_fused, jvjp.bottleneck_block_train_fused,
                     jnp_ops.bottleneck_block, _rand(rng, 1, 8, 8, 32), _block(rng, 32, 8))


def test_transition_block_train_fused_matches_jax():
    rng = np.random.default_rng(7)
    _check_composite(vjp.transition_block_train_fused, jvjp.transition_block_train_fused,
                     jnp_ops.downsample_bottleneck_block, _rand(rng, 1, 8, 8, 16),
                     _block(rng, 16, 8, 32, proj=True))


def test_projection_block_train_fused_matches_jax():
    rng = np.random.default_rng(8)
    _check_composite(vjp.projection_block_train_fused, jvjp.projection_block_train_fused,
                     lambda x_, p_: jnp_ops.downsample_bottleneck_block(x_, p_, stride=1),
                     _rand(rng, 1, 8, 8, 16), _block(rng, 16, 8, 32, proj=True))


@pytest.mark.parametrize("algo3x3", ["fused", "winograd"])
def test_bottleneck_block_train_matches_jax(algo3x3):
    """The model-level block on its two routes: the block kernel forward, or
    three per-layer Functions with the 3x3 at F(4,3); the forward against the
    JAX package's bottleneck_block_train on the same route."""
    from winograd_tpu.models.resnet import bottleneck_block_train as jax_block_train
    from winograd_tpu_torch.models.resnet import bottleneck_block_train

    rng = np.random.default_rng(13)
    _check_composite(lambda x_, p_: bottleneck_block_train(x_, p_, algo3x3, device="cpu"),
                     lambda x_, p_: jax_block_train(x_, p_, algo3x3),
                     jnp_ops.bottleneck_block, _rand(rng, 1, 8, 8, 32), _block(rng, 32, 8))
