"""The port's whole slice against the JAX package, on the tiny ResNet-50 of
tests/test_resnet50.py: JAX init_resnet50_params -> numpy ->
params_from_jax -> port resnet50_forward (CPU, plain versions) against JAX
resnet50_forward_pallas (Pallas interpret mode), and the engine on top.
Bound everywhere: 1e-4 * max(1, max|ref|)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.config import ResNet50Config as JaxResNet50Config
from winograd_tpu.models.resnet import bottleneck_block_pallas
from winograd_tpu.models.resnet50 import init_resnet50_params as jax_init
from winograd_tpu.models.resnet50 import resnet50_forward_pallas, resnet50_forward_xla
from winograd_tpu_torch.config import PARITY_ATOL, ResNet50Config
from winograd_tpu_torch.engine import ResNet50Engine
from winograd_tpu_torch.models import resnet
from winograd_tpu_torch.models.convert import params_from_jax
from winograd_tpu_torch.models.resnet50 import (
    init_resnet50_arrays,
    init_resnet50_params,
    resnet50_forward,
)


@dataclasses.dataclass(frozen=True)
class _TinyR50(JaxResNet50Config):
    stages = ((64, 16, 8, 1), (128, 32, 4, 1))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 24


def _close(out, ref):
    return np.abs(np.asarray(out) - np.asarray(ref)).max() <= PARITY_ATOL * max(
        1.0, np.abs(np.asarray(ref)).max())


def _images(seed, n, img):
    return (np.random.default_rng(seed).random((n, img, img, 3)) - 0.5).astype(np.float32)


def test_tiny_resnet50_matches_jax_and_engine_serves():
    cfg = _TinyR50("tiny_resnet50")
    tree = jax_init(cfg, seed=3)
    x = _images(0, 2, cfg.img)
    ref = np.asarray(resnet50_forward_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray, tree)))
    params = params_from_jax(tree, device="cpu")
    out = resnet50_forward(x, params, device="cpu").numpy()
    assert out.shape == ref.shape == (2, cfg.num_classes)
    assert _close(out, ref)
    assert _close(out, resnet50_forward_xla(jnp.asarray(x), jax.tree.map(jnp.asarray, tree)))

    engine = ResNet50Engine(params, device="cpu")
    single = engine(x[0])
    assert single.shape == (cfg.num_classes,)
    assert _close(single.numpy(), ref[0])
    np.testing.assert_array_equal(engine.classify(x).numpy(), np.argmax(out, axis=-1))
    assert int(engine.classify(x[1])) == int(np.argmax(out[1]))


def test_port_init_equals_jax_init():
    """One seed gives both packages the same network, and the port's own
    transforms rebuild the JAX package's kernel layouts exactly."""
    cfg = _TinyR50("tiny_resnet50")
    tree = jax_init(cfg, seed=5)
    ours = params_from_jax(init_resnet50_arrays(cfg, seed=5), device="cpu")
    theirs = params_from_jax(tree, device="cpu")
    np.testing.assert_array_equal(ours["stem"]["w192_stem"].numpy(), tree["stem"]["w192_stem"])
    np.testing.assert_array_equal(ours["proj"]["u2_mid"].numpy(), tree["proj"]["u2_mid"])
    blk = tree["stages"][1]["blocks"][0]
    np.testing.assert_array_equal(ours["stages"][1]["blocks"][0]["u2_mid"].numpy(), blk["u2_mid"])
    np.testing.assert_array_equal(ours["stages"][1]["blocks"][0]["w9_mid"].numpy(), blk["w9_mid"])
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    p = init_resnet50_params(cfg, seed=5, device="cpu")
    x = _images(1, 1, cfg.img)
    np.testing.assert_array_equal(
        resnet50_forward(x, p, device="cpu").numpy(), resnet50_forward(x, ours, device="cpu").numpy())


def test_bottleneck_block_takes_winograd_at_28x28():
    """At H*W >= 28*28 the identity block's 3x3 runs Winograd F(2,3) on
    u2_mid; against the JAX package's per-layer Winograd block."""
    from winograd_tpu.datagen.generate import _block_params_random

    rng = np.random.default_rng(9)
    blk = _block_params_random(rng, 32, 8, bn_scale=0.5)
    x = (rng.random((1, 28, 28, 32)) - 0.5).astype(np.float32)
    ref = np.asarray(bottleneck_block_pallas(
        jnp.asarray(x), jax.tree.map(jnp.asarray, blk), algo3x3="winograd"))
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in blk.items()}
    assert 28 * 28 >= resnet.WINOGRAD_MIN_PIXELS > 14 * 14
    out = resnet.bottleneck_block(torch.from_numpy(x), params).numpy()
    assert _close(out, ref)
    # The same block with the direct route (what a 14x14 map would take).
    params.pop("u2_mid")
    direct = resnet.conv3x3_mid(torch.from_numpy(x[:, :14, :14, :8].copy()), params)
    assert direct.shape == (1, 14, 14, 8)


def test_engine_rejects_unported_options():
    cfg = _TinyR50("tiny_resnet50")
    params = init_resnet50_params(cfg, seed=0, device="cpu")
    for kw in ({"tier": "bf16w"}, {"tier": "int8"}, {"mesh": object()}, {"partition": "model"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ResNet50Engine(params, device="cpu", **kw)


def test_full_width_config_matches_jax_package():
    ours, theirs = ResNet50Config(), JaxResNet50Config("resnet50_full")
    assert ours.stages == theirs.stages
    assert (ours.img, ours.stem_c, ours.num_classes) == (theirs.img, theirs.stem_c, theirs.num_classes)
