"""ResNet-101 on the CPU at f32 and bf16w: the port's forward at its stage
depths (conv3_x 4 blocks, conv4_x 23, at narrow widths and a 32x32 image)
against the JAX package's Pallas route (interpret mode) on the same seeded
numpy weights, within 1e-4 * max(1, max|ref|) at both tiers (the same
arithmetic). The int8 tier, ResNet-152 and the launch counts are in
tests/test_torch_depth_int8.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from winograd_tpu.config import ResNet50Config as JaxResNet50Config
from winograd_tpu.models.resnet50 import init_resnet50_params as jax_init
from winograd_tpu.models.resnet50 import resnet50_forward_pallas
from winograd_tpu_torch.config import CASES
from winograd_tpu_torch.models.convert import cast_bf16w, params_from_jax
from winograd_tpu_torch.models.resnet50 import resnet50_forward

# conv3_x's and conv4_x's identity blocks after their entries, by depth.
DEPTHS = {50: (3, 5), 101: (3, 22), 152: (7, 35)}


def _narrow(depth: int, conv5=(256, 32)):
    """The depth's stage structure at narrow widths on a 32x32 image
    (8 -> 4 -> 2 -> 1 after the stem). conv5 (c_io, c_mid) sets conv5_x's
    width."""
    b3, b4 = DEPTHS[depth]

    @dataclasses.dataclass(frozen=True)
    class _Narrow(JaxResNet50Config):
        stages = ((32, 8, 8, 2), (64, 16, 4, b3), (128, 16, 2, b4), (*conv5, 1, 2))
        img: int = 32
        stem_c: int = 16
        num_classes: int = 10

    return _Narrow(f"narrow_resnet{depth}")


def test_depths_are_the_cases_of_modes_20_and_21():
    for mode, depth in ((16, 50), (20, 101), (21, 152)):
        assert tuple(st[3] for st in CASES[mode].stages[1:3]) == DEPTHS[depth]


def _err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape and np.isfinite(out).all()
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


@pytest.fixture(scope="module")
def resnet101():
    cfg = _narrow(101)
    tree = jax_init(cfg, seed=7)
    x = (np.random.default_rng(101).random((2, cfg.img, cfg.img, 3)) - 0.5).astype(np.float32)
    return tree, jax.tree.map(jnp.asarray, tree), x


def test_f32_forward_matches_jax_pallas(resnet101):
    tree, jtree, x = resnet101
    out = resnet50_forward(x, params_from_jax(tree, device="cpu"), device="cpu").numpy()
    assert _err(out, resnet50_forward_pallas(jnp.asarray(x), jtree)) <= 1e-4


def test_bf16w_forward_matches_jax_pallas(resnet101):
    tree, jtree, x = resnet101
    out = resnet50_forward(x, cast_bf16w(params_from_jax(tree, device="cpu")), device="cpu",
                           precision="bf16w").numpy()
    ref = resnet50_forward_pallas(jnp.asarray(x), jtree, precision="bf16w")
    assert _err(out, ref) <= 1e-4
