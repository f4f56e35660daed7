"""ResNet-101 at int8 and ResNet-152 at every tier on the CPU, and the
kernels a deep forward launches.

The port's forward at the stage depths of tests/test_torch_depth.py
against the JAX package on the same seeded numpy weights: at ResNet-101's
depth its int8 Pallas route (interpret mode), within 1e-3 * max(1,
max|ref|) (chained quantizations, tests/test_torch_int8_resnet50.py); at
ResNet-152's (conv3_x 8 blocks, conv4_x 36) its plain XLA f32 forward,
within 1e-4 at f32 and within the tiers' own bars at bf16w
(BF16W_RTOL_BACKBONE: bf16 weights) and int8 (INT8_RTOL_BACKBONE), each
times max(1, max|ref|). Then one N=1 forward of each depth, its kernel
calls counted in kernels/_build.py::LAUNCHES: ResNet-101 and ResNet-152
launch exactly ResNet-50's kernels, chip_smoke.py's per-forward counts, at
every tier."""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.models.resnet50 import init_resnet50_params as jax_init
from winograd_tpu.models.resnet50 import quantize_resnet50 as jax_quantize
from winograd_tpu.models.resnet50 import resnet50_forward_int8 as jax_forward_int8
from winograd_tpu.models.resnet50 import resnet50_forward_xla
from winograd_tpu_torch.config import BF16W_RTOL_BACKBONE, INT8_RTOL_BACKBONE
from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import basic_stage, block, direct, pointwise, quantized
from winograd_tpu_torch.kernels import stage, stem, transition, winograd
from winograd_tpu_torch.models import resnet50 as r50
from winograd_tpu_torch.models.convert import cast_bf16w, params_from_jax

from test_torch_depth import DEPTHS, _err, _narrow

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _images(seed):
    return (np.random.default_rng(seed).random((2, 32, 32, 3)) - 0.5).astype(np.float32)


def test_resnet101_int8_forward_matches_jax_pallas():
    tree = jax_init(_narrow(101), seed=7)
    x = _images(101)
    out = r50.resnet50_forward_int8(x, r50.quantize_resnet50(params_from_jax(tree, "cpu")),
                                    device="cpu").numpy()
    ref = jax_forward_int8(jnp.asarray(x), jax_quantize(jax.tree.map(jnp.asarray, tree)))
    assert _err(out, ref) <= 1e-3


@pytest.fixture(scope="module")
def resnet152():
    tree = jax_init(_narrow(152), seed=7)
    x = _images(152)
    xla = np.asarray(resnet50_forward_xla(jnp.asarray(x), jax.tree.map(jnp.asarray, tree)))
    return params_from_jax(tree, device="cpu"), x, xla


@pytest.mark.parametrize("tier,bar", [("f32", 1e-4), ("bf16w", BF16W_RTOL_BACKBONE),
                                      ("int8", INT8_RTOL_BACKBONE)])
def test_resnet152_forward_matches_jax_xla(resnet152, tier, bar):
    params, x, xla = resnet152
    if tier == "int8":
        out = r50.resnet50_forward_int8(x, r50.quantize_resnet50(params), device="cpu")
    else:
        out = r50.resnet50_forward(x, cast_bf16w(params) if tier == "bf16w" else params,
                                   device="cpu", precision=tier)
    err = _err(out.numpy(), xla)
    assert err <= bar if tier == "f32" else err < bar


# The kernel wrappers the models call, by the counter their CUDA launch
# counts under (kernels/_build.py::launch).
WRAPPERS = {
    pointwise.conv1x1_bn: "pointwise", winograd.conv3x3_bn_winograd: "winograd",
    direct.conv3x3_bn_direct: "direct", stem.stem_fused: "stem",
    stage.resnet_stage_fused: "stage", block.bottleneck_block_fused: "stage",
    transition.transition_block_fused: "transition",
    quantized.conv1x1_bn_int8: "pointwise_int8", quantized.conv3x3_bn_int8: "direct_int8",
    quantized.resnet_stage_int8: "stage_int8",
    quantized.transition_block_int8: "transition_int8",
    quantized.conv3x3_bn_winograd_int8: "winograd_int8",
    basic_stage.basic_stage_fused: "basic_stage", basic_stage.basic_stage_int8: "basic_stage_int8",
}


def _bf16w(name, args, kwargs) -> bool:
    """A call at the bf16w tier: bfloat16 weights to an f32 kernel, and no
    "bf16" precision (the int8 tier's FP64 F(2,3) and stem, and its stage's
    bf16 F(2,3) filters, count under their own names)."""
    if name.endswith("int8"):
        return False
    values = list(args[1:]) + list(kwargs.values())
    values += [v for a in values if isinstance(a, dict) for v in a.values()]
    if any(isinstance(v, str) and v == "bf16" for v in values):
        return False
    return any(isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 for v in values)


def count_launches(monkeypatch):
    """Replace each kernel wrapper where the model modules hold it with one
    that counts a launch in _build.LAUNCHES (under "<name>_bf16w" at the
    bf16w tier), then runs the wrapper (its plain version on the CPU)."""
    def counted(fn, name):
        def wrapper(*args, **kwargs):
            _build.LAUNCHES[f"{name}_bf16w" if _bf16w(name, args, kwargs) else name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for modname, mod in list(sys.modules.items()):
        if not modname.startswith("winograd_tpu_torch.models."):
            continue
        for attr, value in list(vars(mod).items()):
            if callable(value) and value in WRAPPERS:
                monkeypatch.setattr(mod, attr, counted(value, WRAPPERS[value]))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def gated():
    """Each depth's f32 parameters at narrow widths that keep ResNet-50's
    route gates: conv5_x at 2048/384 weighs past the f32 block and stage
    gates, as at 2048/512, and within the bf16w stage gate."""
    return {depth: params_from_jax(jax_init(_narrow(depth, conv5=(2048, 384)), seed=1), "cpu")
            for depth in DEPTHS}


@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_deep_forwards_launch_resnet50s_kernels(monkeypatch, gated, tier):
    """One N=1 forward of each depth: the counts equal ResNet-50's and
    chip_smoke.py's EXPECTED_PER_FORWARD* at the tier."""
    smoke = _chip_smoke()
    expected = {"f32": smoke.EXPECTED_PER_FORWARD, "bf16w": smoke.EXPECTED_PER_FORWARD_BF16W,
                "int8": smoke.EXPECTED_PER_FORWARD_INT8}[tier]
    count_launches(monkeypatch)
    x = np.zeros((1, 32, 32, 3), np.float32)
    counts = {}
    for depth, params in gated.items():
        _build.reset_counts()
        if tier == "int8":
            r50.resnet50_forward_int8(x, r50.quantize_resnet50(params), device="cpu")
        else:
            r50.resnet50_forward(x, cast_bf16w(params) if tier == "bf16w" else params,
                                 device="cpu", precision=tier)
        counts[depth] = dict(_build.LAUNCHES)
    _build.reset_counts()
    assert counts[101] == counts[152] == counts[50] == expected, counts
