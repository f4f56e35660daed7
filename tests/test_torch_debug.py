"""The port's debug subsystem (winograd_tpu_torch/utils/debug.py) against
winograd_tpu/utils/debug.py, on the CPU.

check_finite: the same seeded trees (numpy for the JAX function, tensors
for the port's) pass in both, or fail in both with the same message, which
names the same leaf by its path. nan_checks: a NaN input to a kernel
wrapper's plain version raises FloatingPointError naming the wrapper's
launch counter (the "_bf16w" instantiation on bf16 weights) in the port,
as jax_debug_nans raises on the same input in the JAX op; a clean forward
of a tiny ResNet-50 at every tier passes; the flag is restored on exit,
exceptions included; entering under a (mocked) CUDA graph capture
raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.ops import jnp_ops
from winograd_tpu.utils import debug as jax_debug
from winograd_tpu_torch.config import TIERS, ResNet50Config
from winograd_tpu_torch.datagen.generate import _block_params_random
from winograd_tpu_torch.engine import ResNet50Engine
from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.quantized import (
    conv1x1_bn_int8, quantize_stage_params, quantize_weights, resnet_stage_int8,
)
from winograd_tpu_torch.kernels.stage import resnet_stage_fused, stack_stage_params
from winograd_tpu_torch.kernels.stem import stem_fused
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd
from winograd_tpu_torch.models.resnet50 import init_resnet50_params
from winograd_tpu_torch.utils import debug
from winograd_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class _TinyR50(ResNet50Config):
    stages = ((64, 16, 8, 1), (128, 32, 4, 1))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 24


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((4, 3)).astype(np.float32)


def _trees():
    """(name, tree) pairs: clean ones and ones with a non-finite leaf,
    nested in dicts, lists and tuples, numbers and None among the leaves."""
    a, b = _arrays(0), _arrays(1)
    nan, inf = a.copy(), b.copy()
    nan[1, 2] = np.nan
    inf[0, :2] = np.inf
    return [
        ("clean", {"w": a, "s": {"x": b, "y": [a, None, 2.0]}}),
        ("nan_in_dict", {"w": a, "bad": nan}),
        ("inf_in_list", {"blocks": [{"w": a}, {"w": inf}]}),
        ("first_of_two", {"z": nan, "a": {"q": (b, inf)}}),
        ("top_list", [a, (b, nan)]),
    ]


@pytest.mark.parametrize("name,tree", _trees(), ids=[n for n, _ in _trees()])
def test_check_finite_agrees_with_jax(name, tree):
    def outcome(check, t):
        try:
            check(t, "params")
            return None
        except ValueError as e:
            return str(e)

    jax_tree = jax.tree.map(jnp.asarray, tree)
    port_tree = tree_map(lambda v: torch.as_tensor(v) if isinstance(v, np.ndarray) else v, tree)
    want = outcome(jax_debug.check_finite, jax_tree)
    assert outcome(debug.check_finite, port_tree) == want
    assert (want is None) == (name == "clean")
    assert outcome(debug.check_finite, tree) == want   # numpy leaves too


def test_check_finite_takes_bf16_and_int_tensors():
    debug.check_finite({"w": torch.ones(3, dtype=torch.bfloat16),
                        "q": torch.ones(2, dtype=torch.int8)})
    with pytest.raises(ValueError, match=r"p\['w'\]: 1 non-finite value\(s\), shape \(3,\)"):
        debug.check_finite({"w": torch.tensor([1.0, float("nan"), 2.0]).bfloat16()}, "p")


def _layer_inputs(seed, cin=8, cout=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 6, 6, cin)).astype(np.float32)
    x[0, 2, 3, 1] = np.nan
    return (x, (0.1 * rng.standard_normal((cin, cout))).astype(np.float32),
            rng.standard_normal(cout).astype(np.float32),
            rng.standard_normal(cout).astype(np.float32))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_nan_checks_raises_where_jax_debug_nans_does():
    """The same NaN input through the JAX 1x1 under jax_debug_nans and the
    port's wrapper under nan_checks: both raise FloatingPointError."""
    x, w, s, b = _layer_inputs(0)
    with jax_debug.nan_checks(), pytest.raises(FloatingPointError):
        jax.block_until_ready(jnp_ops.conv1x1_bn(*(jnp.asarray(v) for v in (x, w, s, b)), True))
    with debug.nan_checks():
        with pytest.raises(FloatingPointError, match=r"^pointwise: .*\(1, 6, 6, 8\)"):
            conv1x1_bn(_t(x), _t(w), _t(s), _t(b), True)
    conv1x1_bn(_t(x), _t(w), _t(s), _t(b), True)   # unchecked outside the scope


def _calls():
    """(counter, call) of several wrappers on a NaN input."""
    x, w, s, b = (_t(v) for v in _layer_inputs(1))
    rng = np.random.default_rng(2)
    w9 = torch.as_tensor((0.1 * rng.standard_normal((9 * 8, 16))).astype(np.float32))
    u = torch.as_tensor((0.1 * rng.standard_normal((16, 8, 16))).astype(np.float32))
    w192 = torch.as_tensor((0.1 * rng.standard_normal((64 * 3, 16))).astype(np.float32))
    img = torch.as_tensor(rng.standard_normal((1, 16, 16, 3)).astype(np.float32))
    img[0, 5, 5, 0] = float("nan")
    wq, sw = (torch.as_tensor(np.asarray(v)) for v in quantize_weights(w.numpy()))
    # A stage's params in a dict; the int8 stack holds the bf16 F(2,3) filter
    # of its mid, and still runs the int8 kernel.
    blocks = [_block_params_random(np.random.default_rng(5), 8, 4)]
    stacked = stack_stage_params([{k: torch.as_tensor(v) for k, v in b.items()} for b in blocks])
    qstacked = quantize_stage_params(blocks)
    assert qstacked["u2_mid_bf16"].dtype == torch.bfloat16
    return [
        ("pointwise", lambda: conv1x1_bn(x, w, s, b, True)),
        ("pointwise_bf16w", lambda: conv1x1_bn(x, w.bfloat16(), s, b, True)),
        ("direct", lambda: conv3x3_bn_direct(x, w9, s, b)),
        ("winograd", lambda: conv3x3_bn_winograd(x, u, s, b)),
        ("winograd", lambda: conv3x3_bn_winograd(x, u.bfloat16(), s, b, precision="bf16")),
        ("winograd_bf16w", lambda: conv3x3_bn_winograd(x, u.bfloat16(), s, b, precision="bf16w")),
        ("stem", lambda: stem_fused(img, w192, s, b)),
        ("stem_bf16w", lambda: stem_fused(img, w192.bfloat16(), s, b, precision="bf16w")),
        ("pointwise_int8", lambda: conv1x1_bn_int8(x, wq, sw, s, b, True)),
        ("stage", lambda: resnet_stage_fused(x, stacked)),
        ("stage_bf16w", lambda: resnet_stage_fused(
            x, {k: v.bfloat16() if k.startswith(("w", "u")) else v for k, v in stacked.items()})),
        ("stage_int8", lambda: resnet_stage_int8(x, qstacked)),
    ]


@pytest.mark.parametrize("i", range(len(_calls())))
def test_nan_checks_names_the_wrapper(i):
    counter, call = _calls()[i]
    with debug.nan_checks():
        with pytest.raises(FloatingPointError) as e:
            call()
    assert str(e.value).startswith(f"{counter}: "), str(e.value)
    assert "argument of shape (1," in str(e.value)
    assert _build.NAN_CHECKS is False


def test_nan_checks_passes_a_clean_forward_and_catches_a_nan_image():
    cfg = _TinyR50("tiny_resnet50")
    params = init_resnet50_params(cfg, seed=0, device="cpu")
    x = (np.random.default_rng(3).random((2, cfg.img, cfg.img, 3)) - 0.5).astype(np.float32)
    with debug.nan_checks():
        for tier in TIERS:
            engine = ResNet50Engine(params, tier=tier, device="cpu")
            assert torch.isfinite(engine(x)).all()
        x[1, 4, 4, 2] = np.nan
        with pytest.raises(FloatingPointError, match=r"^stem: "):
            engine(x)


def test_nan_checks_restores_its_state():
    assert _build.NAN_CHECKS is False
    with debug.nan_checks():
        assert _build.NAN_CHECKS is True
        with debug.nan_checks():
            assert _build.NAN_CHECKS is True
        assert _build.NAN_CHECKS is True
    assert _build.NAN_CHECKS is False
    with pytest.raises(KeyError):
        with debug.nan_checks():
            raise KeyError("inside")
    assert _build.NAN_CHECKS is False


def test_nan_checks_refuses_graph_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        with debug.nan_checks():
            pass
    assert _build.NAN_CHECKS is False
    # Entered before a capture began, a wrapper's check refuses to run in it.
    x, w, s, b = (_t(v) for v in _layer_inputs(4))
    monkeypatch.setattr(_build, "NAN_CHECKS", True)
    with pytest.raises(RuntimeError, match="capture"):
        conv1x1_bn(x, w, s, b, True)
