"""The port's int8 serving tier as a whole, on the tiny ResNet-50 of
tests/test_torch_resnet50.py: JAX init_resnet50_params -> numpy -> the
port's params -> quantize_resnet50 -> resnet50_forward_int8 (CPU, plain
versions) against JAX quantize_resnet50 -> resnet50_forward_int8 (Pallas
interpret mode), both against the f32 model's float64 golden, the two
packages' int8 parameters tensor for tensor, and the engine's int8 tier.

Bounds: the two int8 forwards within 1e-3 * max(1, max|ref|) (chained
quantizations, see tests/test_torch_quantized.py); each against the golden
within INT8_RTOL_BACKBONE (5e-2) * max(1, max|golden|)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from winograd_tpu.models.resnet50 import init_resnet50_params as jax_init
from winograd_tpu.models.resnet50 import quantize_resnet50 as jax_quantize
from winograd_tpu.models.resnet50 import resnet50_forward_int8 as jax_forward_int8
from winograd_tpu_torch.config import INT8_RTOL_BACKBONE
from winograd_tpu_torch.engine import ResNet50Engine
from winograd_tpu_torch.models.convert import params_from_jax, params_to, qparams_from_jax
from winograd_tpu_torch.models.resnet50 import (
    quantize_resnet50,
    resnet50_forward,
    resnet50_forward_int8,
)

from test_torch_resnet50 import _images, _TinyR50

CHAINED_RTOL = 1e-3


def _err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_tiny_int8_resnet50_matches_jax_and_golden():
    cfg = _TinyR50("tiny_resnet50")
    tree = jax_init(cfg, seed=3)
    x = _images(0, 2, cfg.img)
    ref = np.asarray(jax_forward_int8(jnp.asarray(x), jax_quantize(jax.tree.map(jnp.asarray, tree))))
    params = params_from_jax(tree, device="cpu")
    out = resnet50_forward_int8(x, quantize_resnet50(params), device="cpu").numpy()
    assert out.shape == (2, cfg.num_classes) and np.isfinite(out).all()
    assert _err(out, ref) <= CHAINED_RTOL
    golden = resnet50_forward(x, params_from_jax(tree, "cpu", torch.float64), device="cpu").numpy()
    assert _err(out, golden) < INT8_RTOL_BACKBONE
    assert _err(ref, golden) < INT8_RTOL_BACKBONE


def test_int8_params_match_jax_tensor_for_tensor():
    cfg = _TinyR50("tiny_resnet50")
    tree = jax_init(cfg, seed=5)
    theirs = qparams_from_jax(jax.tree.map(np.asarray, jax_quantize(tree)), device="cpu")
    ours = quantize_resnet50(params_from_jax(tree, device="cpu"))
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    assert ours["stages"][0]["blocks"]["u2_mid_bf16"].dtype == torch.bfloat16
    assert ours["stages"][0]["blocks"]["w_reduce_q"].dtype == torch.int8
    assert ours["proj"]["w9_mid_q"].shape == (9 * 16, 16)
    # params_to casts float tensors and keeps int8 and bf16 as they are.
    moved = params_to(ours, "cpu", torch.float64)
    assert moved["stages"][0]["blocks"]["w_reduce_q"].dtype == torch.int8
    assert moved["stages"][0]["blocks"]["u2_mid_bf16"].dtype == torch.bfloat16
    assert moved["head"]["b_fc"].dtype == torch.float64


def test_engine_serves_the_int8_tier():
    cfg = _TinyR50("tiny_resnet50")
    params = params_from_jax(jax_init(cfg, seed=3), device="cpu")
    x = _images(1, 2, cfg.img)
    engine = ResNet50Engine(params, tier="int8", device="cpu")
    assert engine.tier == "int8"
    out = engine(x)
    np.testing.assert_array_equal(
        out.numpy(), resnet50_forward_int8(x, quantize_resnet50(params), device="cpu").numpy())
    single = engine(x[1])
    assert single.shape == (cfg.num_classes,)
    assert _err(single.numpy(), out[1].numpy()) <= CHAINED_RTOL
    np.testing.assert_array_equal(engine.classify(x).numpy(), np.argmax(out.numpy(), axis=-1))
