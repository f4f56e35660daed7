"""A batch of 16 through the port, whole, against the JAX package's route in
chunks of 8, on the CPU.

The JAX package serves N > 8 as lax.map chunks of SERVE_CHUNK images
(winograd_tpu/models/resnet50.py::_map_batch_chunks, a TPU compile
workaround); the port runs any batch whole. On the tiny ResNet-50 of
tests/test_torch_resnet50.py and a tiny basic-block net of ResNet-18's
structure, at N=16 and every tier, the port's forward (plain versions)
holds to the JAX forward in two chunks of 8 (Pallas interpret mode; the
ResNet-50 forwards chunk themselves, the basic family's through
_map_batch_chunks here) within 1e-4 * max(1, max|ref|) at f32 and bf16w and
1e-3 at int8 (chained quantizations, tests/test_torch_int8_resnet50.py). At
int8 every row also equals the port's own N=1 forward of that image to the
bit: a row's quantization never looks at another row. The basic family's
cases are in tests/test_torch_batch_basic.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.config import BasicNetConfig as JaxBasicNetConfig
from winograd_tpu.datagen.generate import make_basicnet_case
from winograd_tpu.models import basic as jb
from winograd_tpu.models import resnet50 as jr50
from winograd_tpu_torch.models import basic as tb
from winograd_tpu_torch.models import resnet50 as tr50
from winograd_tpu_torch.models.convert import cast_basicnet_bf16w, cast_bf16w, params_from_jax

from test_torch_resnet50 import _images, _TinyR50

N = 16
BARS = {"f32": 1e-4, "bf16w": 1e-4, "int8": 1e-3}


@dataclasses.dataclass(frozen=True)
class _TinyBasic(JaxBasicNetConfig):
    stages = ((16, 8, 2), (32, 4, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


def _err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape and out.shape[0] == N and np.isfinite(out).all()
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


@pytest.fixture(scope="module")
def models():
    x = _images(16, N, 32)
    r50 = jr50.init_resnet50_params(_TinyR50("tiny_r50_batch"), seed=3)
    cfg = _TinyBasic("tiny_basic_batch")
    case = make_basicnet_case(cfg, seed=4)
    jparams = jb.basicnet_params(case, cfg)
    return {
        "resnet50": (x, jax.tree.map(jnp.asarray, r50), params_from_jax(r50, device="cpu")),
        "resnet18": (x, jax.tree.map(jnp.asarray, jparams),
                     tb.basicnet_params(case, cfg, device="cpu")),
    }


def _jax(family, tier, x, jparams):
    if family == "resnet50":
        if tier == "int8":
            return jr50.resnet50_forward_int8(x, jr50.quantize_resnet50(jparams))
        return jr50.resnet50_forward_pallas(x, jparams, "bf16w" if tier == "bf16w" else None)
    if tier == "int8":
        q = jb.quantize_basicnet(jparams)
        return jr50._map_batch_chunks(lambda c: jb.basicnet_forward_int8(c, q), x)
    precision = "bf16w" if tier == "bf16w" else None
    return jr50._map_batch_chunks(lambda c: jb.basicnet_forward_pallas(c, jparams, precision), x)


def _port(family, tier, x, params):
    if family == "resnet50":
        if tier == "int8":
            return tr50.resnet50_forward_int8(x, tr50.quantize_resnet50(params), device="cpu")
        p = cast_bf16w(params) if tier == "bf16w" else params
        return tr50.resnet50_forward(x, p, device="cpu", precision=tier)
    if tier == "int8":
        return tb.basicnet_forward_int8(x, tb.quantize_basicnet(params), device="cpu")
    p = cast_basicnet_bf16w(params) if tier == "bf16w" else params
    return tb.basicnet_forward(x, p, device="cpu", precision=tier)


def check_whole_batch(models, family, tier):
    x, jparams, params = models[family]
    out = _port(family, tier, x, params)
    assert _err(out.numpy(), _jax(family, tier, jnp.asarray(x), jparams)) <= BARS[tier]
    if tier == "int8":
        rows = torch.cat([_port(family, tier, x[i:i + 1], params) for i in range(N)])
        assert torch.equal(out, rows)


@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_resnet50_whole_batch_matches_jax_chunks(models, tier):
    check_whole_batch(models, "resnet50", tier)
