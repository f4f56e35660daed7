"""The port's tensor-parallel classifiers and the classifier engines'
partitions against the JAX package, on the CPU.

One world of four gloo ranks (tests/torch_parallel_ranks.py::
classifier_world, started once for the module by spawn_world) serves a
tiny ResNet-50 and a tiny basic-family net through parallel/
tensor_parallel.py on a 2 x 2 mesh (model axis 2) and a 1 x 4 mesh (model
axis 4), with the kernels' plain versions, and both engines under
partition "model" and "data" at every tier. The same seeded numpy inputs
go through the JAX package's resnet50_forward_tp and basicnet_forward_tp
on the conftest's eight virtual devices (make_mesh(8, model_axis=2),
Pallas in interpret mode, as tests/test_parallel.py runs them).

Bounds (each times max(1, max|ref|) unless stated):
* f32 against the JAX TP forward: 2e-4 (tests/test_parallel.py's TP bar),
  at model axis 2 and 4; against the float64 golden 2e-4;
* bf16w against the JAX bf16w TP forward: 1e-4, the port's bf16w bar
  (tests/test_torch_bf16w.py); the basic family's bf16w against the JAX
  f32 TP within BF16W_RTOL_BACKBONE (tests/test_parallel.py's);
* int8 against the JAX int8 TP forward: CHAINED_RTOL 1e-3
  (tests/test_torch_int8_resnet50.py), and within INT8_RTOL_BACKBONE of
  the golden;
* partition "model" equals the TP function to the bit; partition "data"
  within 1e-6 of the single-device engine at every tier (the same plain
  arithmetic on a batch shard; only the GEMMs' blocking may differ), and
  its f32 logits within 2e-4 of the JAX TP forward;
* every rank returns the whole logits, equal to rank 0's to the bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_ranks import TIERS, classifier_world, world_in_background
from winograd_tpu.config import BasicNetConfig, ResNet50Config
from winograd_tpu.datagen.generate import make_basicnet_case, make_resnet50_case
from winograd_tpu.models.basic import basicnet_params as jax_basicnet_params
from winograd_tpu.models.resnet50 import init_resnet50_params as jax_init_resnet50
from winograd_tpu.models.resnet50 import resnet50_params as jax_resnet50_params
from winograd_tpu.parallel import basicnet_forward_tp as jax_basicnet_tp
from winograd_tpu.parallel import make_mesh as jax_make_mesh
from winograd_tpu.parallel import resnet50_forward_tp as jax_resnet50_tp
from winograd_tpu_torch.config import BF16W_RTOL_BACKBONE, INT8_RTOL_BACKBONE
from winograd_tpu_torch.models.basic import basicnet_arrays
from winograd_tpu_torch.models.resnet50 import init_resnet50_arrays, resnet50_arrays

F32_TP_ATOL = 2e-4
BF16W_ATOL = 1e-4
CHAINED_RTOL = 1e-3
DATA_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class _TinyTP(ResNet50Config):
    # Channel widths divisible by model axes 2 and 4; classes too.
    stages = ((32, 16, 8, 1), (64, 16, 4, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


@dataclasses.dataclass(frozen=True)
class _OddHead(ResNet50Config):
    stages = ((32, 16, 8, 1),)
    img: int = 32
    stem_c: int = 16
    num_classes: int = 13


@dataclasses.dataclass(frozen=True)
class _TinyBasic(BasicNetConfig):
    stages = ((16, 16, 2), (32, 8, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


def _scaled(x):
    return np.stack([x * s for s in (1.0, 0.5, -0.25, 2.0)]).astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    r50_case = make_resnet50_case(_TinyTP("tp_full"), seed=19)
    basic_case = make_basicnet_case(_TinyBasic("tp_basic"), seed=51)
    odd_x = np.random.default_rng(9).standard_normal((4, 32, 32, 3)).astype(np.float32)
    return {
        "r50_case": r50_case, "basic_case": basic_case,
        "inputs": {
            "r50": resnet50_arrays(r50_case, _TinyTP("tp_full")),
            "r50_x": _scaled(r50_case["x"]),
            "r50_odd": init_resnet50_arrays(_OddHead("tp_odd_head"), seed=20),
            "r50_odd_x": odd_x,
            "basic": basicnet_arrays(basic_case, _TinyBasic("tp_basic")),
            "basic_x": _scaled(basic_case["x"]),
        },
    }


@pytest.fixture(scope="module")
def world_future(cases):
    with world_in_background(classifier_world, 4, cases["inputs"]) as future:
        yield future


@pytest.fixture(scope="module")
def jax_refs(cases, world_future):
    """The JAX package's TP forwards, computed while the world runs."""
    mesh = jax_make_mesh(8, model_axis=2)
    r50 = jax_resnet50_params(cases["r50_case"], _TinyTP("tp_full"))
    basic = jax_basicnet_params(cases["basic_case"], _TinyBasic("tp_basic"))
    x, xb = (jnp.asarray(cases["inputs"][k]) for k in ("r50_x", "basic_x"))
    odd = jax_init_resnet50(_OddHead("tp_odd_head"), seed=20)
    refs = {f"r50_{tier}": jax_resnet50_tp(mesh, r50, x, precision=_jax_precision(tier))
            for tier in TIERS}
    refs.update({f"basic_{tier}": jax_basicnet_tp(mesh, basic, xb, precision=_jax_precision(tier))
                 for tier in ("f32", "int8")})
    refs["r50_odd"] = jax_resnet50_tp(mesh, odd, jnp.asarray(cases["inputs"]["r50_odd_x"]))
    return {k: np.asarray(v) for k, v in refs.items()}


@pytest.fixture(scope="module")
def world(world_future, jax_refs):
    return world_future.result()


def _jax_precision(tier):
    return None if tier == "f32" else tier


def _err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


def test_every_rank_returns_the_whole_logits(world):
    for r, res in enumerate(world[1:], start=1):
        assert res.keys() == world[0].keys()
        for key, value in res.items():
            want = world[0][key]
            for tier in TIERS if isinstance(value, dict) else (None,):
                got, ref = (value[tier], want[tier]) if tier else (value, want)
                assert torch.equal(got, ref), (r, key, tier)


def test_tp_resnet50_matches_jax_at_model_axis_2_and_4(world, cases, jax_refs):
    golden = cases["r50_case"]["golden"]
    for key in ("r50_tp_f32", "r50_tp4_f32"):
        got = world[0][key].numpy()
        assert got.shape == (4, 16)
        assert _err(got, jax_refs["r50_f32"]) <= F32_TP_ATOL, key
        assert _err(got[0], golden) <= F32_TP_ATOL, key


def test_tp_resnet50_head_with_classes_not_dividing_the_axis(world, jax_refs):
    got = world[0]["r50_odd_head"].numpy()
    assert got.shape == (4, 13)
    assert _err(got, jax_refs["r50_odd"]) <= F32_TP_ATOL


def test_tp_resnet50_bf16w_and_int8_match_jax(world, cases, jax_refs):
    assert _err(world[0]["r50_tp_bf16w"], jax_refs["r50_bf16w"]) <= BF16W_ATOL
    got = world[0]["r50_tp_int8"].numpy()
    assert _err(got, jax_refs["r50_int8"]) <= CHAINED_RTOL
    assert _err(got[0], cases["r50_case"]["golden"]) < INT8_RTOL_BACKBONE


def test_tp_basicnet_matches_jax_every_tier(world, cases, jax_refs):
    golden = cases["basic_case"]["golden"]
    for key in ("basic_tp_f32", "basic_tp4_f32"):
        got = world[0][key].numpy()
        assert got.shape == (4, 16)
        assert _err(got, jax_refs["basic_f32"]) <= F32_TP_ATOL, key
        assert _err(got[0], golden) <= F32_TP_ATOL, key
    assert _err(world[0]["basic_tp_bf16w"], jax_refs["basic_f32"]) < BF16W_RTOL_BACKBONE
    got = world[0]["basic_tp_int8"].numpy()
    assert _err(got, jax_refs["basic_int8"]) <= CHAINED_RTOL
    assert _err(got[0], golden) < INT8_RTOL_BACKBONE


@pytest.mark.parametrize("family", ["r50", "basic"])
def test_engines_serve_every_tier_under_model_and_data(world, family, jax_refs):
    res = world[0]
    jax_f32 = jax_refs[f"{family}_f32"]
    for tier in TIERS:
        assert torch.equal(res[f"{family}_engine_model"][tier], res[f"{family}_tp_{tier}"]), tier
        single = res[f"{family}_engine_single"][tier]
        for key in ("engine_data", "engine_data41"):
            assert _err(res[f"{family}_{key}"][tier], single) <= DATA_ATOL, (key, tier)
    assert _err(res[f"{family}_engine_data"]["f32"], jax_f32) <= F32_TP_ATOL
