"""The port's GPipe pipelines (parallel/pipeline.py) against the JAX
package, on the CPU.

_balanced_partition is a plain function, tested as one. Everything else
runs in one world of six gloo ranks (tests/torch_parallel_ranks.py::
pipeline_world, started once for the module by spawn_world), whose pipes
of 2, 3, 4 and 6 ranks are sub-groups of it, with the kernels' plain
versions: a uniform run of blocks on 2 and 3 ranks (and its refusal of 6
blocks on 4), the port's block kernel pipelined, a deep tiny ResNet-50 on
2, 3 and 6 ranks at f32 and on 4 at bf16w and int8, an int8 pipe of two
ranks whose multi-block runs coalesce, odd maps entering a transition,
the basic family on 2 and 3 ranks (int8 on 2), and both classifier
engines under partition "pipe" at every tier. The same seeded numpy inputs
go through the JAX package: its pipelined functions on the conftest's
virtual devices (Pallas in interpret mode) for the bf16w and int8 tiers,
and its XLA forwards (resnet50_forward_xla, basicnet_forward_xla, the
jnp block) for f32, which its own pipelines match (tests/test_pipeline.py).

Bounds: f32 against XLA 1e-4 * max(1, max|ref|) (tests/test_pipeline.py's
1e-4); bf16w 1e-4 * max(1, max|ref|) of the JAX bf16w pipeline (the port's
bf16w bar, tests/test_torch_bf16w.py); int8 CHAINED_RTOL 1e-3 of the JAX
int8 pipeline (tests/test_torch_int8_resnet50.py); the engines' "pipe"
logits within 1e-6 * max(1, max|ref|) of the single-device engine at every
tier: a rank's group runs the single-device routes on its blocks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_ranks import TIERS, pipeline_world, world_in_background
from winograd_tpu.config import BasicNetConfig, ResNet50Config
from winograd_tpu.datagen.generate import make_basicnet_case
from winograd_tpu.models.basic import basicnet_forward_xla
from winograd_tpu.models.basic import basicnet_params as jax_basicnet_params
from winograd_tpu.models.basic import quantize_basicnet as jax_quantize_basicnet
from winograd_tpu.models.resnet50 import init_resnet50_params as jax_init_resnet50
from winograd_tpu.models.resnet50 import quantize_resnet50 as jax_quantize_resnet50
from winograd_tpu.models.resnet50 import resnet50_forward_xla
from winograd_tpu.ops import jnp_ops
from winograd_tpu.parallel import make_pipe_mesh as jax_pipe_mesh
from winograd_tpu.parallel import pipelined_basicnet_inference as jax_pipe_basic
from winograd_tpu.parallel import pipelined_resnet50_inference as jax_pipe_r50
from winograd_tpu_torch.datagen.generate import _block_params_random
from winograd_tpu_torch.models.basic import basicnet_arrays
from winograd_tpu_torch.models.resnet50 import init_resnet50_arrays
from winograd_tpu_torch.parallel.pipeline import _balanced_partition

ATOL = 1e-4
BF16W_ATOL = 1e-4
CHAINED_RTOL = 1e-3
ENGINE_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class _TinyDeep(ResNet50Config):
    stages = ((16, 8, 8, 2), (32, 8, 4, 3), (64, 16, 2, 2))
    img: int = 32
    stem_c: int = 8
    num_classes: int = 24


@dataclasses.dataclass(frozen=True)
class _TinyOdd(ResNet50Config):
    stages = ((16, 8, 7, 1), (32, 8, 4, 1))
    img: int = 28
    stem_c: int = 8
    num_classes: int = 24


@dataclasses.dataclass(frozen=True)
class _TinyBasic(BasicNetConfig):
    stages = ((16, 16, 2), (32, 8, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    basic_case = make_basicnet_case(_TinyBasic("pipe_basic"), seed=61)
    return {
        "stage_blocks": [_block_params_random(rng, 64, 32, bn_scale=0.5) for _ in range(6)],
        "stage_x": _normal(rng, 4, 14, 14, 64, scale=0.1),
        "fused_blocks": [_block_params_random(rng, 64, 32, bn_scale=0.5) for _ in range(4)],
        "fused_x": _normal(rng, 4, 14, 14, 64, scale=0.1),
        "deep": init_resnet50_arrays(_TinyDeep("pipe_deep"), seed=21),
        "deep_x": _normal(rng, 6, 32, 32, 3),
        "odd": init_resnet50_arrays(_TinyOdd("pipe_odd"), seed=35),
        "odd_x": _normal(rng, 4, 28, 28, 3),
        "basic": basicnet_arrays(basic_case, _TinyBasic("pipe_basic")),
        "basic_x": np.stack([basic_case["x"] * s for s in (1.0, 0.5, -0.25, 2.0)]).astype(
            np.float32),
        "basic_case": basic_case,
    }


@pytest.fixture(scope="module")
def world_future(inputs):
    inp = {k: v for k, v in inputs.items() if k != "basic_case"}
    with world_in_background(pipeline_world, 6, inp) as future:
        yield future


@pytest.fixture(scope="module")
def jax_refs(inputs, world_future):
    """The JAX package's references (module docstring), computed while the
    world runs."""
    refs = {}
    for key in ("stage", "fused"):
        x = jnp.asarray(inputs[f"{key}_x"])
        for b in inputs[f"{key}_blocks"]:
            x = jnp_ops.bottleneck_block(x, _jnp(b))
        refs[key] = x
    deep, x = jax_init_resnet50(_TinyDeep("pipe_deep"), seed=21), jnp.asarray(inputs["deep_x"])
    refs["deep"] = resnet50_forward_xla(x, deep)
    refs["deep_bf16w"] = jax_pipe_r50(jax_pipe_mesh(4), deep, x, microbatch=2, precision="bf16w")
    refs["deep_int8"] = jax_pipe_r50(jax_pipe_mesh(2), jax_quantize_resnet50(deep), x,
                                     microbatch=2, precision="int8")
    odd = jax_init_resnet50(_TinyOdd("pipe_odd"), seed=35)
    refs["odd"] = resnet50_forward_xla(jnp.asarray(inputs["odd_x"]), odd)
    basic = jax_basicnet_params(inputs["basic_case"], _TinyBasic("pipe_basic"))
    xb = jnp.asarray(inputs["basic_x"])
    refs["basic"] = basicnet_forward_xla(xb, basic)
    refs["basic_int8"] = jax_pipe_basic(jax_pipe_mesh(2), jax_quantize_basicnet(basic), xb,
                                        microbatch=2, precision="int8")
    return {k: np.asarray(v) for k, v in refs.items()}


@pytest.fixture(scope="module")
def world(world_future, jax_refs):
    return world_future.result()


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


def test_balanced_partition_minimizes_the_bottleneck():
    # A ResNet-152-shaped cost profile: conv4_x dominates. A named-stage
    # split puts all 35 of its blocks on one rank; the balanced split
    # spreads them.
    costs = [10] + [3] * 7 + [8] * 35 + [5] * 2
    b = _balanced_partition(costs, 4)
    assert b[0] == 0 and b[-1] == len(costs)
    groups = [sum(costs[b[i]:b[i + 1]]) for i in range(4)]
    assert max(groups) < sum(costs[8:43])
    assert max(groups) <= sum(costs) / 4 + max(costs)
    assert _balanced_partition([1, 2, 3], 3) == [0, 1, 2, 3]
    # No group is empty even when one cost dominates.
    assert _balanced_partition([4, 1, 1], 3) == [0, 1, 2, 3]


def test_every_member_returns_the_whole_result(world):
    for key, value in world[0].items():
        if isinstance(value, torch.Tensor):
            members = [r for r in world if key in r]
            assert len(members) >= 2, key
            assert all(torch.equal(r[key], value) for r in members), key
    assert [r["pipe_index"] for r in world] == [
        {2: 0, 3: 0, 4: 0, 6: 0}, {2: 1, 3: 1, 4: 1, 6: 1}, {3: 2, 4: 2, 6: 2}, {4: 3, 6: 3},
        {6: 4}, {6: 5}]


def test_uniform_stage_pipeline_matches_the_sequential_blocks(world, jax_refs):
    for key in ("stage_2", "stage_3"):
        assert _err(world[0][key], jax_refs["stage"]) <= ATOL, key
    assert "do not split" in world[0]["stage_4_refused"]
    assert _err(world[0]["stage_fused_2"], jax_refs["fused"]) <= ATOL


def test_classifier_pipes_of_2_3_and_6_ranks_and_odd_maps(world, jax_refs):
    for p in (2, 3, 6):
        got = world[0][f"deep_{p}"].numpy()
        assert got.shape == (6, 24)
        assert _err(got, jax_refs["deep"]) <= ATOL, p
    assert _err(world[0]["odd_4"], jax_refs["odd"]) <= ATOL


def test_classifier_pipe_bf16w_and_int8_match_jax(world, jax_refs):
    assert _err(world[0]["deep_4_bf16w"], jax_refs["deep_bf16w"]) <= BF16W_ATOL
    for key in ("deep_4_int8", "deep_2_int8"):
        assert _err(world[0][key], jax_refs["deep_int8"]) <= CHAINED_RTOL, key


def test_basicnet_pipes_match_jax(world, jax_refs):
    for p in (2, 3):
        assert _err(world[0][f"basic_{p}"], jax_refs["basic"]) <= ATOL, p
    assert _err(world[0]["basic_2_int8"], jax_refs["basic_int8"]) <= CHAINED_RTOL


@pytest.mark.parametrize("family", ["deep", "basic"])
def test_engines_serve_every_tier_under_pipe(world, family):
    engine = "r50" if family == "deep" else "basic"
    for tier in TIERS:
        assert _err(world[0][f"{engine}_engine_pipe"][tier],
                    world[0][f"{family}_single"][tier]) <= ENGINE_ATOL, tier
