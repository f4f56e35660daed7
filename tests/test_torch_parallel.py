"""The port's mesh, data-parallel and tensor-parallel layers against the
JAX package, on the CPU.

One world of four gloo ranks (tests/torch_parallel_ranks.py::
parallel_world, started once for the module by spawn_world) runs, with the
kernels' plain versions: the meshes (2 x 2, 1 x 4, 4 x 1), the block under
block_shardings' layout (sharded_block_inference), the port's block on
batch shards (sharded_block_inference_fused), the data-parallel train step
(the plain operators and the port's block kernel's VJPs; on the 2 x 2 mesh
the plain step is channel-sharded, its state cut by shard_train_state and
gathered by gather_train_state) beside the single-device step, the TP 1x1
reduce and expand, the row-parallel 3x3,
the TP block (model axis 2 and 4) and stage, and BackboneEngine and
BottleneckEngine under a mesh at every tier. The same seeded numpy inputs
go through the JAX package's counterparts on the conftest's eight virtual
devices (make_mesh(8, model_axis=2); Pallas in interpret mode, as
tests/test_parallel.py runs them).

Bounds: f32 against the JAX counterpart 1e-4 * max(1, max|ref|) (the TP
3x3 on unit-normal data also rtol 1e-4, tests/test_parallel.py's); the
train step's losses rtol 1e-4 and its parameters 1e-4 * max(1, max|ref|)
against the JAX step (tests/test_torch_train.py's bars), the data-parallel
step within 1e-5 of the single-device step on the whole batch; the engines
under a mesh within 1e-6 * max(1, max|ref|) of the single-device engine at
every tier (the same arithmetic on batch shards), the f32 backbone within
1e-3 of its float64 golden and int8 within INT8_RTOL_BACKBONE of it
(tests/test_parallel.py's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_ranks import TIERS, parallel_world, world_in_background
from winograd_tpu.ops import jnp_ops
from winograd_tpu.parallel import (
    bottleneck_block_tp as jax_block_tp,
    conv1x1_bn_tp_expand as jax_tp_expand,
    conv1x1_bn_tp_reduce as jax_tp_reduce,
    conv3x3_bn_tp_direct as jax_tp_direct,
    make_mesh as jax_make_mesh,
    make_train_step as jax_make_train_step,
    sharded_block_inference as jax_sharded_block,
    sharded_block_inference_pallas as jax_sharded_block_pallas,
)
from winograd_tpu.parallel.tensor_parallel import resnet_stage_tp as jax_stage_tp
from winograd_tpu_torch.config import INT8_RTOL_BACKBONE, BackboneConfig
from winograd_tpu_torch.datagen.generate import (
    _block_params_random, backbone_stages, make_backbone_case,
)
from winograd_tpu_torch.kernels.direct import direct_filter
from winograd_tpu_torch.parallel import block_shardings
from winograd_tpu_torch.parallel.data_parallel import TRAIN_KEYS

ATOL = 1e-4
ENGINE_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class _TinyBackbone(BackboneConfig):
    stages = ((64, 16, 8, 1), (128, 32, 4, 1))


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _layer(rng, cin, cout, x_shape):
    return {"x": _normal(rng, *x_shape), "w": _normal(rng, cin, cout, scale=0.1),
            "s": _normal(rng, cout), "b": _normal(rng, cout)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    direct = _layer(rng, 64, 32, (4, 14, 14, 64))
    direct["w_oihw"] = _normal(rng, 32, 64, 3, 3, scale=0.1)
    direct["w9r"] = direct_filter(direct["w_oihw"]).reshape(9, 64, 32)
    train = _block_params_random(rng, 32, 16, bn_scale=0.5)
    backbone_cfg = _TinyBackbone("tiny_backbone", batch=8)
    backbone_case = make_backbone_case(backbone_cfg, seed=3)
    return {
        "block": _block_params_random(rng, 32, 16, bn_scale=0.5),
        "block_x": _normal(rng, 8, 14, 14, 32),
        "fused_block": _block_params_random(rng, 128, 128, bn_scale=0.5),
        "fused_x": _normal(rng, 8, 14, 14, 128, scale=0.5),
        "train_params": {k: train[k] for k in TRAIN_KEYS},
        "train_x": _normal(rng, 8, 14, 14, 32),
        "train_t": _normal(rng, 8, 14, 14, 32),
        "reduce": _layer(rng, 256, 128, (4, 14, 14, 256)),
        "expand": _layer(rng, 128, 256, (4, 14, 14, 128)),
        "direct": direct,
        "tp_block": _block_params_random(rng, 64, 32, bn_scale=0.5),
        "tp_block_x": _normal(rng, 4, 14, 14, 64, scale=0.5),
        "tp_stage": [_block_params_random(rng, 128, 32, bn_scale=0.5) for _ in range(2)],
        "tp_stage_x": _normal(rng, 4, 7, 7, 128, scale=0.5),
        "backbone": backbone_stages(backbone_cfg, backbone_case),
        "backbone_x": backbone_case["x"],
        "backbone_golden": backbone_case["golden"],
    }


@pytest.fixture(scope="module")
def world_future(inputs):
    with world_in_background(parallel_world, 4, inputs) as future:
        yield future


@pytest.fixture(scope="module")
def jax_refs(inputs, world_future):
    """The JAX package's counterparts on make_mesh(8, model_axis=2),
    computed while the world runs."""
    mesh = jax_make_mesh(8, model_axis=2)
    r, e, d = inputs["reduce"], inputs["expand"], inputs["direct"]
    refs = {
        "sharded_block": jax_sharded_block(mesh, _jnp(inputs["block"]),
                                           jnp.asarray(inputs["block_x"])),
        "sharded_block_fused": jax_sharded_block_pallas(mesh, _jnp(inputs["fused_block"]),
                                                        jnp.asarray(inputs["fused_x"])),
        "tp_reduce": jax_tp_reduce(mesh, *(jnp.asarray(r[k]) for k in "xwsb"), relu=True),
        "tp_expand": jax_tp_expand(mesh, *(jnp.asarray(e[k]) for k in "xwsb"), relu=False),
        "tp_direct": jax_tp_direct(mesh, jnp.asarray(d["x"]), jnp.asarray(d["w9r"]),
                                   jnp.asarray(d["s"]), jnp.asarray(d["b"]), relu=True),
        "tp_block": jax_block_tp(mesh, jnp.asarray(inputs["tp_block_x"]),
                                 _jnp(inputs["tp_block"])),
        "tp_stage": jax_stage_tp(mesh, jnp.asarray(inputs["tp_stage_x"]),
                                 [_jnp(b) for b in inputs["tp_stage"]]),
    }
    step = jax_make_train_step(mesh, lr=1e-2)
    params = _jnp(inputs["train_params"])
    momentum = jax.tree.map(jnp.zeros_like, params)
    losses = []
    with mesh:
        for _ in range(2):
            params, momentum, loss = step(params, momentum, jnp.asarray(inputs["train_x"]),
                                          jnp.asarray(inputs["train_t"]))
            losses.append(float(loss))
    refs = {k: np.asarray(v) for k, v in refs.items()}
    refs["train"] = {"losses": losses, "params": {k: np.asarray(v) for k, v in params.items()}}
    return refs


@pytest.fixture(scope="module")
def world(world_future, jax_refs):
    return world_future.result()


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


def test_meshes_lay_the_ranks_out_row_major(world):
    assert world[0]["names"] == ["data", "model"]
    assert world[0]["shape22"] == {"data": 2, "model": 2}
    assert [r["coords22"] for r in world] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert [r["coords41"] for r in world] == [[0, 0], [1, 0], [2, 0], [3, 0]]


def test_block_shardings_cover_the_block_params():
    x_spec, specs = block_shardings()
    assert x_spec == ("data", None, None, "model")
    assert set(_block_params_random(np.random.default_rng(0), 32, 16)) <= set(specs)
    assert specs["w_reduce"] == ("model", None) and specs["w_expand"] == (None, "model")


def test_every_rank_returns_the_whole_result(world):
    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else True

    for key in world[0]:
        if not key.startswith(("coords", "train_single", "backbone_single",
                               "bottleneck_engine_single")):
            assert all(equal(r[key], world[0][key]) for r in world[1:]), key


def test_sharded_blocks_match_jax(world, jax_refs):
    assert _err(world[0]["sharded_block"], jax_refs["sharded_block"]) <= ATOL
    for key in ("sharded_block_fused", "sharded_block_fused_41"):
        assert _err(world[0][key], jax_refs["sharded_block_fused"]) <= ATOL, key


def test_data_parallel_train_step_matches_jax_and_one_device(world, jax_refs):
    want, single = jax_refs["train"], world[0]["train_single"]
    for key in ("train", "train41", "train_kernels"):
        res = world[0][key]
        np.testing.assert_allclose(res["losses"].numpy(), want["losses"], rtol=1e-4, err_msg=key)
        for k in TRAIN_KEYS:
            assert _err(res["params"][k], want["params"][k]) <= ATOL, (key, k)
            assert _err(res["params"][k], single["params"][k]) <= 1e-5, (key, k)
    assert want["losses"][1] < want["losses"][0]


def test_channel_sharded_train_step_holds_its_shards(world):
    """On the 2 x 2 mesh a rank holds 1/2 of w_reduce, w_expand, s_expand and
    b_expand and the whole of the rest, and the replicated leaves' gradients
    are equal on the two ranks of a "model" row (ranks 0 and 1)."""
    from torch_parallel_ranks import REPLICATED_TRAIN_KEYS

    _, specs = block_shardings()
    for r in world:
        fraction = r["train_shards"]["fraction"]
        assert set(fraction) == set(TRAIN_KEYS)
        for k in TRAIN_KEYS:
            assert fraction[k] == (0.5 if "model" in specs[k] else 1.0), k
    row = [world[0]["train_shards"]["first_grads"], world[1]["train_shards"]["first_grads"]]
    for k in REPLICATED_TRAIN_KEYS:
        assert torch.equal(row[0][k], row[1][k]), k
        assert row[0][k].abs().max() > 0, k


def test_tp_layers_match_jax(world, jax_refs):
    for name in ("tp_reduce", "tp_expand"):
        for key in (name, name + "4"):
            assert _err(world[0][key], jax_refs[name]) <= ATOL, key
    for key in ("tp_direct", "tp_direct4"):
        np.testing.assert_allclose(world[0][key].numpy(), jax_refs["tp_direct"], atol=ATOL,
                                   rtol=1e-4, err_msg=key)


def test_tp_block_and_stage_match_jax(world, inputs, jax_refs):
    for key in ("tp_block", "tp_block4"):
        assert _err(world[0][key], jax_refs["tp_block"]) <= ATOL, key
    assert _err(world[0]["tp_stage"], jax_refs["tp_stage"]) <= ATOL
    xla = jnp.asarray(inputs["tp_stage_x"])
    for b in inputs["tp_stage"]:
        xla = jnp_ops.bottleneck_block(xla, _jnp(b))
    assert _err(world[0]["tp_stage"], xla) <= ATOL


def test_engines_of_blocks_under_a_mesh(world, inputs):
    golden = inputs["backbone_golden"]
    for key in ("backbone", "backbone41"):
        out = world[0][key]
        for tier in TIERS:
            assert _err(out[tier], world[0]["backbone_single"][tier]) <= ENGINE_ATOL, (key, tier)
        assert np.abs(out["f32"].numpy() - golden).max() < 1e-3
        assert np.abs(out["int8"].numpy() - golden).max() / np.abs(golden).max() < \
            INT8_RTOL_BACKBONE
    want = jnp.asarray(inputs["tp_block_x"])
    for _ in range(2):
        want = jnp_ops.bottleneck_block(want, _jnp(inputs["tp_block"]))
    for tier in TIERS:
        assert _err(world[0]["bottleneck_engine"][tier],
                    world[0]["bottleneck_engine_single"][tier]) <= ENGINE_ATOL, tier
    assert _err(world[0]["bottleneck_engine"]["f32"], want) <= ATOL
