"""The port's whole slice against the JAX package, on the tiny ResNet-50 of
tests/test_resnet50.py: JAX init_resnet50_params -> numpy ->
params_from_jax -> port resnet50_forward (CPU, plain versions) against JAX
resnet50_forward_pallas (Pallas interpret mode), and the engine on top; a
three-stage trunk against JAX resnet50_stages; and the route each gate
picks at the full-width shapes. Bound everywhere: 1e-4 * max(1, max|ref|)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.config import ResNet50Config as JaxResNet50Config
from winograd_tpu.config import TransitionConfig
from winograd_tpu.models.resnet import bottleneck_block_pallas
from winograd_tpu.models.resnet50 import init_resnet50_params as jax_init
from winograd_tpu.models.resnet50 import resnet50_forward_pallas, resnet50_forward_xla
from winograd_tpu_torch.config import PARITY_ATOL, ResNet50Config
from winograd_tpu_torch.engine import ResNet50Engine
from winograd_tpu_torch.models import resnet
from winograd_tpu_torch.models.convert import params_from_jax, params_to, stages_from_jax
from winograd_tpu_torch.models.downsample import resnet50_stages
from winograd_tpu_torch.models.resnet50 import (
    init_resnet50_arrays,
    init_resnet50_params,
    resnet50_forward,
)
from winograd_tpu_torch.parallel import make_mesh, make_pipe_mesh
from torch_parallel_ranks import one_rank_world


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


@pytest.mark.parametrize("algo", ["fused", "direct", "winograd"])
def test_bottleneck_block_routes_match_jax(algo):
    """Each of the block's routes (one block kernel launch, or per layer with
    either 3x3) against the JAX package's fused block."""
    from winograd_tpu.datagen.generate import _block_params_random

    rng = np.random.default_rng(12)
    blk = _block_params_random(rng, 32, 8, bn_scale=0.5)
    x = (rng.random((2, 14, 14, 32)) - 0.5).astype(np.float32)
    ref = bottleneck_block_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray, blk), algo3x3="fused")
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in blk.items()}
    assert _close(resnet.bottleneck_block(torch.from_numpy(x), params, algo3x3=algo).numpy(), ref)


def test_engine_rejects_unported_options(tmp_path):
    """Every tier is served (the bf16w tier's tests are
    tests/test_torch_bf16w.py) and an unknown tier is refused; a mesh that
    is not a parallel.Mesh, an unknown partition and a partition without a
    mesh are refused; under a mesh (here one rank in this process; larger
    meshes in tests/test_torch_parallel_classifier.py and
    tests/test_torch_pipeline.py) the "model" and "pipe" partitions serve
    the single-device logits within 1e-4 * max(1, max|ref|), eagerly."""
    cfg = _TinyR50("tiny_resnet50")
    params = init_resnet50_params(cfg, seed=0, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        ResNet50Engine(params, device="cpu", mesh=object())
    for partition in ("model", "pipes"):
        with pytest.raises(ValueError, match="partition"):
            ResNet50Engine(params, device="cpu", partition=partition)
    with pytest.raises(ValueError, match="tier"):
        ResNet50Engine(params, device="cpu", tier="bf16")
    x = _images(4, 2, cfg.img)
    want = ResNet50Engine(params, device="cpu")(x).numpy()
    with one_rank_world(tmp_path):
        model = ResNet50Engine(params, device="cpu", mesh=make_mesh(1, 1, device="cpu"),
                               partition="model")
        pipe = ResNet50Engine(params, device="cpu", mesh=make_pipe_mesh(1, device="cpu"),
                              partition="pipe")
        for engine in (model, pipe):
            assert _close(engine(x).numpy(), want)
            assert engine.replays == 0
        with pytest.raises(ValueError, match="axes"):
            ResNet50Engine(params, device="cpu", mesh=model.mesh, partition="pipe")
        with pytest.raises(ValueError, match="one device"):
            model.serve_pre(model.prepare_input(x), img=cfg.img)


def test_full_width_config_matches_jax_package():
    ours, theirs = ResNet50Config(), JaxResNet50Config("resnet50_full")
    assert ours.stages == theirs.stages
    assert (ours.img, ours.stem_c, ours.num_classes) == (theirs.img, theirs.stem_c, theirs.num_classes)


def test_trunk_matches_jax_resnet50_stages():
    """Three stages of two blocks at 28x28 (F(2,3) mid), 14x14 and 7x7
    (direct mid), the last two entered through stride-2 transitions: the
    stage kernel on both mids and the transition kernel, through
    stages_from_jax (stacked params, fused transition weights) and through
    raw per-block params (stacked and fused per call)."""
    from winograd_tpu.datagen.generate import _block_params_random, _transition_params_random
    from winograd_tpu.models.downsample import resnet50_stages as jax_stages

    rng = np.random.default_rng(11)
    stages, c_prev = [], None
    for c_io, c_mid, hw in ((32, 8, 28), (64, 16, 14), (128, 32, 7)):
        t = None if c_prev is None else _transition_params_random(
            rng, TransitionConfig("t", c_prev, c_mid, c_io, hw=2 * hw), bn_scale=0.5)
        blocks = [_block_params_random(rng, c_io, c_mid, bn_scale=0.5) for _ in range(2)]
        stages.append({"transition": t, "blocks": blocks})
        c_prev = c_io
    x = (rng.random((1, 28, 28, 32)) - 0.5).astype(np.float32)
    ref = np.asarray(jax_stages(jnp.asarray(x), jax.tree.map(jnp.asarray, stages),
                                precision="highest"))
    assert ref.shape == (1, 7, 7, 128)
    converted = stages_from_jax(stages, device="cpu")
    assert all(st["stacked"] is not None for st in converted)
    moved = params_to(converted, "cpu", torch.float64)      # a copy, weights still stored once
    assert moved[2]["blocks"][1]["w9_mid"].data_ptr() == moved[2]["stacked"]["w9_mid"][1].data_ptr()
    assert moved[2]["blocks"][1]["s_mid"].shape == (32,)
    assert _close(resnet50_stages(torch.from_numpy(x), converted).numpy(), ref)
    raw = [{"transition": None if st["transition"] is None else
            {k: torch.from_numpy(np.asarray(v)) for k, v in st["transition"].items()},
            "blocks": [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
                       for b in st["blocks"]]} for st in stages]
    assert _close(resnet50_stages(torch.from_numpy(x), raw).numpy(), ref)


def _shape_only(*shape):
    return np.broadcast_to(np.float32(0), shape)


def _block_shapes(c_io, c_mid):
    return {"w_reduce": _shape_only(c_io, c_mid), "w9_mid": _shape_only(9 * c_mid, c_mid),
            "u2_mid": _shape_only(16, c_mid, c_mid), "w_expand": _shape_only(c_mid, c_io),
            **{k: _shape_only(c_mid) for k in ("s_reduce", "b_reduce", "s_mid", "b_mid")},
            **{k: _shape_only(c_io) for k in ("s_expand", "b_expand")}}


def _routes(monkeypatch):
    """Stub every kernel call of both packages' block, stage and transition
    functions with one that records the route taken and runs nothing."""
    import winograd_tpu.kernels.block as jax_block
    import winograd_tpu.kernels.stage as jax_stage
    import winograd_tpu.kernels.transition as jax_transition
    import winograd_tpu.models.resnet as jax_resnet
    from winograd_tpu_torch.models import downsample

    taken = []

    def record(route):
        def stub(x, *args, **kwargs):
            taken.append(route)
            return x
        return stub

    for mod, name, route in (
        (jax_stage, "resnet_stage_fused_pallas", "fused_stage"),
        (jax_stage, "stack_stage_params", None),
        (jax_block, "bottleneck_block_fused_pallas", "fused"),
        (jax_resnet, "conv1x1_bn_pallas", None),
        (jax_resnet, "conv3x3_bn_direct_pallas", "direct"),
        (jax_resnet, "conv3x3_bn_winograd_pallas", "winograd"),
        (jax_transition, "transition_block_fused_pallas", "transition_fused"),
        (resnet, "resnet_stage_fused", "fused_stage"),
        (resnet, "stack_stage_params", None),
        (resnet, "bottleneck_block_fused", "fused"),
        (resnet, "conv1x1_bn", None),
        (resnet, "conv3x3_bn_direct", "direct"),
        (resnet, "conv3x3_bn_winograd", "winograd"),
        (downsample, "transition_block_fused", "transition_fused"),
    ):
        monkeypatch.setattr(mod, name, (lambda x, *a, **k: x) if route is None else record(route))
    return taken


def test_route_choice_matches_jax_gates_at_full_width(monkeypatch):
    """Arithmetic on shapes only: for each full-width ResNet-50 stage (and
    single-block stages of its geometries), the port's resnet_stage,
    bottleneck_block and downsample_bottleneck_block take the route the
    JAX package's gates take. No kernel runs."""
    from winograd_tpu.models.downsample import downsample_bottleneck_block_pallas
    from winograd_tpu.models.resnet import resnet_stage_pallas
    from winograd_tpu_torch.models.downsample import downsample_bottleneck_block

    taken = _routes(monkeypatch)

    def route(fn, x, *args):
        taken.clear()
        fn(x, *args)
        return list(taken)

    cfg = ResNet50Config()
    jx, tx = jnp.zeros(1), torch.zeros(1)
    full = []
    for c_io, c_mid, _hw, n_blocks in cfg.stages:
        for blocks in ([_block_shapes(c_io, c_mid)] * n_blocks, [_block_shapes(c_io, c_mid)]):
            ours = route(resnet.resnet_stage, tx, blocks)
            assert ours == route(resnet_stage_pallas, jx, blocks), (c_io, c_mid, len(blocks))
            if len(blocks) > 1:
                full.append(ours)
        block = _block_shapes(c_io, c_mid)
        assert route(resnet.bottleneck_block, tx, block) == route(
            bottleneck_block_pallas, jx, block)
        assert resnet.block_algo(block) == ("fused" if c_io < 2048 else "direct")
        transition = dict(block, w_proj=_shape_only(c_io // 2, c_io),
                          s_proj=_shape_only(c_io), b_proj=_shape_only(c_io))
        assert route(downsample_bottleneck_block, tx, transition) == route(
            downsample_bottleneck_block_pallas, jx, transition) == ["transition_fused"]
    assert full == [["fused_stage"], ["fused_stage"], ["fused_stage"], ["direct", "direct"]]

