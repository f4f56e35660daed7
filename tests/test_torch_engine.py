"""The port's serving engines on the CPU (device="cpu": the kernels' plain
versions, no graphs) against the JAX package's engines (Pallas interpret
mode), on tiny models.

* ResNet50Engine and ResNetBasicEngine through from_case: __call__,
  classify and serve_pre (prepare_input on the host) against the JAX
  engine's logits within 1e-4 * max(1, max|ref|), serve_pre equal to
  __call__ to the bit (the JAX engine's serve_pre equals its __call__ to the
  bit, tests/test_engine.py, so one JAX forward is the reference of both
  routes); at int8 within 5e-2 * max(1, max|ref|) of the JAX int8 engine
  and of the float64 golden, and serve_pre refused; throughput's four keys.
* BottleneckEngine from a save_params checkpoint of one 14x14x128 block
  within 1e-5 (the JAX test's bound) of the block in float64, and within
  1e-4 * max(1, max|ref|) of the JAX engine from the same file (whose
  bf16x3 products sit 4.2e-5 from float64 there, the port 3.5e-6);
  a two-block run at every tier against the JAX engine (f32 1e-4, bf16w
  BF16W_RTOL_BACKBONE, int8 INT8_RTOL_BACKBONE).
* BackboneEngine at f32 within 1e-3 of the golden (the JAX test's bound)
  and 1e-4 of the JAX engine, at int8 within 2e-1 of the golden (the JAX
  test's bound) and INT8_RTOL_BACKBONE of the JAX int8 engine.
"""

import dataclasses

import numpy as np
import pytest
import torch

from winograd_tpu import engine as jeng
from winograd_tpu.config import BackboneConfig as JaxBackboneConfig
from winograd_tpu.config import BasicNetConfig as JaxBasicNetConfig
from winograd_tpu.config import ResNet50Config as JaxResNet50Config
from winograd_tpu.datagen.generate import (
    backbone_stages,
    make_backbone_case,
    make_basicnet_case,
    make_resnet50_case,
)
from winograd_tpu.models import init_bottleneck_params, save_params
from winograd_tpu_torch import engine as teng
from winograd_tpu_torch.config import BF16W_RTOL_BACKBONE, INT8_RTOL_BACKBONE, PARITY_ATOL
from winograd_tpu_torch.models.convert import stages_from_jax
from winograd_tpu_torch.models.resnet import bottleneck_block
from winograd_tpu_torch.models.resnet50 import init_resnet50_params
from winograd_tpu_torch.parallel import make_mesh
from torch_parallel_ranks import one_rank_world


@dataclasses.dataclass(frozen=True)
class _TinyR50(JaxResNet50Config):
    stages = ((64, 16, 8, 1), (128, 32, 4, 1))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 24


@dataclasses.dataclass(frozen=True)
class _TinyBasic(JaxBasicNetConfig):
    stages = ((16, 8, 1), (32, 4, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


@dataclasses.dataclass(frozen=True)
class _TinyBackbone(JaxBackboneConfig):
    stages = ((32, 8, 8, 2), (64, 16, 4, 1))


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape and np.isfinite(out).all()
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


CLASSIFIERS = {
    "resnet50": (_TinyR50, make_resnet50_case, jeng.ResNet50Engine, teng.ResNet50Engine),
    "basic": (_TinyBasic, make_basicnet_case, jeng.ResNetBasicEngine, teng.ResNetBasicEngine),
}


@pytest.mark.parametrize("family", sorted(CLASSIFIERS))
def test_classifier_engine_matches_jax(family):
    cfg_cls, make, jax_engine, port_engine = CLASSIFIERS[family]
    cfg = cfg_cls(f"tiny_{family}_engine")
    case = make(cfg, seed=11)
    x = case["x"]
    xs = np.stack([x, 0.5 * x]).astype(np.float32)
    ref = np.asarray(jax_engine.from_case(case, cfg)(xs))

    engine = port_engine.from_case(case, cfg, device="cpu")
    out = engine(x)
    assert tuple(out.shape) == (cfg.num_classes,)
    assert _rel(out, ref[0]) <= PARITY_ATOL
    assert _rel(engine(xs), ref) <= PARITY_ATOL
    assert engine.classify(xs).tolist() == np.argmax(ref, axis=-1).tolist()
    assert int(engine.classify(x)) == int(np.argmax(ref[0]))
    xb = engine.prepare_input(xs)
    assert xb.device.type == "cpu"
    pre = engine.serve_pre(xb, img=cfg.img)
    assert _rel(pre, ref) <= PARITY_ATOL
    assert torch.equal(pre, engine(xs))

    ref8 = np.asarray(jax_engine.from_case(case, cfg, tier="int8")(x))
    int8 = port_engine.from_case(case, cfg, tier="int8", device="cpu")
    assert _rel(int8(x), ref8) < INT8_RTOL_BACKBONE
    assert _rel(int8(x), case["golden"]) < INT8_RTOL_BACKBONE
    with pytest.raises(ValueError, match="int8"):
        int8.serve_pre(int8.prepare_input(x), img=cfg.img)

    stats = engine.throughput(batch=2, iters=2, img=cfg.img)
    assert set(stats) == {"batch", "iters", "images_per_sec", "latency_ms"}
    assert stats["batch"] == 2 and stats["iters"] == 2 and stats["images_per_sec"] > 0


def test_bottleneck_engine_from_checkpoint(tmp_path):
    params = init_bottleneck_params(0, c_io=128, c_mid=128)
    raw = {k: np.asarray(v) for k, v in params.items() if k not in ("u_mid", "w9_mid")}
    path = str(tmp_path / "ckpt.npz")
    save_params(path, raw)
    x = np.random.default_rng(1).standard_normal((14, 14, 128)).astype(np.float32)
    ref = np.asarray(jeng.BottleneckEngine.from_checkpoint(path)(x))
    out = teng.BottleneckEngine.from_checkpoint(path, device="cpu")(x)
    assert tuple(out.shape) == (14, 14, 128)
    block64 = stages_from_jax([{"transition": None, "blocks": [raw]}], "cpu", torch.float64)
    exact = bottleneck_block(torch.from_numpy(x).double()[None], block64[0]["blocks"][0])[0]
    np.testing.assert_allclose(out.numpy(), exact.numpy(), atol=1e-5)
    assert _rel(out, ref) <= PARITY_ATOL


@pytest.mark.parametrize("tier,bound", [("f32", PARITY_ATOL), ("bf16w", BF16W_RTOL_BACKBONE),
                                        ("int8", INT8_RTOL_BACKBONE)])
def test_bottleneck_engine_tiers_match_jax(tier, bound):
    blocks = [{k: np.asarray(v) for k, v in init_bottleneck_params(s, c_io=64, c_mid=16).items()}
              for s in (2, 3)]
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 64)).astype(np.float32)
    ref = np.asarray(jeng.BottleneckEngine(blocks, tier=tier)(x))
    engine = teng.BottleneckEngine(blocks, tier=tier, device="cpu")
    assert _rel(engine(x), ref) <= bound
    stats = engine.throughput(batch=1, iters=1, hw=8)
    assert stats["images_per_sec"] > 0


def test_backbone_engine_both_tiers():
    cfg = _TinyBackbone("tiny_backbone_engine")
    case = make_backbone_case(cfg, seed=13)
    stages = backbone_stages(cfg, case)
    gold = case["golden"]
    out = teng.BackboneEngine(stages, device="cpu")(case["x"]).numpy()
    assert np.abs(out - gold).max() < 1e-3
    assert _rel(out, jeng.BackboneEngine(stages)(case["x"])) <= PARITY_ATOL
    out8 = teng.BackboneEngine(stages, tier="int8", device="cpu")(case["x"]).numpy()
    assert _rel(out8, gold) < 2e-1 and np.corrcoef(out8.ravel(), gold.ravel())[0, 1] > 0.98
    assert _rel(out8, jeng.BackboneEngine(stages, tier="int8")(case["x"])) < INT8_RTOL_BACKBONE
    out16 = teng.BackboneEngine(stages, tier="bf16w", device="cpu")(case["x"]).numpy()
    assert _rel(out16, gold) < BF16W_RTOL_BACKBONE
    stats = teng.BackboneEngine(stages, device="cpu").throughput(batch=1, hw=8, c_in=32, iters=1)
    assert set(stats) == {"batch", "iters", "images_per_sec", "latency_ms"}


def test_resnet50_engine_folds_a_missing_transition_stream():
    """Port parameters whose transitions lack the fused expand+projection
    weights (wep, bep) get them folded once at construction, at f32 and
    bf16w: the same logits as with them."""
    cfg = _TinyR50("tiny_fold")
    params = init_resnet50_params(cfg, seed=2, device="cpu")
    stripped = dict(params, stages=[
        dict(st, transition=None if st["transition"] is None else
             {k: v for k, v in st["transition"].items() if k not in ("wep", "bep")})
        for st in params["stages"]])
    assert any(st["transition"] is not None for st in stripped["stages"])
    x = np.random.default_rng(2).standard_normal((cfg.img, cfg.img, 3)).astype(np.float32)
    for tier in ("f32", "bf16w"):
        assert torch.equal(teng.ResNet50Engine(stripped, tier=tier, device="cpu")(x),
                           teng.ResNet50Engine(params, tier=tier, device="cpu")(x))


def test_engines_refuse_mesh_and_unknown_tiers(tmp_path):
    """An unknown tier and a mesh that is not a parallel.Mesh are refused; a
    mesh (here a one-rank world in this process) serves what one device
    serves, eagerly (tests/test_torch_parallel.py holds larger meshes)."""
    blocks = [init_bottleneck_params(2, c_io=64, c_mid=16)]
    with pytest.raises(ValueError, match="tier"):
        teng.BottleneckEngine(blocks, device="cpu", tier="fp8")
    with pytest.raises(TypeError, match="Mesh"):
        teng.BottleneckEngine(blocks, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        teng.BackboneEngine([], device="cpu", mesh=object())
    x = np.random.default_rng(3).standard_normal((2, 14, 14, 64)).astype(np.float32)
    with one_rank_world(tmp_path):
        mesh = make_mesh(1, 1, device="cpu")
        engine = teng.BottleneckEngine(blocks, device="cpu", mesh=mesh)
        assert torch.equal(engine(x), teng.BottleneckEngine(blocks, device="cpu")(x))
        assert engine.mesh is mesh and engine.replays == 0
