"""The port's checkpoints against the JAX package's, on the CPU.

* A file written by either package's save_params / save_model loads in the
  other to equal arrays, extra included.
* trainable_*_params and prepare_*_serving equal the JAX package's leaf by
  leaf on the same numpy tree: to the bit, the fused transition weights
  (the JAX fold runs in XLA) within 1e-6.
* export_artifacts writes the same files as the JAX package's, byte for
  byte.
* from_checkpoint: ResNet50Engine and ResNetBasicEngine built from a
  save_model checkpoint of the trainable set give logits within
  1e-4 * max(1, max|ref|) of the forward on the full parameters.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from winograd_tpu.config import BasicNetConfig as JaxBasicNetConfig
from winograd_tpu.config import ResNet50Config as JaxResNet50Config
from winograd_tpu.models import checkpoint as jck
from winograd_tpu.models import init_bottleneck_params
from winograd_tpu.models import train as jtrain
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.engine import ResNet50Engine, ResNetBasicEngine
from winograd_tpu_torch.models import checkpoint as tck
from winograd_tpu_torch.models import train as ttrain
from winograd_tpu_torch.models.basic import basicnet_arrays, basicnet_forward, basicnet_params
from winograd_tpu_torch.models.basic import init_basicnet_arrays
from winograd_tpu_torch.models.convert import params_from_jax
from winograd_tpu_torch.models.resnet50 import init_resnet50_arrays, resnet50_forward


@dataclasses.dataclass(frozen=True)
class _TinyR50(JaxResNet50Config):
    stages = ((16, 8, 8, 1), (32, 8, 4, 1))
    img: int = 32
    stem_c: int = 8
    num_classes: int = 16


@dataclasses.dataclass(frozen=True)
class _TinyBasic(JaxBasicNetConfig):
    stages = ((16, 8, 1), (32, 4, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


@dataclasses.dataclass(frozen=True)
class _FusedBasic(JaxBasicNetConfig):
    """A last stage wide enough for the basic-stage kernel's fused stack."""
    stages = ((16, 8, 1), (512, 4, 3))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_same_tree(ours, theirs, close=()):
    a, b = dict(_leaves(ours)), dict(_leaves(theirs))
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        if v is None or b[k] is None:
            assert v is None and b[k] is None, k
            continue
        v, w = np.asarray(v), np.asarray(b[k])
        assert v.dtype == w.dtype and v.shape == w.shape, k
        if k.rsplit("/", 1)[-1] in close:
            np.testing.assert_allclose(v, w, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v, w, err_msg=k)


def _images(seed, n, img):
    return (np.random.default_rng(seed).random((n, img, img, 3)) - 0.5).astype(np.float32)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape and np.isfinite(out).all()
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


def test_files_load_across_packages(tmp_path):
    params = {k: np.asarray(v) for k, v in init_bottleneck_params(0, c_io=32, c_mid=8).items()}
    extra = {"step": np.asarray(7), "lr": np.asarray(0.1, np.float32)}
    tree = {"a": [params, None], "b": {"w": np.arange(6, dtype=np.int8).reshape(2, 3)}}
    for save, load in ((jck.save_params, tck.load_params), (tck.save_params, jck.load_params)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, params, extra)
        got, got_extra = load(path)
        _assert_same_tree(got, params)
        _assert_same_tree(got_extra, extra)
    for save, load in ((jck.save_model, tck.load_model), (tck.save_model, jck.load_model)):
        path = str(tmp_path / f"{save.__module__}_model.npz")
        save(path, tree, extra)
        got, got_extra = load(path)
        _assert_same_tree(got, tree)
        _assert_same_tree(got_extra, extra)
        assert not os.path.exists(f"{path}.tmp")
    # Tensors save as their numpy arrays.
    tck.save_model(str(tmp_path / "t.npz"), {"w": torch.ones(2, 2)})
    np.testing.assert_array_equal(jck.load_model(str(tmp_path / "t.npz"))[0]["w"], np.ones((2, 2)))


def test_prepare_resnet50_serving_equals_jax():
    full = init_resnet50_arrays(_TinyR50("ck"), seed=11)
    trained = ttrain.trainable_resnet50_params(full)
    _assert_same_tree(trained, jax.tree.map(np.asarray, jtrain.trainable_resnet50_params(full)))
    _assert_same_tree(tck.prepare_resnet50_serving(trained),
                      jax.tree.map(np.asarray, jck.prepare_resnet50_serving(trained)),
                      close=("wep", "bep"))


@pytest.mark.parametrize("cfg_cls", [_TinyBasic, _FusedBasic])
def test_prepare_basicnet_serving_equals_jax(cfg_cls):
    cfg = cfg_cls("ck_basic")
    full = basicnet_arrays(init_basicnet_arrays(cfg, seed=4), cfg)
    trained = ttrain.trainable_basicnet_params(full)
    _assert_same_tree(trained, jax.tree.map(np.asarray, jtrain.trainable_basicnet_params(full)))
    ours = tck.prepare_basicnet_serving(trained)
    _assert_same_tree(ours, jax.tree.map(np.asarray, jck.prepare_basicnet_serving(trained)))
    assert ["fused" in st for st in ours["stages"]] == [False, cfg_cls is _FusedBasic]


def test_export_artifacts_writes_the_jax_files(tmp_path):
    params = {k: np.asarray(v) for k, v in init_bottleneck_params(1, c_io=32, c_mid=16).items()}
    for m in (2, 4):
        jck.export_artifacts(params, str(tmp_path / f"jax{m}"), m=m)
        tck.export_artifacts(params, str(tmp_path / f"port{m}"), m=m)
        names = sorted(os.listdir(tmp_path / f"jax{m}"))
        assert names == sorted(os.listdir(tmp_path / f"port{m}")) and len(names) == 10
        for name in names:
            assert ((tmp_path / f"jax{m}" / name).read_bytes()
                    == (tmp_path / f"port{m}" / name).read_bytes()), name


def test_resnet50_engine_from_checkpoint(tmp_path):
    cfg = _TinyR50("ckpt_r50")
    full = init_resnet50_arrays(cfg, seed=11)
    path = str(tmp_path / "r50.npz")
    tck.save_model(path, ttrain.trainable_resnet50_params(full), extra={"step": np.asarray(7)})
    x = _images(3, 2, cfg.img)
    want = resnet50_forward(x, params_from_jax(full, "cpu"), device="cpu")
    engine = ResNet50Engine.from_checkpoint(path, device="cpu")
    assert _rel(engine(x), want) <= PARITY_ATOL
    assert _rel(ResNet50Engine.from_checkpoint(path, device="cpu", tier="bf16w")(x), want) < 5e-3


def test_basicnet_engine_from_checkpoint(tmp_path):
    cfg = _TinyBasic("ckpt_basic")
    case = init_basicnet_arrays(cfg, seed=6)
    path = str(tmp_path / "basic.npz")
    tck.save_model(path, ttrain.trainable_basicnet_params(basicnet_arrays(case, cfg)))
    x = _images(5, 2, cfg.img)
    want = basicnet_forward(x, basicnet_params(case, cfg, "cpu"), device="cpu")
    assert _rel(ResNetBasicEngine.from_checkpoint(path, device="cpu")(x), want) <= PARITY_ATOL
