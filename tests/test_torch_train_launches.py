"""The kernels one train step launches, counted on the CPU: every kernel
wrapper that kernels/vjp.py and the projection block call is wrapped by a
counter that then runs the plain version, and one N=1 step (forward,
backward) of ResNet-50 and ResNet-18 runs at each training precision. The
configurations keep full-width ResNet-50's and ResNet-18's route gates (the
224 image and so every map size; conv5_x's io width 2048; the basic net's
512-wide conv5_x) at narrow widths elsewhere, so the counts are the ones
chip_smoke.py pins on the card (EXPECTED_TRAIN_STEP). No CUDA kernel runs."""

import collections
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from winograd_tpu_torch.config import BasicNetConfig, ResNet50Config
from winograd_tpu_torch.bench.cli import train_step
from winograd_tpu_torch.kernels import vjp
from winograd_tpu_torch.models import downsample
from winograd_tpu_torch.models.basic import (
    basicnet_arrays, basicnet_forward_train, init_basicnet_arrays,
)
from winograd_tpu_torch.models.resnet50 import init_resnet50_arrays, resnet50_forward_train
from winograd_tpu_torch.models.train import trainable_basicnet_params, trainable_resnet50_params
from winograd_tpu_torch.utils.tree import tree_map

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass(frozen=True)
class _NarrowR50(ResNet50Config):
    stages = ((32, 8, 56, 2), (64, 16, 28, 3), (128, 16, 14, 5), (2048, 8, 7, 2))
    stem_c: int = 8
    num_classes: int = 10


@dataclasses.dataclass(frozen=True)
class _NarrowR18(BasicNetConfig):
    stages = ((8, 56, 2), (16, 28, 2), (32, 14, 2), (512, 7, 2))
    stem_c: int = 8
    num_classes: int = 10


def _bf16(t) -> bool:
    if isinstance(t, dict):
        return any(_bf16(v) for v in t.values())
    return isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16


def _count(monkeypatch, taken):
    """Wrap each kernel wrapper: count it under its kernel's name
    ("<name>_bf16w" on bfloat16 weights), then run it."""
    def counted(name, fn):
        def wrapper(x, weights, *args, **kwargs):
            taken[f"{name}_bf16w" if _bf16(weights) else name] += 1
            return fn(x, weights, *args, **kwargs)
        return wrapper

    for mod, attr, name in ((vjp, "conv1x1_bn", "pointwise"),
                            (vjp, "conv3x3_bn_winograd", "winograd"),
                            (vjp, "conv3x3_bn_direct", "direct"), (vjp, "stem_fused", "stem"),
                            (vjp, "bottleneck_block_fused", "stage"),
                            (vjp, "resnet_stage_fused", "stage"),
                            (vjp, "transition_block_fused", "transition"),
                            (vjp, "basic_stage_fused", "basic_stage"),
                            (downsample, "conv1x1_bn", "pointwise"),
                            (downsample, "conv3x3_bn_winograd", "winograd")):
        monkeypatch.setattr(mod, attr, counted(name, getattr(mod, attr)))


def _trainee(model):
    if model == "resnet50":
        cfg = _NarrowR50("narrow_r50")
        return cfg, resnet50_forward_train, trainable_resnet50_params(init_resnet50_arrays(cfg))
    cfg = _NarrowR18("narrow_r18")
    return cfg, basicnet_forward_train, trainable_basicnet_params(
        basicnet_arrays(init_basicnet_arrays(cfg), cfg))


@pytest.mark.parametrize("precision", [None, "bf16w"])
@pytest.mark.parametrize("model", ["resnet50", "resnet18"])
def test_train_step_launches_match_chip_smoke(monkeypatch, model, precision):
    cfg, forward, tree = _trainee(model)
    params = tree_map(lambda a: torch.tensor(np.asarray(a)), tree)
    x = torch.tensor(np.random.default_rng(0).random((1, cfg.img, cfg.img, 3), np.float32) - 0.5)
    taken = collections.Counter()
    _count(monkeypatch, taken)
    scalar, grads = train_step(lambda x_, p: forward(x_, p, precision, "cpu"), params)(x)
    assert torch.isfinite(scalar) and all(torch.isfinite(g).all() for g in grads)
    assert dict(taken) == _chip_smoke().EXPECTED_TRAIN_STEP[(model, precision)]
