"""Serving layer: the ResNet classifiers with their weights resident on a device.

Port of winograd_tpu/engine.py::ResNet50Engine and ::ResNetBasicEngine
(ResNet-18/34), each at the f32, bf16w and int8 tiers, on one device. The
mesh partitions are not ported yet, nor the engines' from_torch and
from_checkpoint constructors.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.models.basic import (
    basicnet_forward,
    basicnet_forward_int8,
    cast_basicnet_bf16w,
    quantize_basicnet,
)
from winograd_tpu_torch.models.convert import params_to
from winograd_tpu_torch.models.resnet50 import (
    cast_bf16w,
    quantize_resnet50,
    resnet50_forward,
    resnet50_forward_int8,
)

TIERS = ("f32", "bf16w", "int8")


class _ClassifierEngine:
    """A classifier's weights resident on one device, served at one tier. A
    subclass names, per tier, the forward and the conversion of the f32
    parameters into that tier's (none at f32)."""

    _forwards: Dict[str, Callable] = {}
    _convert: Dict[str, Callable] = {}

    def __init__(self, params: Dict, tier: str = "f32", device="cuda",
                 mesh=None, partition: str = "data"):
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; choose from {TIERS}")
        if mesh is not None or partition != "data":
            raise NotImplementedError(
                "mesh and partition are not ported yet (ROADMAP.md, queue A "
                "item 10: parallelism); the engine serves one device"
            )
        self.tier = tier
        self.device = _build.require_device(device)
        if tier in self._convert:
            params = self._convert[tier](params)
        self._params = params_to(params, self.device, torch.float32)
        self._forward = self._forwards[tier]

    def __call__(self, x) -> torch.Tensor:
        """x: (224, 224, 3) or (N, 224, 224, 3) image(s), array or tensor;
        returns (num_classes,) / (N, num_classes) logits on the engine's
        device. A single image runs as N=1."""
        with torch.inference_mode():
            return self._forward(x, self._params, self.device)

    def classify(self, x) -> torch.Tensor:
        """Argmax class id(s) for image(s) x."""
        return torch.argmax(self(x), dim=-1)


class ResNet50Engine(_ClassifierEngine):
    """Serves the complete ResNet-50 classifier (224x224x3 image in, 1000
    logits out) through the port's kernels.

    params: the port's f32 parameter dicts (models/resnet50.py::
    init_resnet50_params, or models/convert.py::params_from_jax); they are
    copied to `device` once. tier "f32" serves them as they are; "bf16w"
    casts them once here (models/convert.py::cast_bf16w: bfloat16 weights,
    f32 BN) and serves resnet50_forward(precision="bf16w"); "int8"
    quantizes them once here (models/resnet50.py::quantize_resnet50) and
    serves resnet50_forward_int8. device defaults to "cuda" and must exist;
    the CPU runs the kernels' plain versions and only when asked for."""

    _forwards = {"f32": resnet50_forward,
                 "bf16w": functools.partial(resnet50_forward, precision="bf16w"),
                 "int8": resnet50_forward_int8}
    _convert = {"bf16w": cast_bf16w, "int8": quantize_resnet50}


class ResNetBasicEngine(_ClassifierEngine):
    """Serves the basic-block family (ResNet-18/34: 224x224x3 image in, 1000
    logits out) through the port's kernels.

    params: the port's f32 parameters (models/basic.py::basicnet_params,
    or models/convert.py::basicnet_params_from_jax); they are copied to
    `device` once. tier "f32" serves them as they are (basicnet_forward);
    "bf16w" casts them once here (models/convert.py::cast_basicnet_bf16w:
    bfloat16 weights, f32 BN) and serves basicnet_forward(precision=
    "bf16w"); "int8" quantizes them once here (models/basic.py::
    quantize_basicnet) and serves basicnet_forward_int8. device defaults to
    "cuda" and must exist; the CPU runs the kernels' plain versions and only
    when asked for."""

    _forwards = {"f32": basicnet_forward,
                 "bf16w": functools.partial(basicnet_forward, precision="bf16w"),
                 "int8": basicnet_forward_int8}
    _convert = {"bf16w": cast_basicnet_bf16w, "int8": quantize_basicnet}
