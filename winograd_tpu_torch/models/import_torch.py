"""Import torchvision-format ResNet checkpoints into the port's serving stack.

A copy of winograd_tpu/models/import_torch.py. A torchvision ResNet state
dict (resnet18/34 BasicBlock, resnet50/101/152 Bottleneck: ``conv1``/``bn1``
stem, ``layer{1..4}.{i}.conv{1,2,3}``/``bn{1,2,3}`` blocks with
``layer{L}.0.downsample.{0,1}`` projections, ``fc`` head) maps onto the
trainable parameterization: raw OIHW filters, each BatchNorm folded in eval
mode into a per-channel (scale, bias) at eps 1e-5. From there
models/checkpoint.py::prepare_*_serving derives every kernel layout, and
engine.py's from_torch serves it. torchvision's ResNet is v1.5 (stride 2 on
each stage entry's 3x3, a stride-2 1x1 projection with BN and no ReLU), the
structure of the port's transition kernel. State dicts of numpy arrays or
tensors both convert; torchvision itself is not needed
(build_torch_reference_resnet builds a module with its names).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from winograd_tpu_torch.models.checkpoint import (
    prepare_basicnet_serving,
    prepare_resnet50_serving,
)

BN_EPS = 1e-5  # torch.nn.BatchNorm2d default


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        # .float() first: numpy has no bfloat16/half, and bf16-saved
        # checkpoints are common for modern training runs.
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _fold_bn(sd: Dict, prefix: str, eps: float = BN_EPS):
    """Fold an eval-mode BatchNorm into post-conv (scale, bias):
    y = gamma * (x - mean) / sqrt(var + eps) + beta = scale * x + bias."""
    gamma, beta = _np(sd[f"{prefix}.weight"]), _np(sd[f"{prefix}.bias"])
    mean = _np(sd[f"{prefix}.running_mean"])
    var = _np(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def _conv1x1(sd: Dict, key: str) -> np.ndarray:
    """torch 1x1 conv weight (out, in, 1, 1) -> our (in, out) GEMM matrix."""
    w = _np(sd[key])
    if w.ndim != 4 or w.shape[2:] != (1, 1):
        raise ValueError(f"{key}: {w.shape} is not a 1x1 conv weight")
    return np.ascontiguousarray(w[:, :, 0, 0].T)


def _bottleneck(sd: Dict, prefix: str, eps: float) -> Dict[str, np.ndarray]:
    s1, b1 = _fold_bn(sd, f"{prefix}.bn1", eps)
    s2, b2 = _fold_bn(sd, f"{prefix}.bn2", eps)
    s3, b3 = _fold_bn(sd, f"{prefix}.bn3", eps)
    out = dict(
        w_reduce=_conv1x1(sd, f"{prefix}.conv1.weight"),
        s_reduce=s1, b_reduce=b1,
        w_mid=_np(sd[f"{prefix}.conv2.weight"]),  # OIHW, both layouts agree
        s_mid=s2, b_mid=b2,
        w_expand=_conv1x1(sd, f"{prefix}.conv3.weight"),
        s_expand=s3, b_expand=b3,
    )
    if f"{prefix}.downsample.0.weight" in sd:
        sp, bp = _fold_bn(sd, f"{prefix}.downsample.1", eps)
        out.update(
            w_proj=_conv1x1(sd, f"{prefix}.downsample.0.weight"),
            s_proj=sp, b_proj=bp,
        )
    return out


def resnet_train_params_from_torch(sd: Dict, eps: float = BN_EPS) -> Dict:
    """torchvision ResNet state_dict -> the mode-19 TRAINABLE params
    structure ({"stem", "proj", "stages", "head"}; raw filters, folded BN).
    Depth is inferred from the state_dict (any of resnet50/101/152 — or any
    bottleneck ResNet with the torchvision naming). Feed the result to
    models/checkpoint.py::prepare_resnet50_serving for the fused-kernel
    serving layouts, or serve directly via ResNet50Engine.from_torch."""
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    if "layer1.0.conv1.weight" in sd and "layer1.0.conv3.weight" not in sd:
        raise ValueError(
            "BasicBlock checkpoint (ResNet-18/34): use "
            "basicnet_train_params_from_torch / ResNetBasicEngine.from_torch"
        )
    s_stem, b_stem = _fold_bn(sd, "bn1", eps)
    stem = {"w7_stem": _np(sd["conv1.weight"]), "s_stem": s_stem, "b_stem": b_stem}

    stages = []
    proj = None
    for layer in range(1, 5):
        if f"layer{layer}.0.conv1.weight" not in sd:
            break
        blocks = []
        i = 0
        while f"layer{layer}.{i}.conv1.weight" in sd:
            blocks.append(_bottleneck(sd, f"layer{layer}.{i}", eps))
            i += 1
        entry = blocks.pop(0)
        if "w_proj" not in entry:
            raise ValueError(f"layer{layer}.0 has no downsample projection — not a "
                             "torchvision bottleneck ResNet state_dict")
        if layer == 1:
            # conv2_x's entry projects at stride 1; it is the model-level
            # "proj" param, not part of the stage list.
            proj = entry
            stages.append({"transition": None, "blocks": blocks})
        else:
            stages.append({"transition": entry, "blocks": blocks})
    if proj is None:
        raise ValueError("state_dict has no layer1 — not a ResNet")

    return {
        "stem": stem,
        "proj": proj,
        "stages": stages,
        "head": {
            "w_fc": np.ascontiguousarray(_np(sd["fc.weight"]).T),
            "b_fc": _np(sd["fc.bias"]),
        },
    }


def _basic_block_import(sd: Dict, prefix: str, eps: float) -> Dict[str, np.ndarray]:
    s1, b1 = _fold_bn(sd, f"{prefix}.bn1", eps)
    s2, b2 = _fold_bn(sd, f"{prefix}.bn2", eps)
    out = dict(
        w_a=_np(sd[f"{prefix}.conv1.weight"]),  # OIHW
        s_a=s1, b_a=b1,
        w_b=_np(sd[f"{prefix}.conv2.weight"]),
        s_b=s2, b_b=b2,
    )
    if f"{prefix}.downsample.0.weight" in sd:
        sp, bp = _fold_bn(sd, f"{prefix}.downsample.1", eps)
        out.update(
            w_proj=_conv1x1(sd, f"{prefix}.downsample.0.weight"),
            s_proj=sp, b_proj=bp,
        )
    return out


def basicnet_train_params_from_torch(sd: Dict, eps: float = BN_EPS) -> Dict:
    """torchvision ResNet-18/34 (BasicBlock) state_dict -> the basic
    family's TRAINABLE params structure ({"stem", "stages", "head"}; raw
    OIHW filters, folded BN — models/basic.py::basicnet_forward_train's
    parameterization). Depth is inferred. Feed the result to
    models/checkpoint.py::prepare_basicnet_serving for the fused-kernel
    layouts, or serve directly via ResNetBasicEngine.from_torch."""
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    if "layer1.0.conv3.weight" in sd:
        raise ValueError(
            "Bottleneck checkpoint (ResNet-50/101/152): use "
            "resnet_train_params_from_torch / ResNet50Engine.from_torch"
        )
    s_stem, b_stem = _fold_bn(sd, "bn1", eps)
    stem = {"w7_stem": _np(sd["conv1.weight"]), "s_stem": s_stem, "b_stem": b_stem}

    stages = []
    for layer in range(1, 5):
        if f"layer{layer}.0.conv1.weight" not in sd:
            break
        blocks = []
        i = 0
        while f"layer{layer}.{i}.conv1.weight" in sd:
            blocks.append(_basic_block_import(sd, f"layer{layer}.{i}", eps))
            i += 1
        entry = None
        if "w_proj" in blocks[0]:
            entry = blocks.pop(0)
        else:
            if layer != 1:
                raise ValueError(f"layer{layer}.0 has no downsample projection — not a "
                                 "torchvision BasicBlock ResNet state_dict")
        stages.append({"entry": entry, "blocks": blocks})
    if not stages:
        raise ValueError("state_dict has no layer1 — not a ResNet")

    return {
        "stem": stem,
        "stages": stages,
        "head": {
            "w_fc": np.ascontiguousarray(_np(sd["fc.weight"]).T),
            "b_fc": _np(sd["fc.bias"]),
        },
    }


def basicnet_serving_params_from_torch(sd: Dict, eps: float = BN_EPS) -> Dict:
    """torchvision ResNet-18/34 state_dict -> ready-to-serve params (all
    fused-kernel layouts derived offline). ResNetBasicEngine serves it."""
    return prepare_basicnet_serving(basicnet_train_params_from_torch(sd, eps))


def resnet_serving_params_from_torch(sd: Dict, eps: float = BN_EPS) -> Dict:
    """torchvision state_dict -> ready-to-serve params (all fused-kernel
    layouts derived offline). ResNet50Engine(params, tier=...) serves it."""
    return prepare_resnet50_serving(resnet_train_params_from_torch(sd, eps))


def resnet_family(sd: Dict) -> str:
    """Classify a torchvision ResNet state_dict by block family:
    "bottleneck" (50/101/152 — layer1.0 has a conv3) or "basic" (18/34).
    Raises on anything that isn't a torchvision-format ResNet."""
    if "layer1.0.conv3.weight" in sd:
        return "bottleneck"
    if "layer1.0.conv1.weight" in sd:
        return "basic"
    raise ValueError(
        "state_dict has no layer1.0.conv1 — not a torchvision-format ResNet"
    )


def load_torch_checkpoint(path: str) -> Dict:
    """Load a .pt/.pth checkpoint file (torch.load, weights only). Accepts either a
    bare state_dict or the common {"state_dict": ...} wrapping; strips
    DataParallel's "module." prefix."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k.removeprefix("module."): v for k, v in sd.items()}


def build_torch_reference_resnet(
    layers, stem_c: int = 16, planes=(4, 8, 16, 16), classes: int = 16,
    seed=None, block: str = "bottleneck",
):
    """Build a torchvision-naming-compatible ResNet in torch
    (torchvision itself is NOT needed). Used by the test suite and
    examples as an INDEPENDENT cross-framework reference: its eval-mode
    forward runs torch's own conv backend, so agreement with the imported
    fused serving path validates the weight mapping end to end. With seed
    set, weights AND BatchNorm running stats are randomized (a non-trivial
    BN fold) and the model is returned in eval mode. block="basic" builds
    the BasicBlock family (ResNet-18/34 structure: layer1 has no
    downsample when stem_c == planes[0], matching torchvision)."""
    import torch.nn as nn

    class _Bottleneck(nn.Module):
        expansion = 4

        def __init__(self, inplanes, p, stride=1, downsample=None):
            super().__init__()
            self.conv1 = nn.Conv2d(inplanes, p, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(p)
            self.conv2 = nn.Conv2d(p, p, 3, stride=stride, padding=1, bias=False)
            self.bn2 = nn.BatchNorm2d(p)
            self.conv3 = nn.Conv2d(p, p * 4, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(p * 4)
            self.relu = nn.ReLU(inplace=True)
            self.downsample = downsample

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            h = self.relu(self.bn1(self.conv1(x)))
            h = self.relu(self.bn2(self.conv2(h)))
            h = self.bn3(self.conv3(h))
            return self.relu(h + idt)

    class _BasicBlock(nn.Module):
        expansion = 1

        def __init__(self, inplanes, p, stride=1, downsample=None):
            super().__init__()
            self.conv1 = nn.Conv2d(inplanes, p, 3, stride=stride, padding=1, bias=False)
            self.bn1 = nn.BatchNorm2d(p)
            self.conv2 = nn.Conv2d(p, p, 3, padding=1, bias=False)
            self.bn2 = nn.BatchNorm2d(p)
            self.relu = nn.ReLU(inplace=True)
            self.downsample = downsample

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            h = self.relu(self.bn1(self.conv1(x)))
            h = self.bn2(self.conv2(h))
            return self.relu(h + idt)

    blk = {"bottleneck": _Bottleneck, "basic": _BasicBlock}[block]

    class _ResNet(nn.Module):
        """torchvision.models.ResNet's structure and parameter names."""

        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, stem_c, 7, stride=2, padding=3, bias=False)
            self.bn1 = nn.BatchNorm2d(stem_c)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
            inplanes = stem_c
            for li, (p, n) in enumerate(zip(planes, layers), start=1):
                stride = 1 if li == 1 else 2
                out_c = p * blk.expansion
                # torchvision's bottleneck stage entries ALWAYS project
                # (expansion 4 changes the width); basic stages only when
                # the shape actually changes.
                if block == "bottleneck" or stride != 1 or inplanes != out_c:
                    down = nn.Sequential(
                        nn.Conv2d(inplanes, out_c, 1, stride=stride, bias=False),
                        nn.BatchNorm2d(out_c),
                    )
                else:
                    down = None
                mods = [blk(inplanes, p, stride, down)]
                inplanes = out_c
                mods += [blk(inplanes, p) for _ in range(n - 1)]
                setattr(self, f"layer{li}", nn.Sequential(*mods))
            self.avgpool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(inplanes, classes)

        def forward(self, x):
            h = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            for li in range(1, len(layers) + 1):
                h = getattr(self, f"layer{li}")(h)
            return self.fc(torch.flatten(self.avgpool(h), 1))

    if seed is None:
        return _ResNet()
    torch.manual_seed(seed)
    model = _ResNet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.normal_(1.0, 0.2)
                m.bias.normal_(0, 0.2)
    return model.eval()
