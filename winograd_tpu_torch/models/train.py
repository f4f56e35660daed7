"""The trainable parameter sets of the classifiers.

From winograd_tpu/models/train.py: trainable_resnet50_params and
trainable_basicnet_params, the dict strips that define what a trained
checkpoint holds (raw OIHW filters and folded BN, without the serving
layouts that models/checkpoint.py::prepare_*_serving derives). Leaves pass
through as they are (numpy arrays or tensors). The training steps are not
ported yet (ROADMAP.md A7).
"""

from __future__ import annotations

from typing import Dict

_RESNET50_SERVING_KEYS = ("u_mid", "u2_mid", "w9_mid", "w49_stem", "w192_stem", "wep", "bep")
_BASICNET_SERVING_KEYS = ("u2_a", "u2_b", "w9_a", "w9_b", "w49_stem", "w192_stem")


def _keep(d: Dict, drop) -> Dict:
    return {k: v for k, v in d.items() if k not in drop}


def trainable_resnet50_params(full: Dict) -> Dict:
    """A full ResNet-50 tree in the JAX package's structure (models/
    resnet50.py::init_resnet50_arrays or ::resnet50_arrays) without its
    serving-only layouts: the set prepare_resnet50_serving takes."""
    drop = _RESNET50_SERVING_KEYS
    return {
        "stem": _keep(full["stem"], drop),
        "proj": _keep(full["proj"], drop),
        "stages": [
            {"transition": None if st.get("transition") is None
             else _keep(st["transition"], drop),
             "blocks": [_keep(b, drop) for b in st["blocks"]]}
            for st in full["stages"]
        ],
        "head": _keep(full["head"], drop),
    }


def trainable_basicnet_params(full: Dict) -> Dict:
    """A full basic-family tree in the JAX package's structure (models/
    basic.py::basicnet_arrays) without its serving-only layouts and fused
    stacks: the set prepare_basicnet_serving takes."""
    drop = _BASICNET_SERVING_KEYS
    return {
        "stem": _keep(full["stem"], drop),
        "stages": [
            {"entry": None if st.get("entry") is None else _keep(st["entry"], drop),
             "blocks": [_keep(b, drop) for b in st["blocks"]]}
            for st in full["stages"]
        ],
        "head": _keep(full["head"], drop),
    }
