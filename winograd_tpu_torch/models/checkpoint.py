"""Checkpoints and the deployment artifacts of trained weights.

A copy of winograd_tpu/models/checkpoint.py on numpy and the port's own
transforms. The npz formats are the JAX package's, so a file either package
writes loads in the other:

* save_params / load_params: a flat dict of arrays (and an optional
  "extra" dict), keys "params/<name>" and "extra/<name>";
* save_model / load_model: a nested tree of dicts, lists and None leaves,
  its structure stored as JSON in the array "__structure__", each array
  under its path ("p/stages/0/blocks/1/w_reduce").

Both write to "<path>.tmp" and rename, so a crash never leaves a half
written file. Leaves may be numpy arrays or tensors (saved as numpy).

prepare_resnet50_serving and prepare_basicnet_serving are the offline step
of the training -> serving pipeline: from trained parameters (raw OIHW
filters and folded BN, models/train.py::trainable_*_params's set) they
derive every layout the kernels read, as numpy arrays in the JAX package's
tree (models/convert.py::params_from_jax and ::basicnet_params_from_jax
turn it into the port's tensors). export_artifacts writes a trained
bottleneck block as the reference's raw float32 blobs.

The JAX package's orbax backend (save_model_orbax, load_model_orbax) is not
ported (ROADMAP.md A4).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels.basic_stage import stack_basic_stage_params
from winograd_tpu_torch.kernels.direct import direct_filter
from winograd_tpu_torch.kernels.transition import fuse_transition_weights
from winograd_tpu_torch.models.basic import fused_stage_eligible
from winograd_tpu_torch.models.convert import stem_filter, stem_filter_s2d
from winograd_tpu_torch.utils.io import save_parameter


def _np(v) -> np.ndarray:
    """A leaf as a numpy array: tensors leave the device first."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_params(path: str, params: Dict, extra: Optional[Dict] = None) -> None:
    """Atomically save a flat dict-of-arrays checkpoint."""
    arrays = {f"params/{k}": _np(v) for k, v in params.items()}
    if extra:
        arrays.update({f"extra/{k}": _np(v) for k, v in extra.items()})
    _savez(path, arrays)


def load_params(path: str) -> Tuple[Dict, Dict]:
    """Load (params, extra) saved by save_params, as numpy arrays."""
    params, extra = {}, {}
    with np.load(path) as z:
        for k in z.files:
            group, name = k.split("/", 1)
            (params if group == "params" else extra)[name] = z[k]
    return params, extra


def save_model(path: str, tree, extra: Optional[Dict] = None) -> None:
    """Atomically save a nested parameter tree (dicts, lists and None
    leaves: the classifiers' structure). The structure is stored as JSON
    with leaf placeholders; the arrays go in the same npz."""
    arrays = {}

    def enc(node, pfx):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: enc(v, f"{pfx}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [enc(v, f"{pfx}/{i}") for i, v in enumerate(node)]
        arrays[pfx] = _np(node)
        return {"__leaf__": pfx}

    structure = {"tree": enc(tree, "p"), "extra": enc(extra or {}, "e")}
    arrays["__structure__"] = np.frombuffer(json.dumps(structure).encode(), np.uint8).copy()
    _savez(path, arrays)


def load_model(path: str) -> Tuple[object, Dict]:
    """Load (tree, extra) saved by save_model, leaves as numpy arrays."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    structure = json.loads(bytes(arrays.pop("__structure__")).decode())

    def dec(node):
        if node is None:
            return None
        if isinstance(node, dict):
            if "__leaf__" in node:
                return arrays[node["__leaf__"]]
            return {k: dec(v) for k, v in node.items()}
        return [dec(v) for v in node]

    return dec(structure["tree"]), dec(structure["extra"])


def _with_stem_layouts(stem: Dict) -> Dict:
    out = dict(stem)
    w7 = _np(stem["w7_stem"])
    out["w49_stem"] = stem_filter(w7)
    out["w192_stem"] = stem_filter_s2d(w7)
    return out


def prepare_resnet50_serving(train_params: Dict) -> Dict:
    """Trained ResNet-50 parameters (raw filters, folded BN) -> the serving
    tree, numpy arrays: the stem's im2col and space-to-depth layouts
    (w49_stem, w192_stem), each block's direct and F(2,3) layouts (w9_mid,
    u2_mid) and each transition's fused expand+projection weights (wep,
    bep)."""

    def with_mid(d):
        out = dict(d)
        w_mid = _np(d["w_mid"])
        out["w9_mid"] = direct_filter(w_mid)
        out["u2_mid"] = transforms.transform_filter(w_mid, m=2)
        return out

    def with_fused(d):
        out = with_mid(d)
        wep, bep = fuse_transition_weights({k: torch.as_tensor(_np(v)) for k, v in d.items()})
        out["wep"], out["bep"] = wep.numpy(), bep.numpy()
        return out

    return {
        "stem": _with_stem_layouts(train_params["stem"]),
        "proj": with_mid(train_params["proj"]),
        "stages": [
            {
                "transition": None if st.get("transition") is None
                else with_fused(st["transition"]),
                "blocks": [with_mid(b) for b in st["blocks"]],
            }
            for st in train_params["stages"]
        ],
        "head": dict(train_params["head"]),
    }


def prepare_basicnet_serving(train_params: Dict) -> Dict:
    """Trained ResNet-18/34 parameters (raw OIHW filters, folded BN) -> the
    serving tree, numpy arrays: the stem's layouts, each stride-1 3x3's
    direct and F(2,3) layouts (w9_*, u2_*), each entry block's strided
    direct layout (w9_a only), and the stacked "fused" artifact of every
    stage whose identity blocks qualify (models/basic.py::
    fused_stage_eligible)."""

    def with_layouts(d, winograd=("a", "b")):
        out = dict(d)
        for leg in ("a", "b"):
            w = _np(d[f"w_{leg}"])
            out[f"w9_{leg}"] = direct_filter(w)
            if leg in winograd:
                out[f"u2_{leg}"] = transforms.transform_filter(w, m=2)
        return out

    stages = []
    for st in train_params["stages"]:
        out = {
            # The entry's first conv is strided: direct layout only.
            "entry": None if st.get("entry") is None else with_layouts(st["entry"], ("b",)),
            "blocks": [with_layouts(b) for b in st["blocks"]],
        }
        if fused_stage_eligible(out["blocks"]):
            out["fused"] = {k: v.float().numpy()
                            for k, v in stack_basic_stage_params(out["blocks"]).items()}
        stages.append(out)
    return {"stem": _with_stem_layouts(train_params["stem"]), "stages": stages,
            "head": dict(train_params["head"])}


def export_artifacts(params: Dict, outdir: str, m: int = 4) -> None:
    """Write a trained bottleneck block as reference-format blobs: the raw
    and the Winograd-transformed 3x3 filter ([a^2][Cin][Cout], F(m,3)), the
    1x1 weights and the folded-BN scale and bias blobs."""
    os.makedirs(outdir, exist_ok=True)
    w_mid = _np(params["w_mid"])
    cmid = w_mid.shape[0]
    cio = _np(params["w_reduce"]).shape[0]
    save_parameter(f"{outdir}/weight_NCHW_{cmid}_{cmid}.bin", w_mid)
    save_parameter(f"{outdir}/weight_winograd_{cmid}_{cmid}.bin",
                   transforms.transform_filter(w_mid, m=m))
    save_parameter(f"{outdir}/weight_one_{cio}_{cmid}.bin", _np(params["w_reduce"]))
    save_parameter(f"{outdir}/weight_one_{cmid}_{cio}.bin", _np(params["w_expand"]))
    for name, key in [
        (f"bnScale_winograd_{cmid}", "s_mid"),
        (f"bnBias_winograd_{cmid}", "b_mid"),
        (f"bnScale_myKernel_one_{cmid}", "s_reduce"),
        (f"bnBias_myKernel_one_{cmid}", "b_reduce"),
        (f"bnScale_myKernel_one_{cio}", "s_expand"),
        (f"bnBias_myKernel_one_{cio}", "b_expand"),
    ]:
        save_parameter(f"{outdir}/{name}.bin", _np(params[key]))
