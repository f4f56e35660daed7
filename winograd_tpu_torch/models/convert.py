"""Parameters of the JAX package's ResNet-50 as the port's tensors.

params_from_jax takes the parameter tree that winograd_tpu builds
(models/resnet50.py::init_resnet50_params or ::resnet50_params), as numpy
arrays, and returns the port's parameter dicts, so that both packages
compute the same network. Each offline layout the port runs (u2_mid, w9_mid,
w192_stem) is derived here from the raw filter (w_mid, w7_stem) when the
tree has it, in the target dtype, with this package's own transforms. Each
transition also gets its fused expand/projection weights (wep, bep), and
each stage that runs as one stage kernel its blocks' params stacked once
("stacked"), with the per-block tensors as views into the stack, so a
request never stacks and the weights are stored once.

qparams_from_jax takes the JAX package's int8 tree
(models/resnet50.py::quantize_resnet50, as numpy arrays) and returns the
port's int8 parameters (models/resnet50.py::quantize_resnet50 builds the
same from the port's own f32 parameters): int8 weights stay torch.int8,
the bf16 F(2,3) filters torch.bfloat16, and each stage's blocks arrive
stacked once.

cast_bf16w turns the port's f32 ResNet-50 parameters into the bf16w tier's:
every weight bfloat16, every BN scale and bias float32, and each stage that
the bf16w gate fuses stacked once.

cast_basicnet_bf16w does the same for the basic family's f32 parameters.

basicnet_params_from_jax and qbasicnet_params_from_jax do the same for the
basic family (ResNet-18/34, winograd_tpu/models/basic.py::basicnet_params
and ::quantize_basicnet): a stage that carries the stacked "fused" artifact
of the basic-stage kernel stores it once, and its blocks' tensors of the
same keys are views into it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels.basic_stage import stack_basic_stage_params
from winograd_tpu_torch.kernels.direct import direct_filter
from winograd_tpu_torch.kernels.stage import stack_stage_params
from winograd_tpu_torch.kernels.transition import fuse_transition_weights
from winograd_tpu_torch.models.resnet import stage_algo

BN_KEYS = ("s_reduce", "b_reduce", "s_mid", "b_mid", "s_expand", "b_expand")
BLOCK_KEYS = ("w_reduce", "u2_mid", "w9_mid", "w_expand") + BN_KEYS
PROJECTION_KEYS = ("w_reduce", "u2_mid", "w9_mid", "w_expand", "w_proj", "s_proj",
                   "b_proj") + BN_KEYS
STEM_KEYS = ("w192_stem", "s_stem", "b_stem")
TRANSITION_KEYS = ("w_reduce", "w9_mid", "w_expand", "w_proj", "s_proj", "b_proj") + BN_KEYS


def stem_filter_s2d(w7: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(Cout, Cin, 7, 7) OIHW -> (64*Cin, Cout) rows ordered (a, b, u, v, c):
    cell offset (a, b) in 0..3, intra-cell (u, v) in 0..1, channel c; tap
    (r, s) = (2a+u, 2b+v), zero where r or s > 6."""
    cout, cin = w7.shape[0], w7.shape[1]
    wt = np.transpose(np.asarray(w7, dtype), (2, 3, 1, 0))  # (7, 7, cin, cout)
    out = np.zeros((64 * cin, cout), dtype)
    for a in range(4):
        for b in range(4):
            for u in range(2):
                for v in range(2):
                    r, s = 2 * a + u, 2 * b + v
                    if r < 7 and s < 7:
                        i = ((a * 4 + b) * 4 + u * 2 + v) * cin
                        out[i : i + cin] = wt[r, s]
    return out


def _layer(tree: Dict, keys, np_dtype, device, dtype) -> Dict[str, torch.Tensor]:
    arrays = dict(tree)
    if "w_mid" in arrays:
        w_mid = np.asarray(arrays["w_mid"], np_dtype)
        arrays["u2_mid"] = transforms.transform_filter(w_mid, dtype=np_dtype, m=2)
        arrays["w9_mid"] = direct_filter(w_mid)
    return {
        k: torch.as_tensor(np.asarray(arrays[k]), dtype=dtype, device=device).contiguous()
        for k in keys
    }


def _transition(tree: Dict, np_dtype, device, dtype) -> Dict[str, torch.Tensor]:
    layer = _layer(tree, TRANSITION_KEYS, np_dtype, device, dtype)
    layer["wep"], layer["bep"] = fuse_transition_weights(layer)
    return layer


def _block_views(stacked: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Each block's params as views into its stage's stacked params."""
    return [
        {k: stacked[k][i].reshape(-1) if k in BN_KEYS else stacked[k][i] for k in BLOCK_KEYS}
        for i in range(stacked["w_reduce"].shape[0])
    ]


def _stage(tree: Dict, np_dtype, device, dtype) -> Dict:
    blocks = [_layer(b, BLOCK_KEYS, np_dtype, device, dtype) for b in tree["blocks"]]
    stacked = None
    if stage_algo(blocks) == "fused_stage":
        stacked = stack_stage_params(blocks)
        blocks = _block_views(stacked)
    transition = tree.get("transition")
    return {
        "transition": None if transition is None else _transition(transition, np_dtype, device, dtype),
        "blocks": blocks,
        "stacked": stacked,
    }


def _is_weight(key: str) -> bool:
    """A GEMM or filter weight (w_*, w9_*, u2_*, w192_stem, w_fc, the fused
    wep), as opposed to a BN scale or bias (s_*, b_*, bep)."""
    return key.startswith(("w_", "w9_", "u2_", "w192_")) or key == "wep"


def _bf16w_layer(layer: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.to(torch.bfloat16).contiguous() if _is_weight(k) else v
            for k, v in layer.items()}


def cast_bf16w(params: Dict) -> Dict:
    """The port's f32 ResNet-50 parameters -> the bf16w tier's, for
    resnet50_forward(precision="bf16w"): every weight rounded to bfloat16
    (torch's round to nearest even, the JAX package's
    jnp.asarray(w).astype(jnp.bfloat16) to the bit; the transitions' wep
    folded in float32 first, as the JAX kernel folds), BN scales and biases
    float32. Each stage that stage_algo's bf16w gate fuses, conv5_x and
    single-block stages included, gets its blocks stacked once, the blocks'
    tensors as views."""
    stages = []
    for st in params["stages"]:
        blocks = [_bf16w_layer({k: b[k] for k in BLOCK_KEYS}) for b in st["blocks"]]
        stacked = None
        if stage_algo(blocks, "bf16w") == "fused_stage":
            stacked = stack_stage_params(blocks)
            blocks = _block_views(stacked)
        transition = st.get("transition")
        stages.append({
            "transition": None if transition is None else _bf16w_layer(transition),
            "blocks": blocks,
            "stacked": stacked,
        })
    return {"stem": _bf16w_layer(params["stem"]), "proj": _bf16w_layer(params["proj"]),
            "stages": stages, "head": _bf16w_layer(params["head"])}


def cast_basicnet_bf16w(params: Dict) -> Dict:
    """The port's f32 basic-family parameters (ResNet-18/34, models/basic.py::
    basicnet_params) -> the bf16w tier's, for basicnet_forward(precision=
    "bf16w"): every w_*, w9_*, u2_*, w192_stem and w_fc rounded to bfloat16
    (torch's round to nearest even, the JAX package's astype(jnp.bfloat16)
    to the bit), BN scales and biases float32. A stage with the "fused"
    artifact gets it stacked once in bfloat16 (stack_basic_stage_params),
    its blocks' tensors of the stack's keys as views."""
    stages = []
    for st in params["stages"]:
        entry = st.get("entry")
        out = {"entry": None if entry is None else _bf16w_layer(entry),
               "blocks": [_bf16w_layer(b) for b in st["blocks"]]}
        if st.get("fused") is not None:
            out["fused"] = stack_basic_stage_params(out["blocks"])
            out["blocks"] = basic_block_views(out["fused"], out["blocks"])
        stages.append(out)
    return {"stem": _bf16w_layer(params["stem"]), "stages": stages,
            "head": _bf16w_layer(params["head"])}


def stages_from_jax(stages: List[Dict], device="cuda", dtype=torch.float32) -> List[Dict]:
    """The JAX package's resnet50_stages structure (numpy arrays) -> the
    port's stages on `device`."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return [_stage(st, np_dtype, device, dtype) for st in stages]


def _stem(tree: Dict, np_dtype, device, dtype) -> Dict[str, torch.Tensor]:
    stem = dict(tree)
    if "w7_stem" in stem:
        stem["w192_stem"] = stem_filter_s2d(stem["w7_stem"], np_dtype)
    return _layer(stem, STEM_KEYS, np_dtype, device, dtype)


def params_from_jax(tree: Dict, device="cuda", dtype=torch.float32) -> Dict:
    """The JAX parameter tree {"stem", "proj", "stages", "head"} (numpy
    arrays) -> the port's parameters on `device`."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return {
        "stem": _stem(tree["stem"], np_dtype, device, dtype),
        "proj": _layer(tree["proj"], PROJECTION_KEYS, np_dtype, device, dtype),
        "stages": stages_from_jax(tree["stages"], device, dtype),
        "head": _layer(tree["head"], ("w_fc", "b_fc"), np_dtype, device, dtype),
    }


def _tensor(a) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a tensor of its type,
    on a copy."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def qparams_from_jax(qtree: Dict, device="cuda") -> Dict:
    """The JAX int8 tree {"stem", "proj", "stages", "head"} (numpy arrays;
    each stage {"transition", "blocks": stacked int8 params}) -> the port's
    int8 parameters on `device`. The stem keeps its f32 w192 layout."""
    stem = _stem(qtree["stem"], np.float32, "cpu", torch.float32)
    out = {
        "stem": stem,
        "proj": {k: _tensor(v) for k, v in qtree["proj"].items()},
        "stages": [{
            "transition": None if st.get("transition") is None
            else {k: _tensor(v) for k, v in st["transition"].items()},
            "blocks": {k: _tensor(v) for k, v in st["blocks"].items()},
        } for st in qtree["stages"]],
        "head": {k: _tensor(v) for k, v in qtree["head"].items()},
    }
    return params_to(out, device)


def basic_block_views(fused: Dict[str, torch.Tensor], blocks: List[Dict]) -> List[Dict]:
    """Each basic block with its tensors of the fused stack's keys replaced
    by views into the stack (rows (1, C) as (C,))."""
    out = []
    for i, b in enumerate(blocks):
        views = {k: v[i].reshape(-1) if v[i].shape[0] == 1 else v[i] for k, v in fused.items()}
        out.append(dict(b, **views))
    return out


def params_to(params, device=None, dtype=None):
    """The same parameter structure with every tensor moved, and every
    float32/float64 tensor cast to `dtype` (int8 weights and bf16 filters
    keep their type; a tensor already where it belongs stays as it is). A
    stage's blocks become views into its moved "stacked" (bottleneck) or
    "fused" (basic) params again, so the weights stay stored once."""
    if isinstance(params, dict):
        if params.get("stacked") is not None:
            moved = {k: params_to(v, device, dtype) for k, v in params.items() if k != "blocks"}
            return dict(moved, blocks=_block_views(moved["stacked"]))
        if params.get("fused") is not None:
            moved = {k: params_to(v, device, dtype) for k, v in params.items() if k != "blocks"}
            rest = [{k: params_to(v, device, dtype) for k, v in b.items() if k not in moved["fused"]}
                    for b in params["blocks"]]
            return dict(moved, blocks=basic_block_views(moved["fused"], rest))
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    if params is None:
        return None
    cast = dtype if params.dtype in (torch.float32, torch.float64) else None
    return params.to(device=device, dtype=cast).contiguous()


def _arrays(tree, convert) -> Dict:
    return None if tree is None else {k: convert(v) for k, v in tree.items()}


def basicnet_params_from_jax(tree: Dict, device="cuda", dtype=torch.float32) -> Dict:
    """The JAX basic family's parameter tree {"stem", "stages", "head"}
    (models/basic.py::basicnet_params, numpy arrays) -> the port's
    parameters on `device` in `dtype`. A stage with the "fused" artifact
    gets it stacked once from its blocks (stack_basic_stage_params), the
    blocks' tensors of its keys as views."""
    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device).contiguous()

    stages = []
    for st in tree["stages"]:
        out = {"entry": _arrays(st.get("entry"), tensor),
               "blocks": [_arrays(b, tensor) for b in st["blocks"]]}
        if "fused" in st:
            out["fused"] = stack_basic_stage_params(out["blocks"])
            out["blocks"] = basic_block_views(out["fused"], out["blocks"])
        stages.append(out)
    return {"stem": _arrays(tree["stem"], tensor), "stages": stages,
            "head": _arrays(tree["head"], tensor)}


def qbasicnet_params_from_jax(qtree: Dict, device="cuda") -> Dict:
    """The JAX basic family's int8 tree (models/basic.py::quantize_basicnet,
    numpy arrays) -> the port's int8 parameters on `device`: int8 weights
    stay torch.int8, the bf16 F(2,3) filters torch.bfloat16; a stage's
    "fused" stack is stored once and its blocks' tensors of its keys are
    views."""
    stages = []
    for st in qtree["stages"]:
        out = {"entry": _arrays(st.get("entry"), _tensor),
               "blocks": [_arrays(b, _tensor) for b in st["blocks"]]}
        if st.get("fused") is not None:
            out["fused"] = _arrays(st["fused"], _tensor)
        stages.append(out)
    return params_to({"stem": _arrays(qtree["stem"], _tensor), "stages": stages,
                      "head": _arrays(qtree["head"], _tensor)}, device)
