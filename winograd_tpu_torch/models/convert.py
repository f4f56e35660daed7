"""Parameters of the JAX package's ResNet-50 as the port's tensors.

params_from_jax takes the parameter tree that winograd_tpu builds
(models/resnet50.py::init_resnet50_params or ::resnet50_params), as numpy
arrays, and returns the port's parameter dicts, so that both packages
compute the same network. Each offline layout the port runs (u2_mid, w9_mid,
w192_stem) is derived here from the raw filter (w_mid, w7_stem) when the
tree has it, in the target dtype, with this package's own transforms.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels.direct import direct_filter

BN_KEYS = ("s_reduce", "b_reduce", "s_mid", "b_mid", "s_expand", "b_expand")
BLOCK_KEYS = ("w_reduce", "u2_mid", "w9_mid", "w_expand") + BN_KEYS
PROJECTION_KEYS = ("w_reduce", "u2_mid", "w_expand", "w_proj", "s_proj", "b_proj") + BN_KEYS
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


def params_from_jax(tree: Dict, device="cuda", dtype=torch.float32) -> Dict:
    """The JAX parameter tree {"stem", "proj", "stages", "head"} (numpy
    arrays) -> the port's parameters on `device`."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    stem = dict(tree["stem"])
    if "w7_stem" in stem:
        stem["w192_stem"] = stem_filter_s2d(stem["w7_stem"], np_dtype)
    return {
        "stem": _layer(stem, ("w192_stem", "s_stem", "b_stem"), np_dtype, device, dtype),
        "proj": _layer(tree["proj"], PROJECTION_KEYS, np_dtype, device, dtype),
        "stages": [
            {
                "transition": None
                if st.get("transition") is None
                else _layer(st["transition"], TRANSITION_KEYS, np_dtype, device, dtype),
                "blocks": [
                    _layer(b, BLOCK_KEYS, np_dtype, device, dtype) for b in st["blocks"]
                ],
            }
            for st in tree["stages"]
        ],
        "head": _layer(tree["head"], ("w_fc", "b_fc"), np_dtype, device, dtype),
    }


def params_to(params, device=None, dtype=None):
    """The same parameter structure with every tensor moved/cast."""
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    if params is None:
        return None
    return params.to(device=device, dtype=dtype).contiguous()
