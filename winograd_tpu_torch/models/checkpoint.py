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

save_checkpoint_dir / load_checkpoint_dir are the twin of the JAX
package's orbax backend (save_model_orbax, load_model_orbax) with no orbax:
a checkpoint directory of one raw file per array and an index of the tree
(index.json), written on a background thread into a temporary directory
beside the target and renamed into place once it is whole.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

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


INDEX = "index.json"


def _leaf_bytes(v) -> Tuple[np.ndarray, str]:
    """A leaf's host copy and its dtype's name: tensors leave the device,
    bfloat16 travels as its 16-bit pattern."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), "bfloat16"
        return t.numpy().copy(), str(t.dtype).removeprefix("torch.")
    a = np.array(v)
    return a, a.dtype.name


def _write_leaf(directory: str, name: str, data: np.ndarray) -> None:
    data.tofile(os.path.join(directory, name))


class CheckpointWrite:
    """A save_checkpoint_dir in progress on its background thread."""

    def __init__(self, path: str, write) -> None:
        self.path = path
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(write,),
                                        name=f"checkpoint {path}", daemon=True)
        self._thread.start()

    def _run(self, write) -> None:
        try:
            write()
        except BaseException as e:  # noqa: BLE001 - handed to wait_until_finished
            self._error = e

    def wait_until_finished(self) -> None:
        """Block until the directory is in place; re-raise the writer's
        exception if it failed (the target is then absent)."""
        self._thread.join()
        if self._error is not None:
            raise self._error


def save_checkpoint_dir(path: str, tree, *, wait: bool = True) -> Optional[CheckpointWrite]:
    """Save a nested parameter tree (dicts, lists and None leaves; leaves
    numpy arrays, tensors on any device or scalars) as a checkpoint
    directory: one raw file per array and INDEX, the tree with each leaf's
    file, dtype and shape. The twin of the JAX package's
    models/checkpoint.py::save_model_orbax (orbax's StandardCheckpointer),
    with no orbax.

    The leaves are copied to the host here, so the caller may go on
    changing them; the files are written on a background thread into a
    temporary directory beside `path`, which is renamed to `path` when it
    is whole (a crash never leaves a partial checkpoint at `path`). wait
    True blocks until then and returns None; wait False returns the
    CheckpointWrite, whose wait_until_finished() blocks and re-raises the
    writer's exception. `path` must not exist."""
    path = os.path.abspath(os.fspath(path))
    if os.path.exists(path):
        raise FileExistsError(f"checkpoint directory {path} exists")
    leaves: List[Tuple[str, np.ndarray]] = []

    def enc(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: enc(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [enc(v) for v in node]
        data, dtype = _leaf_bytes(node)
        name = f"{len(leaves)}.bin"
        leaves.append((name, data))
        return {"__leaf__": name, "dtype": dtype, "shape": list(data.shape)}

    index = json.dumps({"tree": enc(tree)})
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)

    def write() -> None:
        tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.tmp-", dir=parent)
        try:
            for name, data in leaves:
                _write_leaf(tmp, name, data)
            with open(os.path.join(tmp, INDEX), "w") as f:
                f.write(index)
            os.rename(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    handle = CheckpointWrite(path, write)
    if wait:
        handle.wait_until_finished()
        return None
    return handle


def _leaf_spec(v) -> Tuple[Tuple[int, ...], str]:
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), str(v.dtype).removeprefix("torch.")
    a = np.asarray(v)
    return a.shape, a.dtype.name


def load_checkpoint_dir(path: str, like=None, device="cuda", mesh=None):
    """Restore a save_checkpoint_dir directory as a tree of tensors on
    `device` (CUDA by default, which must exist; the CPU on request). With
    `like` (a tree of the same structure: arrays or tensors), the structure,
    every leaf's shape and its dtype must match, else ValueError. The twin
    of the JAX package's models/checkpoint.py::load_model_orbax. A mesh is
    not ported yet (ROADMAP.md A10): passing one raises."""
    from winograd_tpu_torch.kernels import _build

    if mesh is not None:
        raise NotImplementedError("a mesh is not ported yet (ROADMAP.md, queue A item 10: "
                                  "parallelism); restore onto one device")
    device = _build.require_device(device)
    path = os.fspath(path)
    with open(os.path.join(path, INDEX)) as f:
        tree = json.load(f)["tree"]

    def dec(node, ref, where):
        if like is not None:
            kind = (None if ref is None else dict if isinstance(ref, dict)
                    else list if isinstance(ref, (list, tuple)) else "leaf")
            got = (None if node is None else "leaf" if "__leaf__" in node
                   else dict if isinstance(node, dict) else list)
            if kind != got:
                raise ValueError(f"checkpoint {path}: {where or 'the root'} is {got}, "
                                 f"the like tree's is {kind}")
        if node is None:
            return None
        if isinstance(node, list):
            if like is not None and len(node) != len(ref):
                raise ValueError(f"checkpoint {path}: {where} has {len(node)} entries, the "
                                 f"like tree's {len(ref)}")
            return [dec(v, None if like is None else ref[i], f"{where}/{i}")
                    for i, v in enumerate(node)]
        if "__leaf__" not in node:
            if like is not None and set(node) != set(ref):
                raise ValueError(f"checkpoint {path}: {where or 'the root'} has keys "
                                 f"{sorted(node)}, the like tree's {sorted(ref)}")
            return {k: dec(v, None if like is None else ref[k], f"{where}/{k}")
                    for k, v in node.items()}
        shape, dtype = tuple(node["shape"]), node["dtype"]
        if like is not None and _leaf_spec(ref) != (shape, dtype):
            raise ValueError(f"checkpoint {path}: {where} is {dtype} {shape}, the like "
                             f"tree's {_leaf_spec(ref)[1]} {_leaf_spec(ref)[0]}")
        stored = np.int16 if dtype == "bfloat16" else np.dtype(dtype)
        data = np.fromfile(os.path.join(path, node["__leaf__"]), dtype=stored)
        if data.size != int(np.prod(shape)):
            raise ValueError(f"checkpoint {path}: {where} holds {data.size} values, "
                             f"want {shape}")
        t = torch.from_numpy(data.reshape(shape))
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device)

    return dec(tree, like, "")


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
