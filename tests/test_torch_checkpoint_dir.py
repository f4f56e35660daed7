"""The checkpoint directory (models/checkpoint.py::save_checkpoint_dir and
load_checkpoint_dir, the twin of the JAX package's orbax save_model_orbax /
load_model_orbax; orbax is no dependency of either test environment, so the
port is held to the semantics alone), on the CPU:

* a ResNet-50 trainable tree (tests/test_torch_checkpoint.py's tiny
  geometry, with a bfloat16 copy of its leaves beside it) round-trips bit
  for bit, written in the background (wait=False) while the caller changes
  its own tensors, then wait_until_finished();
* a writer's error is re-raised by wait_until_finished(), and nothing is
  left at the target or beside it;
* a `like` tree of another structure, shape or dtype is refused; a mesh is
  not ported and raises; an existing target is refused;
* ResNet50Engine.from_checkpoint serves the directory as it serves the
  save_model file of the same tree, to the bit.
"""

import os

import numpy as np
import pytest
import torch

from winograd_tpu_torch.engine import ResNet50Engine
from winograd_tpu_torch.models import checkpoint as tck
from winograd_tpu_torch.models import train as ttrain
from winograd_tpu_torch.models.resnet50 import init_resnet50_arrays
from winograd_tpu_torch.utils.tree import tree_leaves, tree_map
from winograd_tpu_torch.parallel import make_mesh
from torch_parallel_ranks import one_rank_world

from test_torch_checkpoint import _TinyR50


@pytest.fixture()
def tree():
    arrays = ttrain.trainable_resnet50_params(init_resnet50_arrays(_TinyR50("tiny"), seed=2))
    f32 = tree_map(torch.as_tensor, arrays)
    return {"params": f32, "bf16": tree_map(lambda t: t.to(torch.bfloat16), f32["head"]),
            "step": torch.tensor(7), "none": None, "list": [np.arange(3), np.float32(2.5)]}


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def test_round_trip_bit_for_bit_in_the_background(tmp_path, tree):
    path = tmp_path / "ckpt"
    want = tree_map(lambda t: torch.as_tensor(t).clone(), tree)
    handle = tck.save_checkpoint_dir(path, tree, wait=False)
    for leaf in tree_leaves(tree["params"]):
        leaf.add_(1.0)          # the caller goes on; the checkpoint holds the old values
    handle.wait_until_finished()
    assert path.is_dir()
    names = sorted(os.listdir(path))
    assert tck.INDEX in names and len(names) == 1 + len(tree_leaves(want))
    loaded = tck.load_checkpoint_dir(path, device="cpu")
    assert _same(loaded, want)
    assert _same(tck.load_checkpoint_dir(path, like=want, device="cpu"), want)
    assert tck.save_checkpoint_dir(tmp_path / "again", want) is None   # wait=True blocks
    assert _same(tck.load_checkpoint_dir(tmp_path / "again", device="cpu"), want)
    with pytest.raises(FileExistsError):
        tck.save_checkpoint_dir(path, want)


def test_a_writer_error_is_re_raised_and_leaves_nothing(monkeypatch, tmp_path, tree):
    def failing(directory, name, data):
        raise OSError("disk full")

    monkeypatch.setattr(tck, "_write_leaf", failing)
    handle = tck.save_checkpoint_dir(tmp_path / "ckpt", tree, wait=False)
    with pytest.raises(OSError, match="disk full"):
        handle.wait_until_finished()
    assert os.listdir(tmp_path) == []
    with pytest.raises(OSError, match="disk full"):
        tck.save_checkpoint_dir(tmp_path / "ckpt", tree)


def test_like_refuses_another_structure_shape_or_dtype(tmp_path, tree):
    path = tmp_path / "ckpt"
    tck.save_checkpoint_dir(path, tree)
    params = tree["params"]
    wrong = [
        dict(tree, extra=None),                                        # a key more
        dict(tree, list=[np.arange(3)]),                               # a list entry fewer
        dict(tree, none=np.zeros(1)),                                  # None against a leaf
        dict(tree, step=torch.tensor(7, dtype=torch.int32)),           # dtype
        dict(tree, params=dict(params, head=dict(params["head"],
                                                 b_fc=torch.zeros(3)))),  # shape
        dict(tree, bf16=tree_map(lambda t: t.float(), tree["bf16"])),  # bf16 against f32
    ]
    for like in wrong:
        with pytest.raises(ValueError, match="like tree"):
            tck.load_checkpoint_dir(path, like=like, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tck.load_checkpoint_dir(path, device="cpu", mesh=object())
    # Under a mesh (one rank in this process) every rank restores the whole
    # tree onto its own device, the mesh's.
    with one_rank_world(tmp_path / "world"):
        mesh = make_mesh(1, 1, device="cpu")
        assert _same(tck.load_checkpoint_dir(path, like=tree, device="cpu", mesh=mesh), tree)


def test_engine_serves_the_directory_as_the_save_model_file(tmp_path):
    cfg = _TinyR50("tiny")
    trained = ttrain.trainable_resnet50_params(init_resnet50_arrays(cfg, seed=4))
    tck.save_model(str(tmp_path / "ckpt.npz"), trained)
    tck.save_checkpoint_dir(tmp_path / "ckpt", trained)
    x = (np.random.default_rng(0).random((2, cfg.img, cfg.img, 3)) - 0.5).astype(np.float32)
    for tier in ("f32", "int8"):
        ref = ResNet50Engine.from_checkpoint(str(tmp_path / "ckpt.npz"), tier=tier, device="cpu")
        ours = ResNet50Engine.from_checkpoint(str(tmp_path / "ckpt"), tier=tier, device="cpu")
        assert torch.equal(ours(x), ref(x))
