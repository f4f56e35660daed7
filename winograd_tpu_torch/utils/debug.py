"""Debug and validation subsystem (the twin of winograd_tpu/utils/debug.py).

* nan_checks()   - context manager: every public kernel wrapper's output is
                   checked for finite values after the call, and the first
                   non-finite one raises FloatingPointError naming the
                   kernel's launch counter (kernels/_build.py::LAUNCHES) and
                   the argument's shape: the counterpart of jax_debug_nans,
                   which raises at the op that produced the NaN. CPU tensors
                   (the plain versions) are checked the same way. The check
                   synchronizes, so it cannot run inside a CUDA graph
                   capture: entered during one it raises at once (the
                   engines never enter it). On the card a kernel's fused
                   ReLU (fmaxf) maps a NaN to 0 where torch.relu keeps it,
                   so a NaN surfaces at the first launch without one.
* check_finite() - host-side assertion on a tree of tensors or numpy arrays,
                   for use at subsystem boundaries (checkpoint load, datagen
                   output).

The JAX module's interpret_mode() (the Pallas interpreter) has no CUDA
counterpart; to debug a kernel, run with CUDA_LAUNCH_BLOCKING=1 (an error
then surfaces at the launch that caused it) and under compute-sanitizer
where the host has it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Tuple

import numpy as np
import torch

from winograd_tpu_torch.kernels import _build


@contextlib.contextmanager
def nan_checks():
    """Check every kernel wrapper's output for non-finite values in the scope
    (slow: each check synchronizes; debug runs only)."""
    if _build.capturing():
        raise RuntimeError("nan_checks cannot be entered during CUDA graph capture")
    old = _build.NAN_CHECKS
    _build.NAN_CHECKS = True
    try:
        yield
    finally:
        _build.NAN_CHECKS = old


def _leaves_with_path(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict, list or tuple, paths written as
    jax.tree_util.keystr writes them (dict keys sorted, as jax.tree flattens
    them); None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def check_finite(tree: Any, name: str = "tree") -> None:
    """Raise ValueError naming the offending leaf by its path, with its count
    of non-finite values and its shape, if any value is non-finite. Leaves
    are tensors on any device, numpy arrays or numbers."""
    for path, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.is_floating_point() and leaf.dtype != torch.float64:
                leaf = leaf.float()   # numpy has no bfloat16
            leaf = leaf.numpy()
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise ValueError(f"{name}{path}: {bad} non-finite value(s), shape {arr.shape}")
