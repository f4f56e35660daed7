"""Binary float32 blob IO and host transpose.

A copy of winograd_tpu/utils/io.py on numpy alone (the JAX package's native
C++ loader, utils/native.py, is not ported). The artifact contract is the
reference's: raw little-endian float32 files. A missing or short file
raises.
"""

from __future__ import annotations

import os

import numpy as np


def get_parameter(path: str | os.PathLike, size: int) -> np.ndarray:
    """Load exactly `size` float32 values from a raw blob."""
    with open(os.fspath(path), "rb") as f:
        out = np.fromfile(f, dtype="<f4", count=size)
    if out.size != size:
        raise ValueError(f"{os.fspath(path)}: expected {size} float32 values, got {out.size}")
    return out


def get_parameters(spec: dict[str, int]) -> dict[str, np.ndarray]:
    """Load many blobs: {path: size} -> {path: array}."""
    return {p: get_parameter(p, size) for p, size in spec.items()}


def save_parameter(path: str | os.PathLike, data: np.ndarray) -> None:
    """Write a float32 array as a raw little-endian blob."""
    np.ascontiguousarray(data, dtype="<f4").ravel().tofile(os.fspath(path))


def transpose(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host transpose of a flat (h, w) float32 buffer."""
    a = np.ascontiguousarray(a, dtype=np.float32).ravel()
    if a.size != h * w:
        raise ValueError(f"{a.size} values do not form a ({h}, {w}) buffer")
    return np.ascontiguousarray(a.reshape(h, w).T).ravel()
