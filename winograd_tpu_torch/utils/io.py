"""Binary float32 blob IO and host transpose.

A copy of winograd_tpu/utils/io.py. The artifact contract is the
reference's: raw little-endian float32 files. Each function takes the
native host library (utils/native.py) where it loads and counts the call in
native.CALLS, else its numpy path (the *_numpy functions, which the library
is timed against). A missing or short file raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from winograd_tpu_torch.utils import native


def get_parameter_numpy(path: str | os.PathLike, size: int) -> np.ndarray:
    """get_parameter through numpy."""
    with open(os.fspath(path), "rb") as f:
        out = np.fromfile(f, dtype="<f4", count=size)
    if out.size != size:
        raise ValueError(f"{os.fspath(path)}: expected {size} float32 values, got {out.size}")
    return out


def get_parameter(path: str | os.PathLike, size: int) -> np.ndarray:
    """Load exactly `size` float32 values from a raw blob."""
    path = os.fspath(path)
    lib = native.load()
    if lib is None:
        return get_parameter_numpy(path, size)
    out = np.empty(size, dtype=np.float32)
    got = lib.wt_read_f32(path.encode(), native.f32p(out), size)
    native.CALLS["wt_read_f32"] += 1
    if got < 0:
        raise FileNotFoundError(f"cannot open parameter file: {path}")
    if got != size:
        raise ValueError(f"{path}: expected {size} float32 values, got {got}")
    return out


def get_parameters_numpy(spec: dict[str, int]) -> dict[str, np.ndarray]:
    """get_parameters through numpy, one blob after another."""
    return {p: get_parameter_numpy(p, size) for p, size in spec.items()}


def get_parameters(spec: dict[str, int], threads: int = 8) -> dict[str, np.ndarray]:
    """Load many blobs: {path: size} -> {path: array}, on the native
    library's thread pool (wt_read_many_f32) where it loads."""
    lib = native.load()
    if lib is None or not spec:
        return get_parameters_numpy(spec)
    paths = list(spec)
    outs = {p: np.empty(spec[p], dtype=np.float32) for p in paths}
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * len(paths))(
        *[native.f32p(outs[p]) for p in paths])
    c_counts = (ctypes.c_longlong * len(paths))(*[spec[p] for p in paths])
    ok = lib.wt_read_many_f32(c_paths, c_outs, c_counts, len(paths), threads)
    native.CALLS["wt_read_many_f32"] += 1
    if ok != len(paths):
        # Read one by one for the error of the file at fault.
        return {p: get_parameter(p, spec[p]) for p in paths}
    return outs


def save_parameter(path: str | os.PathLike, data: np.ndarray) -> None:
    """Write a float32 array as a raw little-endian blob."""
    path = os.fspath(path)
    flat = np.ascontiguousarray(data, dtype="<f4").ravel()
    lib = native.load()
    if lib is None:
        flat.tofile(path)
        return
    put = lib.wt_write_f32(path.encode(), native.f32p(flat), flat.size)
    native.CALLS["wt_write_f32"] += 1
    if put != flat.size:
        raise OSError(f"short write to {path}: {put}/{flat.size}")


def _flat(a: np.ndarray, h: int, w: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.float32).ravel()
    if a.size != h * w:
        raise ValueError(f"{a.size} values do not form a ({h}, {w}) buffer")
    return a


def transpose_numpy(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """transpose through numpy."""
    return np.ascontiguousarray(_flat(a, h, w).reshape(h, w).T).ravel()


def transpose(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host transpose of a flat (h, w) float32 buffer (util.c:15-26)."""
    lib = native.load()
    if lib is None:
        return transpose_numpy(a, h, w)
    a = _flat(a, h, w)
    out = np.empty(h * w, dtype=np.float32)
    lib.wt_transpose_f32(native.f32p(a), native.f32p(out), h, w)
    native.CALLS["wt_transpose_f32"] += 1
    return out
