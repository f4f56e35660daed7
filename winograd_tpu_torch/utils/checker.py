"""Differential output checker.

A copy of winograd_tpu/utils/checker.py. The reference's checker prints
max_error / error_cnt and never fails; here the check returns a structured
result and the benchmark raises ParityError on a breach. The shift-aware
form runs on the native host library (utils/native.py) where it loads, as
the JAX package's does, else on numpy (output_checker_numpy).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.utils import native


class ParityError(AssertionError):
    pass


@dataclasses.dataclass(frozen=True)
class CheckResult:
    max_error: float
    error_count: int
    total: int
    tol: float

    @property
    def error_fraction(self) -> float:
        return self.error_count / max(self.total, 1)

    def ok(self) -> bool:
        """Pass iff the max error is finite (NaN/Inf anywhere fails) and
        max_error <= tol: a strict max-abs-err bar, tighter than the
        reference's <0.1%-violations criterion."""
        return bool(np.isfinite(self.max_error)) and self.max_error <= self.tol

    def __str__(self) -> str:
        return (
            f"max_error={self.max_error:.3e} error_cnt={self.error_count}/{self.total} "
            f"(tol={self.tol:g})"
        )


def output_checker_numpy(
    a: np.ndarray,
    b: np.ndarray,
    length: int | None = None,
    channels: int | None = None,
    shift: int = 0,
    tol: float = PARITY_ATOL,
) -> CheckResult:
    """output_checker through numpy."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    if length is None or channels is None:
        # NaN diffs must count as violations (NaN > tol is False), hence
        # ~(diff <= tol).
        if a.shape != b.shape:
            raise ValueError(f"shapes differ: {a.shape} and {b.shape}")
    else:
        a = a[shift : shift + length, shift : shift + length, :channels]
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    max_err = float(np.max(diff)) if diff.size else 0.0
    return CheckResult(max_err, int((~(diff <= tol)).sum()), diff.size, tol)


def output_checker(
    a: np.ndarray,
    b: np.ndarray,
    length: int | None = None,
    channels: int | None = None,
    shift: int = 0,
    tol: float = PARITY_ATOL,
) -> CheckResult:
    """Shift-aware elementwise comparison.

    a: (side_a, side_a, C) candidate, valid region at +shift in both spatial
    dims (the reference's padded-16x16-vs-dense-14x14 case, shift=1);
    b: (len, len, C) oracle. With shift=0 and matching shapes this is a plain
    elementwise comparison. Arbitrary-rank inputs are compared flat. The
    shift-aware form runs wt_output_checker where the native library loads
    and a is square with exactly `channels` channels.
    """
    lib = native.load()
    fits = (length is not None and channels is not None and a.ndim == 3
            and a.shape[0] == a.shape[1] >= shift + length and a.shape[2] == channels
            and b.shape == (length, length, channels))
    if lib is None or not fits:
        return output_checker_numpy(a, b, length, channels, shift, tol)
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    max_err = ctypes.c_double(0.0)
    count = lib.wt_output_checker(native.f32p(a), native.f32p(b), length, channels, shift,
                                  a.shape[0], tol, ctypes.byref(max_err))
    native.CALLS["wt_output_checker"] += 1
    return CheckResult(float(max_err.value), int(count), length * length * channels, tol)
