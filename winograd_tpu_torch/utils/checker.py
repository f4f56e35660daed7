"""Differential output checker.

A copy of winograd_tpu/utils/checker.py on numpy alone. The reference's
checker prints max_error / error_cnt and never fails; here the check
returns a structured result and the benchmark raises ParityError on a
breach.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from winograd_tpu_torch.config import PARITY_ATOL


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
    elementwise comparison. Arbitrary-rank inputs are compared flat.
    """
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
