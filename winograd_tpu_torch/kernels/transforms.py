"""Winograd F(2,3) / F(4,3) matrices and the offline filter and BN transforms.

numpy only; a copy of winograd_tpu/kernels/transforms.py's matrices and
functions, so the port derives its own filter layouts. Convention:

    Y = At [ (G g G^T) * (Bt d Bt^T) ] At^T

per (m+2)x(m+2) input tile d and 3x3 filter g (cross-correlation).
"""

from __future__ import annotations

import numpy as np

# F(4x4, 3x3), interpolation points 0, +-1, +-2, inf.
BT = np.array(
    [
        [4, 0, -5, 0, 1, 0],
        [0, -4, -4, 1, 1, 0],
        [0, 4, -4, -1, 1, 0],
        [0, -2, -1, 2, 1, 0],
        [0, 2, -1, -2, 1, 0],
        [0, 4, 0, -5, 0, 1],
    ],
    dtype=np.float64,
)
G = np.array(
    [
        [1.0 / 4.0, 0.0, 0.0],
        [-1.0 / 6.0, -1.0 / 6.0, -1.0 / 6.0],
        [-1.0 / 6.0, 1.0 / 6.0, -1.0 / 6.0],
        [1.0 / 24.0, 1.0 / 12.0, 1.0 / 6.0],
        [1.0 / 24.0, -1.0 / 12.0, 1.0 / 6.0],
        [0.0, 0.0, 1.0],
    ],
    dtype=np.float64,
)
AT = np.array(
    [
        [1, 1, 1, 1, 1, 0],
        [0, 1, -1, 2, -2, 0],
        [0, 1, 1, 4, 4, 0],
        [0, 1, -1, 8, -8, 1],
    ],
    dtype=np.float64,
)

# F(2x2, 3x3), interpolation points 0, +-1, inf.
BT2 = np.array(
    [
        [1, 0, -1, 0],
        [0, 1, 1, 0],
        [0, -1, 1, 0],
        [0, 1, 0, -1],
    ],
    dtype=np.float64,
)
G2 = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.5, 0.5, 0.5],
        [0.5, -0.5, 0.5],
        [0.0, 0.0, 1.0],
    ],
    dtype=np.float64,
)
AT2 = np.array(
    [
        [1, 1, 1, 0],
        [0, 1, -1, -1],
    ],
    dtype=np.float64,
)

TILE_R = 3  # filter side

_MATS = {4: (BT, G, AT), 2: (BT2, G2, AT2)}


def matrices(m: int = 4):
    """(Bt, G, At) for F(m x m, 3x3); m in {2, 4}."""
    if m not in _MATS:
        raise ValueError(f"unsupported Winograd tile size m={m}; choose 2 or 4")
    return _MATS[m]


def alpha(m: int = 4) -> int:
    """Input-tile side m + r - 1."""
    return m + TILE_R - 1


def transform_filter(w: np.ndarray, dtype=np.float32, m: int = 4) -> np.ndarray:
    """Offline Winograd filter transform: (Cout, Cin, 3, 3) -> (a^2, Cin, Cout),
    position-major with a (Cin, Cout) GEMM-ready matrix per tile position
    p = pi * a + pj. Computed in float64, cast once."""
    cout, cin, r, r2 = w.shape
    if (r, r2) != (TILE_R, TILE_R):
        raise ValueError(f"expected 3x3 filters, got {r}x{r2}")
    g = matrices(m)[1]
    a = alpha(m)
    u = np.einsum("ar,oirs,bs->aboi", g, w.astype(np.float64), g)
    u = u.reshape(a * a, cout, cin).transpose(0, 2, 1)
    return np.ascontiguousarray(u.astype(dtype))


def fold_batchnorm(gamma, beta, mean, var, eps: float = 1e-5, dtype=np.float32):
    """Inference BN folded into one FMA, y = scale * x + bias, with
    scale = gamma / sqrt(var + eps) and bias = beta - mean * scale."""
    inv_std = 1.0 / np.sqrt(np.asarray(var, np.float64) + eps)
    scale = np.asarray(gamma, np.float64) * inv_std
    bias = np.asarray(beta, np.float64) - np.asarray(gamma, np.float64) * np.asarray(
        mean, np.float64
    ) * inv_std
    return scale.astype(dtype), bias.astype(dtype)
