"""Rotations and numeric Wigner-D matrices (numpy, for equivariance tests).

Counterpart of ``equiformer_tpu.core.rotations``: ``wigner_D`` is recovered
by least squares from the port's own spherical harmonics, so it is
consistent with the SH and CG conventions by construction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .irreps import Irreps
from .spherical import spherical_harmonics


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform random rotation matrix in SO(3) (numpy, float64)."""
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


@functools.lru_cache(maxsize=None)
def _sample_points(n: int = 64) -> np.ndarray:
    rng = np.random.default_rng(12345)
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _sh(l: int, pts: np.ndarray) -> np.ndarray:
    return spherical_harmonics([l], torch.from_numpy(pts), normalize=False).numpy()


def wigner_D(l: int, R: np.ndarray) -> np.ndarray:
    """D^l(R) with Y_l(R x) = D^l(R) @ Y_l(x), in the port's real basis."""
    if l == 0:
        return np.ones((1, 1))
    pts = _sample_points()
    # rows are samples: B = A @ D^T
    D_T, *_ = np.linalg.lstsq(_sh(l, pts), _sh(l, pts @ R.T), rcond=None)
    return D_T.T


def irreps_D(irreps: Irreps, R: np.ndarray, parity: int = 1) -> np.ndarray:
    """Block-diagonal D for a flat feature of the component-major layout:
    each (mul, ir) block contributes kron(D_l, I_mul); ``parity=-1`` composes
    with spatial inversion (each block times ir.p)."""
    blocks = []
    for mul, ir in Irreps(irreps):
        D = wigner_D(ir.l, R)
        if parity == -1:
            D = D * ir.p
        blocks.append(np.kron(D, np.eye(mul)))
    n = sum(b.shape[0] for b in blocks)
    out = np.zeros((n, n))
    i = 0
    for b in blocks:
        d = b.shape[0]
        out[i : i + d, i : i + d] = b
        i += d
    return out


def transform(irreps: Irreps, features: np.ndarray, R: np.ndarray, parity: int = 1):
    """Apply the irreps rotation to flat features [..., irreps.dim]."""
    return features @ irreps_D(irreps, R, parity).T
