"""Real spherical harmonics with 'component' normalization, defined via CG recursion.

``Y_0 = 1`` and ``Y_1(x) = sqrt(3) * (y, z, x)``; higher degrees are
``Y_{l+1} = c_l * C(Y_l, Y_1)`` with the real Wigner-3j intertwiner ``C`` and a
constant ``c_l`` that makes ``|Y_l(x)|^2 = 2l+1`` on the unit sphere.  Same
definition as ``equiformer_tpu.core.spherical``, so SH and tensor products
share one set of CG tables.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence

import numpy as np
import torch

from .cg import wigner_3j
from .irreps import Irreps


@functools.lru_cache(maxsize=None)
def _recursion_constants(lmax: int):
    """Rescale constants c_l, computed in float64 at a generic unit vector (the
    norm of an equivariant map is constant on the sphere)."""
    v = np.array([0.2972, -0.5863, 0.7535])
    v = v / np.linalg.norm(v)
    y1 = math.sqrt(3.0) * np.array([v[1], v[2], v[0]])
    ys = [np.array([1.0]), y1]
    consts: List[float] = []
    for l in range(1, lmax):
        raw = np.einsum("i,j,ijk->k", ys[l], y1, wigner_3j(l, 1, l + 1))
        c = math.sqrt(2 * (l + 1) + 1) / np.linalg.norm(raw)
        consts.append(c)
        ys.append(c * raw)
    return tuple(consts)


@functools.lru_cache(maxsize=None)
def _cg_tensor(l: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(wigner_3j(l, 1, l + 1), dtype=dtype, device=device)


def spherical_harmonics(
    ls: Sequence[int], x: torch.Tensor, normalize: bool = True, eps: float = 1e-12
) -> torch.Tensor:
    """Concatenated real SH of the given degrees, shape [..., sum(2l+1)].

    ``x`` [..., 3] is in (x, y, z) order; ``normalize=True`` projects it to
    the unit sphere first, and zero vectors give Y_0 = 1 and zeros elsewhere.
    """
    ls = list(ls)
    lmax = max(ls)
    if normalize:
        n2 = torch.sum(x * x, dim=-1, keepdim=True)
        safe = n2 > eps
        n2_safe = torch.where(safe, n2, torch.ones_like(n2))
        x = torch.where(safe, x, torch.zeros_like(x)) / torch.sqrt(n2_safe)
    y1 = math.sqrt(3.0) * torch.stack([x[..., 1], x[..., 2], x[..., 0]], dim=-1)
    ys = [torch.ones_like(x[..., :1]), y1]
    consts = _recursion_constants(max(lmax, 1))
    for l in range(1, lmax):
        C = _cg_tensor(l, x.dtype, x.device)
        ys.append(consts[l - 1] * torch.einsum("...i,...j,ijk->...k", ys[l], y1, C))
    return torch.cat([ys[l] for l in ls], dim=-1)


def spherical_harmonics_for_irreps(
    irreps: Irreps, x: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """SH matching an irreps signature like '1x0e+1x1e+1x2e' (mul must be 1)."""
    for mul, _ in irreps:
        if mul != 1:
            raise ValueError(f"SH irreps must have multiplicity 1, got {irreps}")
    return spherical_harmonics([ir.l for _, ir in irreps], x, normalize=normalize)
