"""Radial bases and the radial weight MLP.

Counterparts of ``equiformer_tpu.nn.radial``: ``GaussianRadialBasis``
(learnable Graphormer-style gaussians), ``ExpNormalBasis`` (PhysNet
exp-normal smearing with a cosine cutoff, fixed as ``make_rbf`` builds it),
``BesselRadialBasis`` (learnable frequencies, degree-5 polynomial envelope),
``make_rbf`` and ``RadialProfile`` (``ScalarMLP`` with a bias-free final
layer plus a separate learnable ``offset``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .linear import ScalarMLP


class RadialProfile(nn.Module):
    """MLP mapping edge scalars (RBF values) to per-edge TP weights."""

    def __init__(self, in_features: int, features: Tuple[int, ...]):
        super().__init__()
        self.net = ScalarMLP(in_features, tuple(features))
        self.offset = nn.Parameter(torch.empty(features[-1]))

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.offset.zero_()

    def forward(self, x: torch.Tensor, fold_final: bool = False):
        """Per-edge weights ``net(x) + offset``, or with ``fold_final`` the
        triple ``(h, Wr, offset)`` (last hidden activation, final kernel,
        offset, in x's dtype) that a radial-folded fused op turns into
        ``h @ Wr + offset`` inside its kernel (JAX's
        ``RadialProfile(fold_final=True)``)."""
        if fold_final:
            h, Wr = self.net(x, fold_final=True)
            return h, Wr, self.offset.to(x.dtype)
        return self.net(x) + self.offset.to(x.dtype)


class GaussianRadialBasis(nn.Module):
    def __init__(self, num_basis: int, cutoff: float):
        super().__init__()
        self.num_basis = num_basis
        self.cutoff = cutoff
        self.mean = nn.Parameter(torch.empty(num_basis))
        self.std = nn.Parameter(torch.empty(num_basis))
        self.weight = nn.Parameter(torch.empty(1))
        self.bias = nn.Parameter(torch.empty(1))

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.mean.copy_(torch.rand(self.num_basis, generator=gen))
            lo = 1.0 / self.num_basis
            self.std.copy_(lo + (1.0 - lo) * torch.rand(self.num_basis, generator=gen))
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        x = dist[..., None] / self.cutoff
        x = self.weight.to(x.dtype) * x + self.bias.to(x.dtype)
        s = torch.abs(self.std.to(x.dtype)) + 1e-5
        return torch.exp(-0.5 * ((x - self.mean.to(x.dtype)) / s) ** 2) / (
            math.sqrt(2 * math.pi) * s)


def cosine_cutoff(dist: torch.Tensor, cutoff_upper: float, cutoff_lower: float = 0.0):
    if cutoff_lower > 0:
        c = 0.5 * (torch.cos(math.pi * (2.0 * (dist - cutoff_lower)
                                        / (cutoff_upper - cutoff_lower) + 1.0)) + 1.0)
        return c * ((dist < cutoff_upper) & (dist > cutoff_lower)).to(dist.dtype)
    c = 0.5 * (torch.cos(dist * math.pi / cutoff_upper) + 1.0)
    return c * (dist < cutoff_upper).to(dist.dtype)


class ExpNormalBasis(nn.Module):
    """PhysNet exp-normal smearing with a cosine cutoff; the means and betas
    are the JAX package's float32 constants (no parameters)."""

    def __init__(self, num_basis: int, cutoff: float, cutoff_lower: float = 0.0):
        super().__init__()
        self.cutoff = cutoff
        self.cutoff_lower = cutoff_lower
        start = math.exp(-cutoff + cutoff_lower)
        self.register_buffer("means", torch.from_numpy(
            np.linspace(start, 1.0, num_basis, dtype=np.float32)), persistent=False)
        self.register_buffer("betas", torch.from_numpy(np.full(
            (num_basis,), (2.0 / num_basis * (1.0 - start)) ** -2, dtype=np.float32)),
            persistent=False)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        alpha = 5.0 / (self.cutoff - self.cutoff_lower)
        d = dist[..., None]
        env = cosine_cutoff(d, self.cutoff)
        return env * torch.exp(-self.betas.to(d.dtype) * (
            torch.exp(alpha * (-d + self.cutoff_lower)) - self.means.to(d.dtype)) ** 2)


class BesselRadialBasis(nn.Module):
    """sqrt(2/c) * sin(n pi d/c) / d with a degree-5 polynomial envelope
    (the spherical-Bessel l=0 basis of the reference's bessel variants)."""

    def __init__(self, num_basis: int, cutoff: float, envelope_exponent: int = 5):
        super().__init__()
        self.num_basis = num_basis
        self.cutoff = cutoff
        self.envelope_exponent = envelope_exponent
        self.frequencies = nn.Parameter(torch.empty(num_basis))

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.frequencies.copy_(torch.arange(1, self.num_basis + 1, dtype=torch.float32)
                                   * math.pi)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = torch.clamp(dist[..., None], min=1e-9) / self.cutoff
        p = self.envelope_exponent + 1
        a = -(p + 1) * (p + 2) / 2.0
        b = p * (p + 2.0)
        c = -p * (p + 1) / 2.0
        env = (1.0 / d + a * d ** (p - 1) + b * d ** p + c * d ** (p + 1)) * (d < 1.0).to(d.dtype)
        return env * math.sqrt(2.0 / self.cutoff) * torch.sin(self.frequencies.to(d.dtype) * d)


def make_rbf(basis_type: str, num_basis: int, cutoff: float) -> nn.Module:
    if basis_type == "gaussian":
        return GaussianRadialBasis(num_basis, cutoff)
    if basis_type == "bessel":
        return BesselRadialBasis(num_basis, cutoff)
    if basis_type == "exp":
        return ExpNormalBasis(num_basis, cutoff)
    raise ValueError(f"unknown basis type {basis_type}")
