"""Gaussian radial basis and the radial weight MLP.

Counterparts of ``equiformer_tpu.nn.radial.GaussianRadialBasis`` (learnable
Graphormer-style gaussians) and ``RadialProfile`` (``ScalarMLP`` with a
bias-free final layer plus a separate learnable ``offset``).
"""

from __future__ import annotations

import math
from typing import Tuple

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
