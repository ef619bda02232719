"""Irreps-wise linear layer and the plain scalar MLP.

``IrrepsLinear`` is the counterpart of ``equiformer_tpu.nn.linear.IrrepsLinear``:
one [fan_in, mul_out] matmul per output block over all input blocks of the
same irrep, weights N(0, scale^2/fan_in), bias on even scalars.  Parameter
names (``w{i}``, ``b{i}``) and shapes are the flax ones.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.irreps import Irreps


class IrrepsLinear(nn.Module):
    """Equivariant linear map mixing multiplicities within each irrep."""

    def __init__(self, irreps_in, irreps_out, use_bias: bool = True,
                 weight_init_scale: float = 1.0):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self.weight_init_scale = weight_init_scale
        self._in_dims = [mul * ir.dim for mul, ir in self.irreps_in]
        self._blocks_per_out = []  # per output block: (input block, ir dim, mul_in)
        self._bias_blocks = []
        for oi, (mul_out, ir_out) in enumerate(self.irreps_out):
            blocks = [(ii, ir_in.dim, mul_in)
                      for ii, (mul_in, ir_in) in enumerate(self.irreps_in)
                      if ir_in == ir_out]
            self._blocks_per_out.append(blocks)
            if blocks:
                fan_in = sum(m for _, _, m in blocks)
                self.register_parameter(f"w{oi}", nn.Parameter(torch.empty(fan_in, mul_out)))
            if use_bias and ir_out.is_scalar():
                self.register_parameter(f"b{oi}", nn.Parameter(torch.empty(mul_out)))
                self._bias_blocks.append(oi)

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for oi, blocks in enumerate(self._blocks_per_out):
                if blocks:
                    w = getattr(self, f"w{oi}")
                    std = self.weight_init_scale / np.sqrt(w.shape[0])
                    w.copy_(torch.randn(w.shape, generator=gen) * std)
            for oi in self._bias_blocks:
                getattr(self, f"b{oi}").zero_()

    def weight_list(self) -> List[Optional[torch.Tensor]]:
        """Per-output-block weights ([fan_in, mul_out] or None), the layout
        the fused DTP kernel packs from."""
        return [getattr(self, f"w{oi}") if blocks else None
                for oi, blocks in enumerate(self._blocks_per_out)]

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        """Add the scalar biases to an output laid out like ``forward``'s."""
        if not self._bias_blocks:
            return y
        out_slices = self.irreps_out.slices()
        pieces, last = [], 0
        for oi in self._bias_blocks:
            sl = out_slices[oi]
            pieces.append(y[..., last : sl.start])
            b = getattr(self, f"b{oi}").to(y.dtype)
            pieces.append(y[..., sl] + b.repeat(self.irreps_out[oi].ir.dim))
            last = sl.stop
        pieces.append(y[..., last:])
        return torch.cat(pieces, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # one split, whose backward is one cat: a slice per block would cost
        # a zero fill and an add of x's whole width each in the backward
        parts = torch.split(x, self._in_dims, dim=-1)
        pieces = []
        for oi, (mul_out, ir_out) in enumerate(self.irreps_out):
            blocks = [parts[ii].reshape(x.shape[:-1] + (d, mul_in))
                      for ii, d, mul_in in self._blocks_per_out[oi]]
            if blocks:
                inp = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=-1)
                out = inp @ getattr(self, f"w{oi}").to(x.dtype)
            else:
                out = x.new_zeros(x.shape[:-1] + (ir_out.dim, mul_out))
            if oi in self._bias_blocks:
                out = out + getattr(self, f"b{oi}").to(x.dtype)
            pieces.append(out.reshape(out.shape[:-2] + (mul_out * ir_out.dim,)))
        return torch.cat(pieces, dim=-1) if len(pieces) > 1 else pieces[0]


def init_parameters(module: nn.Module, seed: int) -> None:
    """Seeded init of every submodule with an ``init_(generator)`` method, in
    ``module.modules()`` order, with the JAX package's distributions (the
    draws themselves differ from ``jax.random``)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(gen)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * 1/(1 + exp(-x)), written out as the JAX package writes it."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


class ScalarMLP(nn.Module):
    """Linear -> LayerNorm -> SiLU stacks with a bias-free final Linear (the
    radial profile's layout).  Submodules ``dense{i}`` / ``ln{i}`` follow the
    flax scopes; flax's LayerNorm epsilon is 1e-6."""

    def __init__(self, in_features: int, features: Tuple[int, ...]):
        super().__init__()
        self.n = len(features)
        fan = in_features
        for i, f in enumerate(features):
            last = i == self.n - 1
            self.add_module(f"dense{i}", nn.Linear(fan, f, bias=not last))
            if not last:
                self.add_module(f"ln{i}", nn.LayerNorm(f, eps=1e-6))
            fan = f

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for i in range(self.n):
                d = getattr(self, f"dense{i}")
                bound = 1.0 / np.sqrt(d.in_features)
                d.weight.copy_(torch.rand(d.weight.shape, generator=gen) * 2 * bound - bound)
                if i < self.n - 1:
                    d.bias.zero_()
                    getattr(self, f"ln{i}").reset_parameters()

    def forward(self, x: torch.Tensor, fold_final: bool = False):
        """The MLP's output, or with ``fold_final`` the last hidden
        activation and the final kernel ``[fan, out]`` (``dense{n-1}.weight``
        transposed, in x's dtype) for a caller that applies it inside a
        fused kernel (JAX's ``ScalarMLP(fold_final=True)``); the parameters
        and their gradients are the same either way."""
        for i in range(self.n):
            d = getattr(self, f"dense{i}")
            if fold_final and i == self.n - 1:
                return x, d.weight.to(x.dtype).t()
            x = nn.functional.linear(
                x, d.weight.to(x.dtype), None if d.bias is None else d.bias.to(x.dtype))
            if i < self.n - 1:
                x = silu(_layer_norm(getattr(self, f"ln{i}"), x))
        return x


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with statistics in at least fp32 and the output in x's dtype,
    like flax's LayerNorm under a low-precision ``dtype``."""
    xs = x.to(torch.promote_types(x.dtype, torch.float32))
    y = nn.functional.layer_norm(xs, ln.normalized_shape, ln.weight.to(xs.dtype),
                                 ln.bias.to(xs.dtype), ln.eps)
    return y.to(x.dtype)
