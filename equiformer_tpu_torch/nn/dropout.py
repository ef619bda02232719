"""Equivariant dropout variants and the keep masks of every dropout site.

Counterparts of ``equiformer_tpu.nn.dropout``:

* ``EquivariantDropout`` — drops whole irrep copies: one Bernoulli mask per
  (node, irrep copy), broadcast across components;
* ``EquivariantScalarsDropout`` — plain dropout on the scalar blocks only;
* ``GraphDropPath`` — stochastic depth with one mask per graph.

They act in training mode (``module.training``, JAX's
``deterministic=False``) and take their randomness explicitly: ``rng`` is a
``torch.Generator`` on the tensors' device, or an iterator of keep masks
that are used in call order instead of drawing (tests inject the same masks
into both packages, since ``jax.random`` and torch draw different bits).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.irreps import Irreps
from ..core.tensor_product import elementwise_multiply


def keep_mask(rng, shape, keep: float, device) -> torch.Tensor:
    """Bool keep mask of ``shape``, each entry kept with probability
    ``keep``: drawn from ``rng`` (a ``torch.Generator``), or the next mask of
    ``rng`` (an iterator of given masks)."""
    if rng is None:
        raise ValueError("dropout in training mode needs a torch.Generator (or injected masks)")
    if isinstance(rng, torch.Generator):
        return torch.rand(shape, generator=rng, device=device) < keep
    m = next(rng)
    if tuple(m.shape) != tuple(shape):
        raise ValueError(f"injected mask has shape {tuple(m.shape)}, the site needs {tuple(shape)}")
    return m.to(device=device, dtype=torch.bool)


def dropout_multiplier(rng, shape, p: float, dtype, device) -> torch.Tensor:
    """keep mask / keep rate in ``dtype``, as ``jax.random.bernoulli(...) / keep``."""
    keep = 1.0 - p
    return keep_mask(rng, shape, keep, device).to(dtype) / keep


class EquivariantDropout(nn.Module):
    def __init__(self, irreps, drop_prob: float):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        if not self.training or self.drop_prob == 0.0:
            return x
        scal = dropout_multiplier(rng, x.shape[:-1] + (self.irreps.num_irreps,),
                                  self.drop_prob, x.dtype, x.device)
        return elementwise_multiply(self.irreps, x, scal)


class EquivariantScalarsDropout(nn.Module):
    def __init__(self, irreps, drop_prob: float):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        if not self.training or self.drop_prob == 0.0:
            return x
        pieces, i = [], 0
        for mul, ir in self.irreps:
            blk = x[..., i : i + mul * ir.dim]
            if ir.is_scalar():
                blk = blk * dropout_multiplier(rng, blk.shape, self.drop_prob, x.dtype, x.device)
            pieces.append(blk)
            i += mul * ir.dim
        return torch.cat(pieces, dim=-1)


class GraphDropPath(nn.Module):
    """Per-graph stochastic depth on the residual branch."""

    def __init__(self, drop_prob: float):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor, batch: torch.Tensor, num_graphs: int,
                rng=None) -> torch.Tensor:
        if not self.training or self.drop_prob == 0.0:
            return x
        gmask = dropout_multiplier(rng, (num_graphs,), self.drop_prob, x.dtype, x.device)
        return x * gmask[batch].reshape((-1,) + (1,) * (x.dim() - 1))
