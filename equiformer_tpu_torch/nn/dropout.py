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
``MaskReplay`` wraps either for a block that autograd recomputes (remat):
the forward's masks are drawn once and replayed on every recompute.
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
    if isinstance(rng, MaskReplay):
        return rng.draw(shape, keep, device)
    if isinstance(rng, torch.Generator):
        return torch.rand(shape, generator=rng, device=device) < keep
    m = next(rng)
    if tuple(m.shape) != tuple(shape):
        raise ValueError(f"injected mask has shape {tuple(m.shape)}, the site needs {tuple(shape)}")
    return m.to(device=device, dtype=torch.bool)


class MaskReplay:
    """The keep masks of one recomputed block (``torch.utils.checkpoint``).
    Each run of the block starts with ``start()``: the first run draws its
    masks from ``rng`` (a generator or an iterator of masks, as
    ``keep_mask`` takes it) and records them, every later run (autograd's
    recompute, once or more per backward) replays them in order.  So the
    recompute sees the forward's masks, and ``rng`` advances as far as it
    does without remat; ``runs`` counts the runs.  Checkpointing's own
    ``preserve_rng_state`` saves only the default generators, which no
    dropout site draws from."""

    def __init__(self, rng):
        self.rng = rng
        self.masks = []
        self.runs = 0
        self._replay = None

    def start(self) -> "MaskReplay":
        self._replay = iter(self.masks) if self.runs else None
        self.runs += 1
        return self

    def draw(self, shape, keep: float, device) -> torch.Tensor:
        if self._replay is None:
            m = keep_mask(self.rng, shape, keep, device)
            self.masks.append(m)
            return m
        m = next(self._replay)
        if tuple(m.shape) != tuple(shape):
            raise RuntimeError(f"the recompute asks for a mask of {tuple(shape)}, the forward "
                               f"drew {tuple(m.shape)}")
        return m


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
