"""Equivariant activations: normalized scalar activations and the Gate.

Counterpart of ``equiformer_tpu.nn.activation``.  Every scalar activation is
scaled so that E[act(z)^2] = 1 for z ~ N(0,1) (e3nn's ``normalize2mom``); the
constant comes from the same numpy quadrature as the JAX package, so both
packages use the same float.  Gate layout: input [scalars | gates | gated],
output [act(scalars) | gated * sigmoid(gates)].
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.irreps import Irrep, Irreps
from ..core.tensor_product import elementwise_multiply


@functools.lru_cache(maxsize=None)
def _moment_and_parity(name: str) -> Tuple[float, int]:
    """(1/sqrt(E[act^2]), parity) for z ~ N(0,1); parity in {1, -1, 0}."""
    z = np.linspace(-12.0, 12.0, 480001)
    w = np.exp(-0.5 * z * z)
    w /= np.sum(w)
    f = _np_act(name)
    vals = f(z)
    factor = 1.0 / np.sqrt(np.sum(w * vals * vals))
    x = np.linspace(0.0, 10.0, 256)
    a1, a2 = f(x), f(-x)
    if np.max(np.abs(a1 - a2)) < 1e-5:
        parity = 1
    elif np.max(np.abs(a1 + a2)) < 1e-5:
        parity = -1
    else:
        parity = 0
    return float(factor), parity


def _slrelu_alpha(name: str) -> float:
    return float(name.split(":")[1]) if ":" in name else 0.2


def _np_act(name: str) -> Callable[[np.ndarray], np.ndarray]:
    if name == "silu":
        return lambda x: x / (1.0 + np.exp(-x))
    if name == "sigmoid":
        return lambda x: 1.0 / (1.0 + np.exp(-x))
    if name.startswith("smooth_leaky_relu"):
        a = _slrelu_alpha(name)
        return lambda x: ((1 + a) / 2.0) * x + ((1 - a) / 2.0) * x * (
            2.0 / (1.0 + np.exp(-x)) - 1.0)
    raise ValueError(f"unknown activation {name}")


def _torch_act(name: str) -> Callable:
    if name == "silu":
        return lambda x: x * torch.reciprocal(1.0 + torch.exp(-x))
    if name == "sigmoid":
        return lambda x: torch.reciprocal(1.0 + torch.exp(-x))
    if name.startswith("smooth_leaky_relu"):
        a = _slrelu_alpha(name)

        def f(x):
            sig = torch.reciprocal(1.0 + torch.exp(-x))
            return ((1 + a) / 2.0) * x + ((1 - a) / 2.0) * x * (2.0 * sig - 1.0)
        return f
    raise ValueError(f"unknown activation {name}")


def normalized_activation(name: str) -> Callable:
    """Activation scaled so its second moment under N(0,1) is 1."""
    factor, _ = _moment_and_parity(name)
    raw = _torch_act(name)
    return lambda x: raw(x) * factor


class Activation:
    """Per-block scalar activations (``None`` leaves a block as is)."""

    def __init__(self, irreps: Irreps, acts: Sequence[Optional[str]]):
        irreps = Irreps(irreps)
        if len(acts) == 1 and len(irreps) > 1:
            acts = list(acts) * len(irreps)
        if len(irreps) != len(acts):
            raise ValueError("need one activation (or None) per irreps block")
        self.irreps_in = irreps
        out = []
        for (mul, ir), act in zip(irreps, acts):
            if act is None:
                out.append((mul, ir))
                continue
            if ir.l != 0:
                raise ValueError("cannot apply scalar activation to l>0 block")
            _, p_act = _moment_and_parity(act)
            p_out = p_act if ir.p == -1 else ir.p
            if p_out == 0:
                raise ValueError(f"activation {act} on odd scalar violates parity")
            out.append((mul, Irrep(0, p_out)))
        self.irreps_out = Irreps(out)
        self._fns = tuple(normalized_activation(a) if a is not None else None for a in acts)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if len(self._fns) == 1 and self._fns[0] is not None:
            return self._fns[0](x)
        pieces, i = [], 0
        for (mul, ir), fn in zip(self.irreps_in, self._fns):
            blk = x[..., i : i + mul * ir.dim]
            pieces.append(fn(blk) if fn is not None else blk)
            i += mul * ir.dim
        return torch.cat(pieces, dim=-1) if len(pieces) > 1 else pieces[0]


def irreps2gate(irreps: Irreps):
    """Split into (scalars [0e], gates [one 0e per gated copy], gated [rest])."""
    irreps = Irreps(irreps)
    scalars = Irreps([mi for mi in irreps if mi.ir.is_scalar()]).simplify()
    gated = Irreps([mi for mi in irreps if not mi.ir.is_scalar()]).simplify()
    if gated.dim > 0:
        gates = Irreps([(mi.mul, Irrep(0, 1)) for mi in gated]).simplify()
    else:
        gates = Irreps("")
    return scalars, gates, gated


class Gate:
    """Equivariant gated nonlinearity (SiLU scalars, sigmoid gates)."""

    def __init__(self, irreps_scalars, irreps_gates, irreps_gated):
        self.irreps_scalars = Irreps(irreps_scalars)
        self.irreps_gates = Irreps(irreps_gates)
        self.irreps_gated = Irreps(irreps_gated)
        if self.irreps_gates.num_irreps != self.irreps_gated.num_irreps:
            raise ValueError("one gate scalar needed per gated irrep copy")
        self.irreps_in = (self.irreps_scalars + self.irreps_gates
                          + self.irreps_gated).simplify()
        self.act_scalars = (Activation(self.irreps_scalars, ["silu"])
                            if self.irreps_scalars.dim > 0 else None)
        self.act_gates = (Activation(self.irreps_gates, ["sigmoid"])
                          if self.irreps_gates.dim > 0 else None)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ds = self.irreps_scalars.dim
        dg = self.irreps_gates.dim
        scalars = x[..., :ds]
        if self.act_scalars is not None:
            scalars = self.act_scalars(scalars)
        if dg == 0:
            return scalars
        gates = self.act_gates(x[..., ds : ds + dg])
        gated = elementwise_multiply(self.irreps_gated, x[..., ds + dg :], gates)
        return torch.cat([scalars, gated], dim=-1)


def gate_for(irreps_out: Irreps):
    """The SiLU/sigmoid gate (or a plain SiLU when nothing is gated) for a
    target output irreps; returns (callable, irreps_in)."""
    scalars, gates, gated = irreps2gate(irreps_out)
    if gated.num_irreps == 0:
        return Activation(Irreps(irreps_out), ["silu"]), Irreps(irreps_out)
    g = Gate(scalars, gates, gated)
    return g, g.irreps_in
