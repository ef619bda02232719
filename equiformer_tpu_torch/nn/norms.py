"""Equivariant layer norm (the ``layer`` variant of the JAX package's norms).

Per node: scalar blocks are mean-centred over their copies; each block is
divided by the RMS over (components, copies); an affine weight per irrep copy
and a bias on even scalars follow.  Statistics run in at least fp32 and the
output returns in the input dtype.  Parameters ``affine_weight`` /
``affine_bias`` match the flax ones.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.irreps import Irreps


class EquivariantLayerNorm(nn.Module):
    def __init__(self, irreps, eps: float = 1e-5):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.eps = eps
        num_scalar = sum(mi.mul for mi in self.irreps if mi.ir.is_scalar())
        self.affine_weight = nn.Parameter(torch.empty(self.irreps.num_irreps))
        self.affine_bias = nn.Parameter(torch.empty(num_scalar))

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.affine_weight.fill_(1.0)
            self.affine_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.to(torch.promote_types(in_dtype, torch.float32))
        weight = self.affine_weight.to(x.dtype)
        bias = self.affine_bias.to(x.dtype)
        iw = ib = i = 0
        pieces = []
        for mul, ir in self.irreps:
            field = x[..., i : i + mul * ir.dim].reshape(x.shape[:-1] + (ir.dim, mul))
            i += mul * ir.dim
            if ir.is_scalar():
                field = field - torch.mean(field, dim=-1, keepdim=True)
            fn = torch.mean(field ** 2, dim=-2)  # component normalization
            fn = torch.mean(fn, dim=-1, keepdim=True)
            fn = (fn + self.eps) ** -0.5
            fn = fn * weight[iw : iw + mul]
            iw += mul
            field = field * fn[..., None, :]
            if ir.is_scalar():
                field = field + bias[ib : ib + mul]
                ib += mul
            pieces.append(field.reshape(field.shape[:-2] + (mul * ir.dim,)))
        return torch.cat(pieces, dim=-1).to(in_dtype)
