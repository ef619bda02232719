"""O(3) tensor products over irreps features, in plain PyTorch.

Same plans and semantics as ``equiformer_tpu.core.tensor_product``:

* per-path coefficient sqrt(2*l_out+1) on the unit-Frobenius Wigner-3j
  ('component' irrep normalization, no path normalization);
* per-output-slice fan-in ``1/sqrt(fan_in)``: folded into the init stddev of
  internal weights, applied inside ``apply(..., scale_weights=True)`` to
  external (per-edge radial) weights;
* connection modes 'uvw' (fully connected) and 'uvu' (depthwise).

LAYOUT: features are component-major inside each (mul, ir) block, i.e. the
flat block is a [2l+1, mul] matrix.  The depthwise einsum path here is the
plain version the fused DTP+linear kernel (``kernels/dtp_lin.py``) is held to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cg import wigner_3j_component
from .irreps import Irrep, Irreps, MulIrrep


@dataclasses.dataclass(frozen=True)
class Instruction:
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # 'uvw' | 'uvu'
    has_weight: bool
    path_weight: float = 1.0

    def path_shape(self, irreps_in1: Irreps, irreps_in2: Irreps, irreps_out: Irreps):
        m1 = irreps_in1[self.i_in1].mul
        m2 = irreps_in2[self.i_in2].mul
        mo = irreps_out[self.i_out].mul
        if self.mode == "uvw":
            return (m1, m2, mo)
        if self.mode == "uvu":
            if mo != m1:
                raise ValueError("uvu requires mul_out == mul_in1")
            return (m1, m2)
        raise ValueError(f"unsupported connection mode {self.mode}")


def _fan_in(ins: Instruction, irreps_in1: Irreps, irreps_in2: Irreps) -> int:
    if ins.mode == "uvw":
        return irreps_in1[ins.i_in1].mul * irreps_in2[ins.i_in2].mul
    if ins.mode == "uvu":
        return irreps_in2[ins.i_in2].mul
    raise ValueError(ins.mode)


def split_blocks(x: torch.Tensor, irreps: Irreps) -> List[torch.Tensor]:
    """Flat [..., dim] -> per-block [..., 2l+1, mul] views (component-major)."""
    out = []
    i = 0
    for mul, ir in irreps:
        blk = x[..., i : i + mul * ir.dim]
        out.append(blk.reshape(blk.shape[:-1] + (ir.dim, mul)))
        i += mul * ir.dim
    return out


class TensorProduct:
    """Static tensor-product plan between two irreps inputs.

    Weights are one flat vector (shared) or [..., weight_numel] (per sample,
    e.g. per-edge radial weights), laid out per instruction in order.
    """

    def __init__(
        self,
        irreps_in1: Irreps,
        irreps_in2: Irreps,
        irreps_out: Irreps,
        instructions: Sequence[Tuple],
        rescale: bool = True,
    ):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)
        self.instructions: List[Instruction] = [
            ins if isinstance(ins, Instruction) else Instruction(*ins)
            for ins in instructions
        ]
        self.rescale = rescale

        fan_in: Dict[int, int] = {}
        for ins in self.instructions:
            fan_in[ins.i_out] = fan_in.get(ins.i_out, 0) + _fan_in(
                ins, self.irreps_in1, self.irreps_in2
            )
        self.slice_sqrt_k: Dict[int, float] = {
            i: (1.0 / math.sqrt(f) if rescale else 1.0) for i, f in fan_in.items()
        }

        self._offsets: List[int] = []
        self._shapes: List[Tuple[int, ...]] = []
        n = 0
        for ins in self.instructions:
            shape = ins.path_shape(self.irreps_in1, self.irreps_in2, self.irreps_out)
            self._offsets.append(n)
            self._shapes.append(shape)
            if ins.has_weight:
                n += int(np.prod(shape))
        self.weight_numel = n

        self._cg: List[np.ndarray] = []
        for ins in self.instructions:
            l1 = self.irreps_in1[ins.i_in1].ir.l
            l2 = self.irreps_in2[ins.i_in2].ir.l
            l3 = self.irreps_out[ins.i_out].ir.l
            self._cg.append(wigner_3j_component(l1, l2, l3) * ins.path_weight)
        self._cg_cache: Dict[Tuple[int, torch.dtype, torch.device], torch.Tensor] = {}

    def weight_std_flat(self) -> np.ndarray:
        """Per-element init stddev for internal weights (fan-in rescaled)."""
        std = np.ones((self.weight_numel,), dtype=np.float64)
        for ins, off, shape in zip(self.instructions, self._offsets, self._shapes):
            if ins.has_weight:
                std[off : off + int(np.prod(shape))] = self.slice_sqrt_k[ins.i_out]
        return std

    def _cg_tensor(self, idx: int, dtype, device) -> torch.Tensor:
        key = (idx, dtype, device)
        C = self._cg_cache.get(key)
        if C is None:
            C = torch.as_tensor(self._cg[idx], dtype=dtype, device=device)
            self._cg_cache[key] = C
        return C

    def apply(
        self,
        x1: torch.Tensor,
        x2: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        scale_weights: bool = False,
    ) -> torch.Tensor:
        """x1 [..., in1.dim], x2 [..., in2.dim], weights [weight_numel] or
        [..., weight_numel].  ``scale_weights=True`` applies the fan-in rescale
        to the supplied weights (raw radial-MLP outputs)."""
        dtype = x1.dtype
        b1 = split_blocks(x1, self.irreps_in1)
        b2 = split_blocks(x2, self.irreps_in2)
        contrib: Dict[int, List[torch.Tensor]] = {}
        for idx, ins in enumerate(self.instructions):
            C = self._cg_tensor(idx, dtype, x1.device)
            w = None
            if ins.has_weight:
                off, shape = self._offsets[idx], self._shapes[idx]
                w = weights[..., off : off + int(np.prod(shape))]
                w = w.reshape(w.shape[:-1] + shape)
                if scale_weights:
                    w = w * self.slice_sqrt_k[ins.i_out]
            res = self._path(ins, b1[ins.i_in1], b2[ins.i_in2], C, w, self._cg[idx])
            contrib.setdefault(ins.i_out, []).append(res)

        lead = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
        pieces = []
        for i_out, (mul, ir) in enumerate(self.irreps_out):
            if i_out in contrib:
                terms = contrib[i_out]
                acc = terms[0]
                for t in terms[1:]:
                    acc = acc + t
                pieces.append(acc.reshape(acc.shape[:-2] + (mul * ir.dim,)))
            else:
                pieces.append(x1.new_zeros(lead + (mul * ir.dim,)))
        return torch.cat(pieces, dim=-1)

    @staticmethod
    def _path(ins, u, v, C, w, cg_np):
        """One instruction; u [..., d1, mul1], v [..., d2, mul2] -> [..., d3, mul_out]."""
        d1, d2, d3 = C.shape
        if ins.mode == "uvw":
            if d2 == 1 and d1 == d3:
                # l (x) 0 -> l: the component-normalized CG is c * identity,
                # so the path is a per-irrep matmul
                scal = v[..., 0, :]
                c = float(cg_np[0, 0, 0])
                if v.shape[-1] == 1:
                    W = w[..., :, 0, :]
                    eq = "...iu,...uw->...iw" if w.dim() > 3 else "...iu,uw->...iw"
                    return torch.einsum(eq, u, W) * (c * scal)[..., None, :]
                tmp = torch.einsum("...iu,...v->...iuv", u, scal) * c
                eq = "...iuv,...uvw->...iw" if w.dim() > 3 else "...iuv,uvw->...iw"
                return torch.einsum(eq, tmp, w)
            tmp = torch.einsum("...iu,...jv,ijk->...kuv", u, v, C)
            eq = "...kuv,...uvw->...kw" if w.dim() > 3 else "...kuv,uvw->...kw"
            return torch.einsum(eq, tmp, w)
        if ins.mode == "uvu":
            if v.shape[-1] == 1:
                # depthwise with a single-copy second input (the SH): per
                # sample M = C . v, then [d3, d1] x [d1, mul]
                M = torch.einsum("...j,ijk->...ki", v[..., :, 0], C)
                tmp = torch.einsum("...ki,...iu->...ku", M, u)
                if w is None:
                    return tmp
                return tmp * w[..., None, :, 0]
            tmp = torch.einsum("...iu,...jv,ijk->...kuv", u, v, C)
            if w is None:
                return torch.sum(tmp, dim=-1)
            eq = "...kuv,...uv->...ku" if w.dim() > 2 else "...kuv,uv->...ku"
            return torch.einsum(eq, tmp, w)
        raise ValueError(ins.mode)


def fully_connected_instructions(
    irreps_in1: Irreps, irreps_in2: Irreps, irreps_out: Irreps
) -> List[Instruction]:
    """All allowed uvw paths."""
    return [
        Instruction(i1, i2, io, "uvw", True)
        for i1, (_, ir1) in enumerate(irreps_in1)
        for i2, (_, ir2) in enumerate(irreps_in2)
        for io, (_, iro) in enumerate(irreps_out)
        if iro in ir1 * ir2
    ]


def fully_connected_tp(
    irreps_in1: Irreps, irreps_in2: Irreps, irreps_out: Irreps, rescale: bool = True
) -> TensorProduct:
    irreps_in1, irreps_in2, irreps_out = (
        Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out)
    )
    return TensorProduct(
        irreps_in1, irreps_in2, irreps_out,
        fully_connected_instructions(irreps_in1, irreps_in2, irreps_out),
        rescale=rescale,
    )


def depthwise_tp(
    irreps_node: Irreps, irreps_edge: Irreps, irreps_target: Irreps, rescale: bool = True
) -> TensorProduct:
    """Depthwise ('uvu') TP whose output irreps are ir_node x ir_edge filtered
    against ``irreps_target`` (0e always kept), sorted even-first."""
    irreps_node = Irreps(irreps_node)
    irreps_edge = Irreps(irreps_edge)
    irreps_target = Irreps(irreps_target)
    out_blocks: List[MulIrrep] = []
    instructions: List[Tuple] = []
    for i, (mul, ir_in) in enumerate(irreps_node):
        for j, (_, ir_edge) in enumerate(irreps_edge):
            for ir_out in ir_in * ir_edge:
                if ir_out in irreps_target or ir_out == Irrep(0, 1):
                    instructions.append((i, j, len(out_blocks), "uvu", True))
                    out_blocks.append(MulIrrep(mul, ir_out))
    irreps_out, p, _ = Irreps(out_blocks).sort_even_first()
    instructions = [
        Instruction(i1, i2, p[io], mode, train)
        for i1, i2, io, mode, train in instructions
    ]
    return TensorProduct(irreps_node, irreps_edge, irreps_out, instructions, rescale)


def elementwise_multiply(irreps: Irreps, x: torch.Tensor, scalars: torch.Tensor):
    """Features times one even scalar per irrep copy (l (x) 0e -> l has CG 1)."""
    pieces = []
    i = s = 0
    for mul, ir in irreps:
        blk = x[..., i : i + mul * ir.dim].reshape(x.shape[:-1] + (ir.dim, mul))
        g = scalars[..., s : s + mul]
        pieces.append((blk * g[..., None, :]).reshape(x.shape[:-1] + (mul * ir.dim,)))
        i += mul * ir.dim
        s += mul
    return torch.cat(pieces, dim=-1)
