"""Modules around the core tensor products.

Counterparts of ``equiformer_tpu.nn.tp_modules``:

* ``FCTP`` — fully-connected TP with internal weights and scalar bias;
* ``FCTPSwishGate`` — FCTP into a SiLU/sigmoid Gate;
* ``DTPLayer`` — the depthwise TP with internal (shared) or external
  per-edge weights, on the T / R primitives of ``kernels/dtp.py`` (K6-T
  forward; backward K6-T and K6-R, differentiable to any order, or one K6-FB
  launch with ``first_order_bwd``);
* ``SeparableFCTP`` — depthwise TP (per-edge radial weights, or internal
  shared ones) -> per-irrep linear heads -> optional gate.  By default
  (``fused_dtp_lin``, as in JAX) the TP and the heads run as one fused,
  differentiable op: with ``higher_order_grads`` (the JAX package's default,
  for force models) the op of ``kernels/dtp_lin_ho.py``, differentiable to
  any order (K1 forward; K5a backward: dx, dsh and dw; K5b / K5c: the single
  legs and the head weights' gradient of force training's grad-of-grad),
  without it ``kernels/dtp_lin.py`` (K1 forward, K2 backward: dx, dw and the
  head weights' gradient).  With ``fused_dtp_lin=False`` the TP is
  ``DTPLayer`` and each head an ``IrrepsLinear`` on its output, as JAX's
  ``SeparableFCTP.dtp_lin`` does when the fused op is off.  With
  ``radial_fold`` the radial MLP's final linear layer runs inside the fused
  op's kernels (K7): ``dtp_weights`` returns ``(h, [Wr; offset])`` and
  ``w = h @ Wr + offset`` never reaches device memory.  The CUDA kernels
  run on the card, their plain versions on the CPU;
* ``NodeEmbedding`` / ``EdgeDegreeEmbedding``.

Submodule and parameter names follow the flax scopes, so weight conversion
from the JAX package is mechanical (``utils/convert_jax.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.irreps import Irreps
from ..core.tensor_product import TensorProduct, depthwise_tp, fully_connected_tp
from ..graph.segment import active_edge_bound, scaled_scatter_sum
from ..kernels.dtp import TermList, first_order_dtp, t_apply
from ..kernels.dtp_lin import DTPLinPlan, dtp_lin
from ..kernels.dtp_lin_ho import dtp_lin_ho
from .activation import Activation, Gate, gate_for, irreps2gate
from .linear import IrrepsLinear
from .radial import RadialProfile


def _init_tp_weight(p: nn.Parameter, tp: TensorProduct, gen: torch.Generator) -> None:
    std = torch.as_tensor(tp.weight_std_flat(), dtype=torch.float32)
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=gen) * std)


def _add_scalar_bias(x: torch.Tensor, bias: torch.Tensor, irreps: Irreps) -> torch.Tensor:
    pieces = []
    i = bi = 0
    for mul, ir in irreps:
        blk = x[..., i : i + mul * ir.dim]
        if ir.is_scalar():
            blk = blk + bias[bi : bi + mul].to(x.dtype)
            bi += mul
        pieces.append(blk)
        i += mul * ir.dim
    return torch.cat(pieces, dim=-1)


def _fused_op(fused_dtp_lin: bool, higher_order_grads: bool):
    """The fused DTP + linear op of a call site, or None on the unfused route."""
    if not fused_dtp_lin:
        return None
    return dtp_lin_ho if higher_order_grads else dtp_lin


def _radial_fold(fc_neurons, internal_weights: bool, fused_dtp_lin: bool,
                 higher_order_grads: bool, radial_fold: bool, radial_fold_ho: bool):
    """The radial MLP's last hidden width when the site folds the MLP's final
    linear layer into the fused op, else None: JAX's rule
    (``_make_fused_plan``): only on the fused route, only at external-weight
    sites with a radial MLP, and on the force route only with both switches."""
    if not (fused_dtp_lin and radial_fold and fc_neurons is not None and not internal_weights):
        return None
    if higher_order_grads and not radial_fold_ho:
        return None
    return fc_neurons[-1]


class FCTP(nn.Module):
    """Fully-connected tensor product with internal weights and scalar bias."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out):
        super().__init__()
        self.tp = fully_connected_tp(Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out))
        self.w = nn.Parameter(torch.empty(self.tp.weight_numel))
        num_scalar = sum(mi.mul for mi in self.tp.irreps_out if mi.ir.is_scalar())
        self.use_bias = num_scalar > 0
        if self.use_bias:
            self.bias = nn.Parameter(torch.empty(num_scalar))

    def init_(self, gen: torch.Generator) -> None:
        _init_tp_weight(self.w, self.tp, gen)
        if self.use_bias:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x1, x2):
        out = self.tp.apply(x1, x2, self.w.to(x1.dtype))
        if self.use_bias:
            out = _add_scalar_bias(out, self.bias, self.tp.irreps_out)
        return out


class FCTPSwishGate(nn.Module):
    """FCTP whose output feeds a SiLU/sigmoid Gate (output irreps = target)."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out):
        super().__init__()
        self.gate, irreps_gate_in = gate_for(Irreps(irreps_out))
        self.fctp = FCTP(irreps_in1, irreps_in2, irreps_gate_in)

    def forward(self, x1, x2):
        return self.gate(self.fctp(x1, x2))


class DTPLayer(nn.Module):
    """Depthwise TP with internal weights (``w``, shared by the edges) or
    externally supplied flat per-edge weights; no bias.  ``forward`` is T of
    ``kernels/dtp.py`` on the plan's terms (JAX's ``PallasDTP``): internal
    weights as they are, external ones with their fan-in rescale folded into
    the coefficients (``scale_weights=True``).  ``first_order_bwd`` takes
    the backward in one K6-FB launch (JAX's ``EQUIFORMER_TPU_FUSED_BWD=1``;
    first order only).  On the fused route the TP runs inside the fused op
    of ``SeparableFCTP`` and only the plan and ``w`` are read."""

    def __init__(self, irreps_node, irreps_edge, irreps_target, internal_weights: bool = False,
                 first_order_bwd: bool = False):
        super().__init__()
        self.plan = depthwise_tp(Irreps(irreps_node), Irreps(irreps_edge), Irreps(irreps_target))
        self.internal_weights = internal_weights
        self.first_order_bwd = first_order_bwd
        self.terms = TermList.for_plan(self.plan, fold_rescale=not internal_weights)
        if internal_weights:
            self.w = nn.Parameter(torch.empty(self.plan.weight_numel))

    def init_(self, gen: torch.Generator) -> None:
        if self.internal_weights:
            _init_tp_weight(self.w, self.plan, gen)

    @property
    def irreps_out(self) -> Irreps:
        return self.plan.irreps_out

    def forward(self, node_on_edge, edge_attr, weights=None):
        """[E, irreps_out.dim].  ``node_on_edge`` [E, d] or one row broadcast
        over the edges (the edge-degree embedding's constant feature),
        ``edge_attr`` [E, d_sh], ``weights`` [E, weight_numel] (external
        weights) or None (internal)."""
        if self.internal_weights:
            w, shared_w = self.w.to(node_on_edge.dtype)[None], True
        else:
            w, shared_w = weights, False
        shared_x = node_on_edge.shape[0] == 1 and edge_attr.shape[0] != 1
        op = first_order_dtp if self.first_order_bwd else t_apply
        return op(self.terms, node_on_edge, edge_attr, w, shared_x, shared_w)


class SeparableFCTP(nn.Module):
    """Depthwise TP -> per-irrep linear heads -> optional gate.

    ``extra_head_irreps`` declares more linear heads that read the same
    unsimplified TP output (the attention's ``sep_alpha``); they join the
    fused op's product, and ``dtp_lin`` is given the bound head modules.
    ``fused_dtp_lin=False`` (JAX's ``EQUIFORMER_TPU_FUSED_DTPLIN=0``, and
    for force models also ``EQUIFORMER_TPU_FUSED_HO=0``) runs the TP unfused
    (``DTPLayer``) and the heads after it; ``dtp_first_order_bwd`` (JAX's
    ``EQUIFORMER_TPU_FUSED_BWD=1``) then takes the TP's backward in one
    K6-FB launch, only without ``higher_order_grads``.  ``radial_fold``
    (JAX's ``EQUIFORMER_TPU_FOLD_RADIAL=1``) folds the radial MLP's final
    linear layer into the fused op at an external-weight site (K7-F and
    K7-B); with ``higher_order_grads`` it also needs ``radial_fold_ho``
    (``EQUIFORMER_TPU_FOLD_RADIAL_HO=1``: K7-F and K7-B3, force evaluation
    only).  Both default off, as in JAX.  The parameters are the same on
    every route.
    """

    def __init__(self, irreps_node, irreps_edge, irreps_out,
                 fc_neurons: Optional[Tuple[int, ...]] = None,
                 use_activation: bool = False, internal_weights: bool = False,
                 extra_head_irreps: Sequence = (), higher_order_grads: bool = True,
                 fused_dtp_lin: bool = True, dtp_first_order_bwd: bool = False,
                 radial_fold: bool = False, radial_fold_ho: bool = False):
        super().__init__()
        irreps_out = Irreps(irreps_out)
        self.fused_op = _fused_op(fused_dtp_lin, higher_order_grads)
        self.internal_weights = internal_weights
        self.use_activation = use_activation
        self.dtp = DTPLayer(irreps_node, irreps_edge, irreps_out,
                            internal_weights=internal_weights,
                            first_order_bwd=dtp_first_order_bwd and not higher_order_grads)
        tp = self.dtp.plan
        self.fc_neurons = fc_neurons
        if fc_neurons is not None:
            # fc_neurons[0] is the input width; layers fc_neurons[1:] + weights
            self.dtp_rad = RadialProfile(fc_neurons[0],
                                         tuple(fc_neurons[1:]) + (tp.weight_numel,))
        scalars, gates, gated = irreps2gate(irreps_out)
        irreps_lin_output = (scalars + gates + gated).simplify() if use_activation else irreps_out
        self.lin = IrrepsLinear(tp.irreps_out, irreps_lin_output)
        self.n_extra_heads = len(extra_head_irreps)
        self.plan = None
        if self.fused_op is not None:
            self.plan = DTPLinPlan(
                tp, [irreps_lin_output] + [Irreps(h) for h in extra_head_irreps],
                shared_weights=internal_weights,
                radial_fold=_radial_fold(fc_neurons, internal_weights, fused_dtp_lin,
                                         higher_order_grads, radial_fold, radial_fold_ho),
            )
        self.gate = None
        if use_activation:
            self.gate = (Activation(irreps_out, ["silu"]) if gated.num_irreps == 0
                         else Gate(scalars, gates, gated))

    def dtp_lin(self, node_on_edge, edge_attr, weights, extra_heads=(), n_edges=None):
        """TP -> (lin, *extra heads), as one fused op on the fused route.
        Returns one tensor without extra heads, else the list of per-head
        outputs.  ``weights`` is what ``dtp_weights`` returns.  The unfused
        route computes every row (``n_edges`` is the fused kernels' tile
        skipping)."""
        heads = [self.lin] + list(extra_heads)
        if len(heads) != 1 + self.n_extra_heads:
            raise ValueError("extra_heads must match extra_head_irreps")
        if self.fused_op is None:
            z = self.dtp(node_on_edge, edge_attr, weights)
            outs = [h(z) for h in heads]
            return outs if extra_heads else outs[0]
        dtype = node_on_edge.dtype
        if self.internal_weights:
            weights = self.dtp.w.to(dtype)
        W = self.plan.pack_weights(
            [[None if w is None else w.to(dtype) for w in h.weight_list()] for h in heads])
        out = self.fused_op(self.plan, node_on_edge, edge_attr, weights, W, n_edges)
        outs = [h.add_bias(o) for h, o in zip(heads, self.plan.split_output(out))]
        return outs if extra_heads else outs[0]

    def dtp_weights(self, edge_scalars):
        """The per-edge TP weights [E, weight_numel], or on a radial-folded
        site the pair ``(h, [Wr; offset])`` that the fused op takes in their
        place (JAX's ``SeparableFCTP.dtp_weights``)."""
        if self.plan is not None and self.plan.radial_fold is not None:
            h, Wr, offset = self.dtp_rad(edge_scalars, fold_final=True)
            return h, self.plan.pack_radial(Wr, offset)
        return self.dtp_rad(edge_scalars)

    def forward(self, node_on_edge, edge_attr, edge_scalars=None, n_edges=None):
        w = None
        if self.fc_neurons is not None and edge_scalars is not None:
            w = self.dtp_weights(edge_scalars)
        out = self.dtp_lin(node_on_edge, edge_attr, w, n_edges=n_edges)
        if self.gate is not None:
            out = self.gate(out)
        return out


class NodeEmbedding(nn.Module):
    """One-hot atom type -> irreps embedding (weights scaled by sqrt(types)).
    Returns (embedding, onehot)."""

    def __init__(self, irreps_out, max_atom_type: int):
        super().__init__()
        self.max_atom_type = max_atom_type
        self.lin = IrrepsLinear(Irreps(f"{max_atom_type}x0e"), Irreps(irreps_out),
                                weight_init_scale=float(max_atom_type) ** 0.5)

    def forward(self, species: torch.Tensor, dtype: torch.dtype):
        onehot = nn.functional.one_hot(species, self.max_atom_type).to(dtype)
        return self.lin(onehot), onehot


class EdgeDegreeEmbedding(nn.Module):
    """Constant scalar -> linear -> DTP with the SH, weighted by a radial MLP
    -> linear -> scaled scatter onto destinations.  The DTP and ``proj`` are
    one fused op unless ``fused_dtp_lin=False`` (then ``dw`` and ``proj``,
    with ``dtp_first_order_bwd`` as in ``SeparableFCTP``); ``radial_fold``
    and ``radial_fold_ho`` fold ``rad``'s final linear layer into it as in
    ``SeparableFCTP``."""

    def __init__(self, irreps_out, irreps_edge, fc_neurons: Tuple[int, ...],
                 avg_degree: float, higher_order_grads: bool = True,
                 fused_dtp_lin: bool = True, dtp_first_order_bwd: bool = False,
                 radial_fold: bool = False, radial_fold_ho: bool = False):
        super().__init__()
        irreps_out = Irreps(irreps_out)
        self.avg_degree = avg_degree
        self.fused_op = _fused_op(fused_dtp_lin, higher_order_grads)
        self.exp = IrrepsLinear(Irreps("1x0e"), irreps_out)
        self.dw = DTPLayer(irreps_out, irreps_edge, irreps_out,
                           first_order_bwd=dtp_first_order_bwd and not higher_order_grads)
        tp = self.dw.plan
        self.rad = RadialProfile(fc_neurons[0], tuple(fc_neurons[1:]) + (tp.weight_numel,))
        self.proj = IrrepsLinear(tp.irreps_out, irreps_out)
        self.plan = None
        if self.fused_op is not None:
            self.plan = DTPLinPlan(tp, [irreps_out], radial_fold=_radial_fold(
                fc_neurons, False, fused_dtp_lin, higher_order_grads, radial_fold,
                radial_fold_ho))

    def forward(self, edge_attr, edge_scalars, edge_dst, edge_mask, num_nodes: int):
        # every node's expanded feature is the same linear image of the
        # constant 1, so the per-edge gather is a row broadcast (stride 0)
        E = edge_dst.shape[0]
        feat1 = self.exp(torch.ones((1, 1), dtype=edge_attr.dtype, device=edge_attr.device))
        if self.plan is not None and self.plan.radial_fold is not None:
            h, Wr, offset = self.rad(edge_scalars, fold_final=True)
            w = (h, self.plan.pack_radial(Wr, offset))
        else:
            w = self.rad(edge_scalars)
        if self.fused_op is None:
            edge_feat = self.proj(self.dw(feat1, edge_attr, w))
        else:
            dtype = edge_attr.dtype
            W = self.plan.pack_weights(
                [[None if w_ is None else w_.to(dtype) for w_ in self.proj.weight_list()]])
            out = self.fused_op(self.plan, feat1.expand(E, feat1.shape[-1]), edge_attr, w, W,
                                active_edge_bound(edge_mask))
            edge_feat = self.proj.add_bias(self.plan.split_output(out)[0])
        return scaled_scatter_sum(edge_feat, edge_dst, num_nodes, self.avg_degree,
                                  mask=edge_mask)
