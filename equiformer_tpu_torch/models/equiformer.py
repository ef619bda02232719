"""Equiformer (QM9 and MD17 families), training and inference.

Counterpart of ``equiformer_tpu.models.equiformer``:

* ``GraphAttention`` — MLP attention with nonlinear depthwise-TP messages;
* ``FeedForwardNetwork`` — two FCTPs against the constant node attr with a
  gate in between;
* ``TransBlock`` — pre-norm residual block;
* ``GraphAttentionTransformer`` — radius graph, SH + radial basis
  (``basis_type``: gaussian, bessel or exp), embeddings, N blocks, norm,
  scalar head and scaled scatter per graph.

``nodes_per_graph`` picks the batch layout, as in JAX: 0 (the default) the
packed one of ``collate`` / ``GraphLoader`` with its [N, N] radius graph,
> 0 the fixed-slot one of ``collate_dense`` / ``GraphLoader(dense_slots=)``
with its per-graph radius graph (``graph.radius_graph.build_edges``).  The
parameters do not depend on the layout.

``higher_order_grads`` (default True, as in JAX) routes the fused DTPs to
the op that is differentiable to any order (``kernels/dtp_lin_ho.py``) and
the attention tail to the composed segment softmax + sum: what a force
evaluation (``models/md17_models.py``) differentiates through once and
force training (``train/engine.py::make_md17_steps``) twice.  The QM9
entrypoints set it False: K2 and the fused attention combine, which compute
the parameter gradients of first-order training.  ``fused_dtp_lin=False``
takes every DTP call site off the fused DTP + linear op onto the unfused
route (the T / R primitives of ``kernels/dtp.py``: JAX's
``EQUIFORMER_TPU_FUSED_DTPLIN=0``, for force models also
``EQUIFORMER_TPU_FUSED_HO=0``), and ``dtp_first_order_bwd`` there gives
each DTP the one-launch first-order backward (``EQUIFORMER_TPU_FUSED_BWD=1``,
without ``higher_order_grads`` only).  ``radial_fold`` (JAX's
``EQUIFORMER_TPU_FOLD_RADIAL=1``) folds the radial MLPs' final linear layers
of the per-edge-weight sites (the 6 ``sep_act`` and the edge degree) into the
fused op's kernels (K7); force models fold only with ``radial_fold_ho`` too
(``EQUIFORMER_TPU_FOLD_RADIAL_HO=1``), and then run force evaluation and
force training on the folded leg kernels.  ``kron_g`` (JAX's
``EQUIFORMER_TPU_KRON_G=1``) takes all 13 fused DTP sites of a first-order
model onto the kron-basis op (K8-F / K8-B); it is ignored with
``higher_order_grads`` or ``fused_dtp_lin=False`` and overrides
``radial_fold`` with a warning.  The parameters are the same on every route.

``module.training`` plays the role of JAX's ``deterministic=False``: alpha
dropout on the attention weights, and the equivariant dropouts and drop path
where their rates are nonzero (the QM9 entrypoints set only alpha dropout).
Their randomness comes in explicitly as ``rng`` (``nn/dropout.py``).
``irreps_pre_attn`` (``GraphAttention``, ``TransBlock``,
``GraphAttentionTransformer``) maps the attention's input to those irreps
before its two DTPs (``merge_src`` / ``merge_dst``), as the DeNS model
(``models/dens.py``) does; None keeps the input irreps.

``remat`` (JAX's ``nn.remat(TransBlock)``, default False; both CLIs set it)
runs each block under ``torch.utils.checkpoint`` (non-reentrant, the form
that ``torch.autograd.grad`` and a double backward go through): the backward
recomputes the block's forward, kernels included, instead of keeping its
activations.  The block's dropout masks go through ``nn.dropout.MaskReplay``,
so the recompute reuses the forward's masks and the generator (or the
iterator of injected masks) advances as it does without remat.  Remat
applies in training mode only: an eval-mode force evaluation reads detached
copies of the parameters (``md17_models.energy_and_forces``), which a
recompute in the backward would not see, and keeps its activations.
``task_mean`` and ``task_std`` are kept on the model and unused by its
forward, as in JAX; ``atomref`` adds the per-graph sum of
``atomref[species]`` over the real atoms to the prediction.
``use_attn_head`` (the MD17 attention-head variant) replaces the two-linear
head by a ``GraphAttention`` from the feature to ``1x0e``, ``attn_head``,
with the blocks' heads, ``irreps_pre_attn``, dropouts and route.  Batched
radial, the linear-message path, dot-product attention and the other norms
are not ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.irreps import Irreps
from ..core.spherical import spherical_harmonics_for_irreps
from ..graph.batching import GraphsTuple
from ..graph.radius_graph import EdgeList, build_edges, edge_vectors
from ..graph.segment import active_edge_bound, gather_add, scaled_scatter_sum, segment_sum
from ..nn.activation import Activation, normalized_activation
from ..nn.attention_utils import heads2vec, heads_irreps, softmax_dropout_combine, vec2heads
from ..nn.dropout import EquivariantDropout, GraphDropPath, MaskReplay
from ..nn.linear import IrrepsLinear, init_parameters
from ..nn.norms import EquivariantLayerNorm
from ..nn.radial import make_rbf
from ..nn.tp_modules import (
    FCTP,
    EdgeDegreeEmbedding,
    FCTPSwishGate,
    NodeEmbedding,
    SeparableFCTP,
)

# QM9 graph statistics at r = 5 A (same constants as the JAX package)
_AVG_NUM_NODES = 18.03065905448718
_AVG_DEGREE = 15.57930850982666


class GraphAttention(nn.Module):
    def __init__(self, irreps_node_input, irreps_edge_attr, irreps_node_output,
                 fc_neurons: Tuple[int, ...], irreps_head, num_heads: int,
                 alpha_drop: float = 0.1, proj_drop: float = 0.1,
                 higher_order_grads: bool = True, fused_dtp_lin: bool = True,
                 dtp_first_order_bwd: bool = False, radial_fold: bool = False,
                 radial_fold_ho: bool = False, kron_g: bool = False, irreps_pre_attn=None):
        super().__init__()
        self.alpha_drop = alpha_drop
        self.higher_order_grads = higher_order_grads
        irreps_in = Irreps(irreps_node_input)
        pre = Irreps(irreps_pre_attn) if irreps_pre_attn else irreps_in
        self.irreps_head = Irreps(irreps_head)
        self.num_heads = H = num_heads
        self.merge_src = IrrepsLinear(irreps_in, pre, use_bias=True)
        self.merge_dst = IrrepsLinear(irreps_in, pre, use_bias=False)

        irreps_attn_heads = heads_irreps(self.irreps_head, H)
        mul_alpha = irreps_attn_heads.count("0e")
        self.mul_alpha_head = mul_alpha // H
        irreps_alpha = Irreps(f"{mul_alpha}x0e")
        sh = Irreps(irreps_edge_attr)
        route = dict(higher_order_grads=higher_order_grads, fused_dtp_lin=fused_dtp_lin,
                     dtp_first_order_bwd=dtp_first_order_bwd, radial_fold=radial_fold,
                     radial_fold_ho=radial_fold_ho, kron_g=kron_g)
        self.sep_act = SeparableFCTP(pre, sh, pre, fc_neurons=fc_neurons,
                                     use_activation=True, internal_weights=False,
                                     extra_head_irreps=(irreps_alpha,), **route)
        self.sep_alpha = IrrepsLinear(self.sep_act.dtp.irreps_out, irreps_alpha)
        self.sep_value = SeparableFCTP(pre, sh, irreps_attn_heads, fc_neurons=None,
                                       use_activation=False, internal_weights=True, **route)
        self.alpha_act = normalized_activation("smooth_leaky_relu:0.2")
        self.alpha_dot = nn.Parameter(torch.empty(H, self.mul_alpha_head))
        self.proj = IrrepsLinear(irreps_attn_heads, Irreps(irreps_node_output))
        self.proj_dropout = (EquivariantDropout(irreps_node_output, proj_drop)
                             if proj_drop != 0.0 else None)

    def init_(self, gen: torch.Generator) -> None:
        bound = math.sqrt(6.0 / sum(self.alpha_dot.shape))  # glorot on [H, C]
        with torch.no_grad():
            self.alpha_dot.copy_(torch.rand(self.alpha_dot.shape, generator=gen) * 2 * bound - bound)

    def forward(self, node_input, edges: EdgeList, edge_attr, edge_scalars, n_edges, rng=None):
        num_nodes = node_input.shape[0]
        H = self.num_heads
        message = gather_add(self.merge_src(node_input), self.merge_dst(node_input),
                             edges.src, edges.dst, num_nodes, rev=edges.rev,
                             src_plan=edges.src_plan)
        w = self.sep_act.dtp_weights(edge_scalars)
        # one fused TP evaluates both heads on the unsimplified message: the
        # gate input and the attention scalars
        value, alpha = self.sep_act.dtp_lin(message, edge_attr, w,
                                            extra_heads=(self.sep_alpha,), n_edges=n_edges)
        alpha = vec2heads(Irreps(f"{self.mul_alpha_head}x0e"), H, alpha)  # [E, H, mah]
        value = self.sep_act.gate(value)
        value = self.sep_value(value, edge_attr, n_edges=n_edges)
        value = vec2heads(self.irreps_head, H, value)  # [E, H, head_dim]
        alpha = self.alpha_act(alpha)
        alpha = torch.einsum("ehk,hk->eh", alpha, self.alpha_dot.to(alpha.dtype))
        attn = softmax_dropout_combine(alpha, value, edges.dst, edges.mask, num_nodes,
                                       self.alpha_drop, self.training, rng,
                                       self.higher_order_grads)
        out = self.proj(heads2vec(self.irreps_head, attn))
        if self.proj_dropout is not None:
            out = self.proj_dropout(out, rng)
        return out


class FeedForwardNetwork(nn.Module):
    def __init__(self, irreps_node_input, irreps_node_attr, irreps_node_output,
                 irreps_mlp_mid=None, proj_drop: float = 0.1):
        super().__init__()
        mid = Irreps(irreps_mlp_mid) if irreps_mlp_mid else Irreps(irreps_node_input)
        self.fctp_1 = FCTPSwishGate(irreps_node_input, irreps_node_attr, mid)
        self.fctp_2 = FCTP(mid, irreps_node_attr, irreps_node_output)
        self.proj_dropout = (EquivariantDropout(irreps_node_output, proj_drop)
                             if proj_drop != 0.0 else None)

    def forward(self, node_input, node_attr, rng=None):
        x = self.fctp_2(self.fctp_1(node_input, node_attr), node_attr)
        if self.proj_dropout is not None:
            x = self.proj_dropout(x, rng)
        return x


class TransBlock(nn.Module):
    """Pre-norm residual block with MLP attention."""

    def __init__(self, irreps_node_input, irreps_node_attr, irreps_edge_attr,
                 irreps_node_output, fc_neurons, irreps_head, num_heads: int,
                 irreps_mlp_mid=None, alpha_drop: float = 0.1, proj_drop: float = 0.1,
                 drop_path_rate: float = 0.0, higher_order_grads: bool = True,
                 fused_dtp_lin: bool = True, dtp_first_order_bwd: bool = False,
                 radial_fold: bool = False, radial_fold_ho: bool = False, kron_g: bool = False,
                 irreps_pre_attn=None):
        super().__init__()
        irreps_in = Irreps(irreps_node_input)
        irreps_out = Irreps(irreps_node_output)
        self.norm_1 = EquivariantLayerNorm(irreps_in)
        self.ga = GraphAttention(irreps_in, irreps_edge_attr, irreps_in, fc_neurons,
                                 irreps_head, num_heads, alpha_drop, proj_drop,
                                 higher_order_grads, fused_dtp_lin, dtp_first_order_bwd,
                                 radial_fold, radial_fold_ho, kron_g, irreps_pre_attn)
        self.norm_2 = EquivariantLayerNorm(irreps_in)
        self.ffn = FeedForwardNetwork(irreps_in, irreps_node_attr, irreps_out, irreps_mlp_mid,
                                      proj_drop)
        self.ffn_shortcut = (FCTP(irreps_in, irreps_node_attr, irreps_out)
                             if irreps_in != irreps_out else None)
        self.drop_path_1 = self.drop_path_2 = None
        if drop_path_rate > 0.0:
            self.drop_path_1 = GraphDropPath(drop_path_rate)
            self.drop_path_2 = GraphDropPath(drop_path_rate)

    def forward(self, node_input, node_attr, edges, edge_attr, edge_scalars, n_edges,
                batch=None, num_graphs: int = 0, rng=None):
        x = self.ga(self.norm_1(node_input), edges, edge_attr, edge_scalars, n_edges, rng)
        if self.drop_path_1 is not None:
            x = self.drop_path_1(x, batch, num_graphs, rng)
        node_output = node_input + x
        x = self.ffn(self.norm_2(node_output), node_attr, rng)
        if self.ffn_shortcut is not None:
            node_output = self.ffn_shortcut(node_output, node_attr)
        if self.drop_path_2 is not None:
            x = self.drop_path_2(x, batch, num_graphs, rng)
        return node_output + x


class GraphAttentionTransformer(nn.Module):
    """Scalar-property Equiformer with nonlinear messages and layer norms;
    the options keep the JAX package's names and defaults.  The node
    attribute is the constant ``1x0e``.  In training mode ``forward`` needs
    ``rng`` when a dropout rate is nonzero."""

    def __init__(
        self,
        irreps_node_embedding="128x0e+64x1e+32x2e",
        num_layers: int = 6,
        irreps_sh="1x0e+1x1e+1x2e",
        max_radius: float = 5.0,
        number_of_basis: int = 128,
        basis_type: str = "gaussian",
        fc_neurons: Tuple[int, ...] = (64, 64),
        irreps_feature="512x0e",
        irreps_head="32x0e+16x1e+8x2e",
        num_heads: int = 4,
        irreps_mlp_mid="128x0e+64x1e+32x2e",
        alpha_drop: float = 0.2,
        proj_drop: float = 0.0,
        out_drop: float = 0.0,
        drop_path_rate: float = 0.0,
        max_atom_type: int = 5,
        avg_num_nodes: float = _AVG_NUM_NODES,
        avg_degree: float = _AVG_DEGREE,
        max_edges: int = 8192,
        nodes_per_graph: int = 0,
        compute_dtype: Optional[str] = None,
        higher_order_grads: bool = True,
        fused_dtp_lin: bool = True,
        dtp_first_order_bwd: bool = False,
        radial_fold: bool = False,
        radial_fold_ho: bool = False,
        kron_g: bool = False,
        irreps_pre_attn=None,
        use_attn_head: bool = False,
        remat: bool = False,
        task_mean: float = 0.0,
        task_std: float = 1.0,
        atomref: Optional[Sequence[float]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.irreps_sh = Irreps(irreps_sh)
        self.remat = remat
        self.task_mean, self.task_std = task_mean, task_std
        self.atomref = None if atomref is None else tuple(float(a) for a in atomref)
        self.max_radius = max_radius
        self.max_edges = max_edges
        self.nodes_per_graph = nodes_per_graph
        self.avg_num_nodes = avg_num_nodes
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        emb = Irreps(irreps_node_embedding)
        feat = Irreps(irreps_feature)
        fc = (number_of_basis,) + tuple(fc_neurons)

        self.rbf = make_rbf(basis_type, number_of_basis, max_radius)
        self.atom_embed = NodeEmbedding(emb, max_atom_type)
        route = (higher_order_grads, fused_dtp_lin, dtp_first_order_bwd, radial_fold,
                 radial_fold_ho, kron_g)
        self.edge_deg_embed = EdgeDegreeEmbedding(emb, self.irreps_sh, fc, avg_degree, *route)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransBlock(
                emb, "1x0e", self.irreps_sh, feat if i == num_layers - 1 else emb, fc,
                irreps_head, num_heads, irreps_mlp_mid, alpha_drop, proj_drop, drop_path_rate,
                *route, irreps_pre_attn))
        self.num_layers = num_layers
        self.norm = EquivariantLayerNorm(feat)
        self.out_dropout = EquivariantDropout(feat, out_drop) if out_drop != 0.0 else None
        self.use_attn_head = use_attn_head
        if use_attn_head:
            self.attn_head = GraphAttention(feat, self.irreps_sh, "1x0e", fc, irreps_head,
                                            num_heads, alpha_drop, proj_drop, *route,
                                            irreps_pre_attn)
        else:
            self.head_lin1 = IrrepsLinear(feat, feat)
            self.head_act = Activation(feat, ["silu"])
            self.head_lin2 = IrrepsLinear(feat, Irreps("1x0e"))
        init_parameters(self, seed)

    def forward(self, graphs: GraphsTuple, rng=None) -> torch.Tensor:
        """Per-graph predictions [G].  ``rng``: a ``torch.Generator`` on the
        batch's device (or an iterator of injected keep masks) for the
        dropout sites in training mode."""
        pos = graphs.pos
        G = graphs.graph_mask.shape[0]
        N = pos.shape[0]
        edges = build_edges(pos, graphs.batch, graphs.node_mask, G, self.max_radius,
                            self.max_edges, self.nodes_per_graph)
        edge_vec, edge_len = edge_vectors(pos, edges)
        edge_sh = spherical_harmonics_for_irreps(self.irreps_sh, edge_vec)
        # geometry runs in the position dtype; features in compute_dtype
        feat_dtype = self.compute_dtype or pos.dtype
        edge_scalars = self.rbf(edge_len).to(feat_dtype)
        edge_sh = edge_sh.to(feat_dtype)

        atom_emb, _ = self.atom_embed(graphs.species, feat_dtype)
        x = atom_emb + self.edge_deg_embed(edge_sh, edge_scalars, edges.dst, edges.mask, N)
        node_attr = torch.ones((N, 1), dtype=feat_dtype, device=pos.device)
        n_edges = active_edge_bound(edges.mask)
        for i in range(self.num_layers):
            args = (x, node_attr, edges, edge_sh, edge_scalars, n_edges, graphs.batch, G)
            block = getattr(self, f"block_{i}")
            if self.remat and self.training and torch.is_grad_enabled():
                x = remat_block(block, args, rng)
            else:
                x = block(*args, rng)
        x = self.norm(x)
        if self.out_dropout is not None:
            x = self.out_dropout(x, rng)
        if self.use_attn_head:
            x = self.attn_head(x, edges, edge_sh, edge_scalars, n_edges, rng)
        else:
            x = self.head_lin2(self.head_act(self.head_lin1(x)))
        x = x.to(pos.dtype)  # accumulate the readout in the position dtype
        out = scaled_scatter_sum(x, graphs.batch, G, self.avg_num_nodes, mask=graphs.node_mask)
        if self.atomref is not None:
            ref = torch.tensor(self.atomref, dtype=pos.dtype, device=pos.device)[graphs.species]
            out = out + segment_sum(ref[:, None], graphs.batch, G, mask=graphs.node_mask)
        return out[:, 0]


def remat_block(block: nn.Module, args: tuple, rng) -> torch.Tensor:
    """``block(*args, rng)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) from the same dropout masks:
    ``MaskReplay`` records what the forward draws from ``rng`` and replays
    it on each recompute.  Nothing on the block's path draws from the
    default generators, so their state is not saved."""
    masks = MaskReplay(rng)
    return checkpoint(lambda *a: block(*a, masks.start()), *args, use_reentrant=False,
                      preserve_rng_state=False)
