"""Equiformer + DeNS (denoising non-equilibrium structures) for MD17.

Counterpart of ``equiformer_tpu.models.dens``.  Beside the MD17 force
model's trunk: a force encoding (the SH of each noised atom's force,
scaled by |F| / sqrt(3), through ``force_embed``; zero on the clean
atoms), a wide equivariant ``irreps_feature`` out of the last block (its
``ffn_shortcut``), a scalars-only energy head, and a ``GraphAttention``
denoising head that predicts the noise vector (1x1e, or 1x1o when the
inputs carry no 1e) from the wide features through ``irreps_pre_attn``.

``EquiformerDeNS.forward`` returns (energy [G], denoising vectors [N, 3]);
``dens_outputs`` takes the forces as -dE/dpos (the denoising output takes
no cotangent, as JAX's vjp with a zero one) and mixes them with the
denoising prediction on the noised atoms.  ``add_masked_gaussian_noise``
draws the noise on the batch's device from an explicit ``torch.Generator``
(the same semantics as JAX's, other random numbers); the radius graph is
rebuilt from the noised positions inside the forward.  Geometry and the
readout run in the position dtype, features in ``compute_dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.irreps import Irreps
from ..core.spherical import spherical_harmonics_for_irreps
from ..graph.batching import GraphsTuple
from ..graph.radius_graph import edge_vectors, radius_graph_dense, reverse_edge_perm_dense
from ..graph.segment import active_edge_bound, scaled_scatter_sum
from ..kernels.dtp import skip_leg_grads
from ..nn.activation import Activation
from ..nn.dropout import EquivariantDropout
from ..nn.linear import IrrepsLinear, init_parameters
from ..nn.norms import EquivariantLayerNorm
from ..nn.radial import make_rbf
from ..nn.tp_modules import EdgeDegreeEmbedding, NodeEmbedding
from .equiformer import _AVG_DEGREE, _AVG_NUM_NODES, GraphAttention, TransBlock
from .registry import register_model, resolve_device


# The aspirin L3 recipe of the JAX package's ``bench.py --task dens``: the
# model of configs/md17_dens/equiformer_dens_l3.yml, and its training
# (``make_dens_steps``' settings, the optimizer's cosine warmup schedule and
# weight decay, the denoising weight).
ASPIRIN_L3 = dict(
    irreps_node_embedding="128x0e+64x1e+64x2e+32x3e", num_layers=6,
    irreps_sh="1x0e+1x1e+1x2e+1x3e", irreps_equivariant_inputs="1x0e+1x1e+1x2e+1x3e",
    number_of_basis=32, basis_type="exp", fc_neurons=(64, 64),
    irreps_feature="512x0e+256x1e+256x2e+128x3e", irreps_head="32x0e+16x1e+16x2e+8x3e",
    num_heads=4, irreps_pre_attn="128x0e+64x1e+64x2e+32x3e",
    irreps_mlp_mid="384x0e+192x1e+192x2e+96x3e", nonlinear_message=True, alpha_drop=0.0)
ASPIRIN_L3_TRAIN = dict(
    steps=dict(energy_weight=1.0, force_weight=80.0, denoising_pos_std=0.05,
               denoising_pos_prob=0.25, corrupt_ratio=0.25, ema_decay=0.999),
    schedule=(2e-4, 100, 100000), weight_decay=1e-6, dp_weight=5.0)


def every_pair_edges(graphs: int, nodes_per_graph: int) -> int:
    """``max_edges`` for a batch whose radius graph is rebuilt from noised
    positions: every ordered pair of each graph's atoms, rounded up to 128,
    so that no draw truncates the edge list (truncation would break the
    reverse-edge twins)."""
    pairs = graphs * nodes_per_graph * (nodes_per_graph - 1)
    return -(-pairs // 128) * 128


class EquiformerDeNS(nn.Module):
    """The options keep the JAX package's names and defaults; only the
    fixed-slot layout (``nodes_per_graph`` > 0), nonlinear messages, layer
    norms and no degree rescaling are ported.  In training mode ``forward``
    needs ``rng`` when a dropout rate is nonzero."""

    def __init__(
        self,
        irreps_equivariant_inputs="1x0e+1x1e+1x2e",
        irreps_node_embedding="128x0e+64x1e+32x2e",
        num_layers: int = 6,
        irreps_node_attr="1x0e",
        irreps_sh="1x0e+1x1e+1x2e",
        max_radius: float = 5.0,
        number_of_basis: int = 32,
        basis_type: str = "exp",
        fc_neurons: Tuple[int, ...] = (64, 64),
        irreps_feature="512x0e+256x1e+128x2e",
        irreps_head="32x0e+16x1e+8x2e",
        num_heads: int = 4,
        irreps_pre_attn="128x0e+64x1e+32x2e",
        rescale_degree: bool = False,
        nonlinear_message: bool = True,
        irreps_mlp_mid="128x0e+64x1e+32x2e",
        norm_layer: str = "layer",
        alpha_drop: float = 0.0,
        proj_drop: float = 0.0,
        out_drop: float = 0.0,
        drop_path_rate: float = 0.0,
        max_atom_type: int = 64,
        avg_num_nodes: float = _AVG_NUM_NODES,
        avg_degree: float = _AVG_DEGREE,
        max_edges: int = 8192,
        use_force_encoding: bool = True,
        nodes_per_graph: int = 0,
        compute_dtype: Optional[str] = None,
        seed: int = 0,
    ):
        super().__init__()
        if nodes_per_graph <= 0:
            raise NotImplementedError("only the fixed-slot (collate_dense) layout is ported")
        if rescale_degree or not nonlinear_message or norm_layer != "layer":
            raise NotImplementedError("ported: nonlinear messages, layer norms, no degree "
                                      "rescaling")
        if Irreps(irreps_node_attr) != Irreps("1x0e"):
            raise NotImplementedError("the node attribute is the constant 1x0e")
        self.irreps_sh = Irreps(irreps_sh)
        self.irreps_equivariant_inputs = eq_in = Irreps(irreps_equivariant_inputs)
        self.max_radius = max_radius
        self.max_edges = max_edges
        self.nodes_per_graph = nodes_per_graph
        self.avg_num_nodes = avg_num_nodes
        self.use_force_encoding = use_force_encoding
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        emb = Irreps(irreps_node_embedding)
        feat = Irreps(irreps_feature)
        fc = (number_of_basis,) + tuple(fc_neurons)

        self.rbf = make_rbf(basis_type, number_of_basis, max_radius)
        self.atom_embed = NodeEmbedding(emb, max_atom_type)
        self.edge_deg_embed = EdgeDegreeEmbedding(emb, self.irreps_sh, fc, avg_degree)
        self.force_embed = IrrepsLinear(eq_in, emb)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransBlock(
                emb, "1x0e", self.irreps_sh, feat if i == num_layers - 1 else emb, fc,
                irreps_head, num_heads, irreps_mlp_mid, alpha_drop, proj_drop, drop_path_rate,
                irreps_pre_attn=irreps_pre_attn))
        self.num_layers = num_layers
        self.norm = EquivariantLayerNorm(feat)
        self.out_dropout = EquivariantDropout(feat, out_drop) if out_drop != 0.0 else None
        scalars = feat.filter_scalars_even()
        self.energy_lin1 = IrrepsLinear(feat, scalars)
        self.energy_act = Activation(scalars, ["silu"])
        self.energy_lin2 = IrrepsLinear(scalars, Irreps("1x0e"))
        out_ir = "1x1e" if "1e" in eq_in else "1x1o"
        self.denoising_pos_head = GraphAttention(
            feat, self.irreps_sh, out_ir, fc, irreps_head, num_heads, alpha_drop, proj_drop,
            irreps_pre_attn=irreps_pre_attn)
        init_parameters(self, seed)

    def force_encoding(self, graphs: GraphsTuple) -> torch.Tensor:
        """[N, dim of the equivariant inputs], in the position dtype: the SH
        of each noised atom's force times |F| / sqrt(3), zero elsewhere and
        wherever the batch carries no force extras or the encoding is off."""
        force = graphs.extras.get("force")
        pos = graphs.pos
        if force is None or not self.use_force_encoding:
            return torch.zeros((pos.shape[0], self.irreps_equivariant_inputs.dim),
                               dtype=pos.dtype, device=pos.device)
        noised = graphs.extras["noise_mask"][:, None]
        force_sh = spherical_harmonics_for_irreps(self.irreps_equivariant_inputs, force)
        force_sh = torch.where(noised, force_sh, torch.zeros_like(force_sh))
        norm = torch.linalg.vector_norm(torch.where(noised, force, torch.zeros_like(force)),
                                        dim=-1, keepdim=True) / math.sqrt(3.0)
        return force_sh * norm

    def forward(self, graphs: GraphsTuple, rng=None):
        """(energy [G], denoising vectors [N, 3]), both in the position
        dtype.  ``rng``: a ``torch.Generator`` on the batch's device (or an
        iterator of injected keep masks) for the dropout sites in training
        mode."""
        pos = graphs.pos
        G = graphs.graph_mask.shape[0]
        N = pos.shape[0]
        if N != G * self.nodes_per_graph:
            raise ValueError(f"{N} nodes != {G} graphs x {self.nodes_per_graph} slots")
        edges = radius_graph_dense(pos, graphs.node_mask, G, self.max_radius, self.max_edges)
        edges = edges._replace(rev=reverse_edge_perm_dense(edges, G, self.nodes_per_graph))
        edge_vec, edge_len = edge_vectors(pos, edges)
        edge_sh = spherical_harmonics_for_irreps(self.irreps_sh, edge_vec)
        feat_dtype = self.compute_dtype or pos.dtype
        edge_scalars = self.rbf(edge_len).to(feat_dtype)
        edge_sh = edge_sh.to(feat_dtype)

        atom_emb, _ = self.atom_embed(graphs.species, feat_dtype)
        x = atom_emb + self.edge_deg_embed(edge_sh, edge_scalars, edges.dst, edges.mask, N)
        x = x + self.force_embed(self.force_encoding(graphs).to(feat_dtype))
        node_attr = torch.ones((N, 1), dtype=feat_dtype, device=pos.device)
        n_edges = active_edge_bound(edges.mask)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, node_attr, edges, edge_sh, edge_scalars, n_edges,
                                            graphs.batch, G, rng)
        x = self.norm(x)
        if self.out_dropout is not None:
            x = self.out_dropout(x, rng)

        e = self.energy_lin2(self.energy_act(self.energy_lin1(x)))
        e = e.to(pos.dtype)  # accumulate the readout in the position dtype
        dpm = graphs.extras.get("denoising_pos_mask")
        if not self.use_force_encoding and dpm is not None:
            # the ablation predicts no energy of the denoised graphs
            e = torch.where(dpm[:, None], torch.zeros_like(e), e)
        energy = scaled_scatter_sum(e, graphs.batch, G, self.avg_num_nodes,
                                    mask=graphs.node_mask)[:, 0]
        denoise = self.denoising_pos_head(x, edges, edge_sh, edge_scalars, n_edges, rng)
        return energy, denoise.to(pos.dtype)


def dens_outputs(model: EquiformerDeNS, batch: GraphsTuple, create_graph: bool = False,
                 rng=None):
    """(energy [G], outputs [N, 3]): the forces -dE/dpos (zero on padded
    slots), and, where the batch carries a ``noise_mask``, the denoising
    prediction in their place on the noised atoms (zero on the denoised
    graphs' atoms in the ``use_force_encoding=False`` ablation).  The
    denoising output takes no cotangent: the position gradient is the
    energy's alone, as JAX's vjp with a zero one.

    As ``md17_models.energy_and_forces``: by default the forward reads
    detached copies of the parameters and the returned tensors carry no
    graph; ``create_graph=True`` is the force pass of training (live
    parameters, the position gradient with ``create_graph=True`` and the W
    and Wr legs skipped; ``rng`` feeds the dropout sites)."""
    pos = batch.pos.detach().requires_grad_(True)
    b = dataclasses.replace(batch, pos=pos)
    with torch.enable_grad():
        if create_graph:
            energy, denoise = model(b, rng=rng)
            with skip_leg_grads("W", "Wr"):
                (grad,) = torch.autograd.grad(energy, pos, torch.ones_like(energy),
                                              create_graph=True)
        else:
            params = {n: p.detach() for n, p in model.named_parameters()}
            energy, denoise = torch.func.functional_call(model, params, (b,))
            (grad,) = torch.autograd.grad(energy, pos, torch.ones_like(energy))
            energy, denoise = energy.detach(), denoise.detach()
        forces = torch.where(batch.node_mask[:, None], -grad, torch.zeros_like(grad))
    noise_mask = batch.extras.get("noise_mask")
    if noise_mask is None:
        return energy, forces
    out = torch.where(noise_mask[:, None], denoise, forces)
    if not model.use_force_encoding:
        dpm = batch.extras["denoising_pos_mask"]
        out = torch.where(dpm[:, None], torch.zeros_like(out), out)
    return energy, out


def add_masked_gaussian_noise(graphs: GraphsTuple, generator: torch.Generator, std: float,
                              prob: float, corrupt_ratio: Optional[float] = None) -> GraphsTuple:
    """The DeNS noise augmentation, drawn from ``generator`` (on the batch's
    device): each graph is picked with probability ``prob``
    (``denoising_pos_mask``: its real atoms), then each picked atom with
    probability ``corrupt_ratio`` when given (``noise_mask``); the noised
    atoms move by N(0, std^2) per coordinate.  Adds to ``extras``:
    ``force`` (the force targets on the noised atoms, zero elsewhere),
    ``noise_mask``, ``denoising_pos_mask`` and ``noise_vec`` (drawn for
    every slot)."""
    dev = graphs.pos.device
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the batch on {dev}")
    graph_pick = torch.rand(graphs.graph_mask.shape[0], generator=generator, device=dev) < prob
    denoising_pos_mask = graph_pick[graphs.batch] & graphs.node_mask
    noise_mask = denoising_pos_mask
    if corrupt_ratio is not None:
        corrupt = torch.rand(graphs.batch.shape[0], generator=generator, device=dev)
        noise_mask = noise_mask & (corrupt < corrupt_ratio)
    rows = noise_mask[:, None]
    force = torch.where(rows, graphs.forces, torch.zeros_like(graphs.forces))
    noise_vec = torch.randn(graphs.pos.shape, generator=generator, device=dev,
                            dtype=graphs.pos.dtype) * std
    pos = graphs.pos + torch.where(rows, noise_vec, torch.zeros_like(noise_vec))
    extras = dict(graphs.extras)
    extras.update(force=force, noise_mask=noise_mask, denoising_pos_mask=denoising_pos_mask,
                  noise_vec=noise_vec)
    return dataclasses.replace(graphs, pos=pos, extras=extras)


@register_model
def equiformer_md17_dens(device=None, **kwargs):
    """``EquiformerDeNS`` built on ``device``: CUDA unless the caller names
    another device; raises when there is no GPU."""
    return EquiformerDeNS(**kwargs).to(resolve_device(device))
