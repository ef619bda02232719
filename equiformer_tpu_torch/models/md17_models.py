"""MD17 energy + force models and the force evaluation.

Counterpart of ``equiformer_tpu.models.md17_models``: the trunk is the QM9
Equiformer's, with raw atomic numbers as types (64 of them), the MD17 graph
statistics and the exp or bessel radial basis; forces are minus the gradient
of the energy with respect to the positions (``energy_and_forces``).  The
registered entrypoints are the nonlinear MLP-attention ones; the
linear-message, attention-head and dot-product variants are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ..graph.batching import GraphsTuple
from ..kernels.dtp import skip_leg_grads
from .equiformer import GraphAttentionTransformer
from .registry import register_model, resolve_device

# The reference reuses the QM9 r = 5 statistics for MD17 verbatim; they
# scale every output, so they match the JAX package to the last digit.
_AVG_NUM_NODES_MD17 = 18.03065905448718
_AVG_DEGREE_MD17 = 15.57930850982666


def energy_and_forces(model: torch.nn.Module, batch: GraphsTuple, create_graph: bool = False,
                      rng=None):
    """(energy [G], forces [N, 3]) with forces = -dE/dpos, zero on padded
    nodes: ``jax.vjp`` of the energy with a ones cotangent in the JAX
    package.  Runs under ``torch.enable_grad()`` whatever the caller's mode.

    By default the forward reads detached copies of the parameters
    (``torch.func.functional_call``), so the backward is asked for the
    position gradient only, as JAX's vjp over ``pos`` is, and the returned
    tensors carry no graph.

    ``create_graph=True`` is the force pass of training
    (``train/engine.py::make_md17_steps``): the forward reads the live
    parameters (``rng`` feeds the dropout sites of a model in training
    mode) and the position gradient is taken with ``create_graph=True``, so
    the energy and the forces carry the graph that the loss is then
    differentiated through, a grad-of-grad on the fused DTP's leg kernels
    (``kernels/dtp_lin_ho.py``) or, unfused, on T and R (``kernels/dtp.py``).
    This pass needs no gradient of the parameters, so it skips the W leg
    (the fused op's head weights, the unfused route's broadcast operands)
    and the radial fold's Wr leg ([Wr; offset]); not h, which depends on the
    positions through the radial basis."""
    pos = batch.pos.detach().requires_grad_(True)
    b = dataclasses.replace(batch, pos=pos)
    with torch.enable_grad():
        if create_graph:
            energy = model(b, rng=rng)
            with skip_leg_grads("W", "Wr"):
                (grad,) = torch.autograd.grad(energy, pos, torch.ones_like(energy),
                                              create_graph=True)
        else:
            params = {n: p.detach() for n, p in model.named_parameters()}
            energy = torch.func.functional_call(model, params, (b,))
            (grad,) = torch.autograd.grad(energy, pos, torch.ones_like(energy))
            energy = energy.detach()
        forces = torch.where(batch.node_mask[:, None], -grad, torch.zeros_like(grad))
    return energy, forces


def _md17(radius, num_basis, *, basis="gaussian", alpha_drop=0.2,
          irreps_node_embedding="128x0e+64x1e+32x2e", irreps_sh="1x0e+1x1e+1x2e",
          irreps_head="32x0e+16x1e+8x2e", irreps_mlp_mid="384x0e+192x1e+96x2e",
          device=None, irreps_in=None, task_mean=None, task_std=None, atomref=None,
          **kwargs):
    """The MD17 trunk (``md17_models._md17`` of the JAX package, nonlinear
    messages), built on ``device``: CUDA unless the caller names another
    device; raises when there is no GPU.  The reference-compat arguments as
    JAX's ``_md17`` takes them: ``task_mean`` / ``task_std`` kept on the
    model, ``irreps_in`` and ``atomref`` dropped."""
    del irreps_in, atomref
    if task_mean is not None:
        kwargs.setdefault("task_mean", float(task_mean))
    if task_std is not None:
        kwargs.setdefault("task_std", float(task_std))
    model = GraphAttentionTransformer(
        irreps_node_embedding=irreps_node_embedding,
        num_layers=6,
        irreps_sh=irreps_sh,
        max_radius=radius,
        number_of_basis=num_basis,
        basis_type=basis,
        fc_neurons=(64, 64),
        irreps_feature="512x0e",
        irreps_head=irreps_head,
        num_heads=4,
        irreps_mlp_mid=irreps_mlp_mid,
        alpha_drop=alpha_drop,
        proj_drop=0.0,
        out_drop=0.0,
        drop_path_rate=0.0,
        max_atom_type=64,
        avg_num_nodes=_AVG_NUM_NODES_MD17,
        avg_degree=_AVG_DEGREE_MD17,
        **kwargs,
    )
    return model.to(resolve_device(device))


_L3 = dict(
    irreps_node_embedding="128x0e+64x1e+64x2e+32x3e",
    irreps_sh="1x0e+1x1e+1x2e+1x3e",
    irreps_head="32x0e+16x1e+16x2e+8x3e",
    irreps_mlp_mid="384x0e+192x1e+192x2e+96x3e",
)
_L3_E3 = dict(
    irreps_node_embedding="128x0e+64x0o+32x1e+32x1o+32x2e+32x2o+16x3e+16x3o",
    irreps_sh="1x0e+1x1o+1x2e+1x3o",
    irreps_head="32x0e+16x0o+8x1e+8x1o+8x2e+8x2o+4x3e+4x3o",
    irreps_mlp_mid="384x0e+192x0o+96x1e+96x1o+96x2e+96x2o+48x3e+48x3o",
)
_L2_E3 = dict(
    irreps_node_embedding="128x0e+32x0o+32x1e+32x1o+16x2e+16x2o",
    irreps_sh="1x0e+1x1o+1x2e",
    irreps_head="32x0e+8x0o+8x1e+8x1o+4x2e+4x2o",
    irreps_mlp_mid="384x0e+96x0o+96x1e+96x1o+48x2e+48x2o",
)


@register_model
def graph_attention_transformer_nonlinear_l2_md17(radius=5.0, num_basis=128, **kw):
    return _md17(radius, num_basis, **kw)


@register_model
def graph_attention_transformer_nonlinear_l2_e3_md17(radius=5.0, num_basis=128, **kw):
    return _md17(radius, num_basis, **_L2_E3, **kw)


@register_model
def graph_attention_transformer_nonlinear_bessel_l2_md17(radius=5.0, num_basis=128, **kw):
    return _md17(radius, num_basis, basis="bessel", alpha_drop=0.0, **kw)


@register_model
def graph_attention_transformer_nonlinear_exp_l2_md17(radius=5.0, num_basis=128, **kw):
    return _md17(radius, num_basis, basis="exp", alpha_drop=0.0, **kw)


@register_model
def graph_attention_transformer_nonlinear_exp_l3_md17(radius=5.0, num_basis=128, **kw):
    """The headline force model (``bench.py --task md17`` of the JAX package)."""
    return _md17(radius, num_basis, basis="exp", alpha_drop=0.0, **_L3, **kw)


@register_model
def graph_attention_transformer_nonlinear_exp_l3_e3_md17(radius=5.0, num_basis=128, **kw):
    return _md17(radius, num_basis, basis="exp", alpha_drop=0.0, **_L3_E3, **kw)


@register_model
def graph_attention_transformer_nonlinear_bessel_l3_md17(radius=5.0, num_basis=128, **kw):
    return _md17(radius, num_basis, basis="bessel", alpha_drop=0.0, **_L3, **kw)


@register_model
def graph_attention_transformer_nonlinear_bessel_l3_e3_md17(radius=5.0, num_basis=128, **kw):
    return _md17(radius, num_basis, basis="bessel", alpha_drop=0.0, **_L3_E3, **kw)
