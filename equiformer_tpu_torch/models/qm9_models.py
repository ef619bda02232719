"""Registered QM9 entrypoints: the nonlinear-message models of the JAX
package's ``qm9_models`` (the linear-message and dot-product ablations are
not ported), all on one body, ``_gat``."""

from __future__ import annotations

import numpy as np

from .equiformer import GraphAttentionTransformer
from .registry import register_model, resolve_device


def _gat(radius, num_basis, *, basis="gaussian", alpha_drop=0.2,
         irreps_node_embedding="128x0e+64x1e+32x2e",
         irreps_sh="1x0e+1x1e+1x2e",
         irreps_head="32x0e+16x1e+8x2e",
         irreps_mlp_mid="384x0e+192x1e+96x2e",
         device=None, irreps_in=None, task_mean=None, task_std=None, atomref=None,
         **kwargs):
    """6 blocks of nonlinear messages, 4 heads, a 512x0e feature and no
    dropout but alpha dropout by default (JAX's ``_gat(...,
    nonlinear=True)``), built on ``device``: CUDA unless the caller names
    another device; raises when there is no GPU.  The reference-compat
    arguments as JAX's ``_gat`` takes them: ``task_mean`` / ``task_std``
    kept on the model, ``atomref`` added per graph, ``irreps_in`` dropped."""
    del irreps_in  # the reference's one-hot input irreps; the embedding takes species
    if task_mean is not None:
        kwargs.setdefault("task_mean", float(task_mean))
    if task_std is not None:
        kwargs.setdefault("task_std", float(task_std))
    if atomref is not None:
        kwargs.setdefault("atomref", tuple(float(a) for a in np.asarray(atomref).ravel()))
    kwargs.setdefault("proj_drop", 0.0)
    kwargs.setdefault("out_drop", 0.0)
    kwargs.setdefault("drop_path_rate", 0.0)
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
        max_atom_type=5,
        higher_order_grads=False,  # QM9 training never differentiates through pos
        **kwargs,
    )
    return model.to(resolve_device(device))


@register_model
def graph_attention_transformer_nonlinear_l2(radius=5.0, num_basis=128, **kwargs):
    """The flagship: 128x0e+64x1e+32x2e, SH to l=2, alpha dropout 0.2."""
    return _gat(radius, num_basis, **kwargs)


@register_model
def graph_attention_transformer_nonlinear_l2_e3(radius=5.0, num_basis=128, **kwargs):
    """The flagship with both parities (odd SH at l=1)."""
    return _gat(
        radius, num_basis,
        irreps_node_embedding="128x0e+32x0o+32x1e+32x1o+16x2e+16x2o",
        irreps_sh="1x0e+1x1o+1x2e",
        irreps_head="32x0e+8x0o+8x1e+8x1o+4x2e+4x2o",
        irreps_mlp_mid="384x0e+96x0o+96x1e+96x1o+48x2e+48x2o",
        **kwargs,
    )


@register_model
def graph_attention_transformer_nonlinear_bessel_l2(radius=5.0, num_basis=128, **kwargs):
    return _gat(radius, num_basis, basis="bessel", **kwargs)


@register_model
def graph_attention_transformer_nonlinear_bessel_l2_drop01(radius=5.0, num_basis=128,
                                                          **kwargs):
    return _gat(radius, num_basis, basis="bessel", alpha_drop=0.1, **kwargs)


@register_model
def graph_attention_transformer_nonlinear_bessel_l2_drop00(radius=5.0, num_basis=128,
                                                          **kwargs):
    return _gat(radius, num_basis, basis="bessel", alpha_drop=0.0, **kwargs)
