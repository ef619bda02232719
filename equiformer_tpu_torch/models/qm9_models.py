"""Registered QM9 entrypoints (the flagship only, so far)."""

from __future__ import annotations

import numpy as np

from .equiformer import GraphAttentionTransformer
from .registry import register_model, resolve_device


@register_model
def graph_attention_transformer_nonlinear_l2(radius=5.0, num_basis=128, alpha_drop=0.2,
                                             proj_drop=0.0, out_drop=0.0,
                                             drop_path_rate=0.0, device=None,
                                             irreps_node_embedding="128x0e+64x1e+32x2e",
                                             irreps_sh="1x0e+1x1e+1x2e",
                                             irreps_head="32x0e+16x1e+8x2e",
                                             irreps_mlp_mid="384x0e+192x1e+96x2e",
                                             irreps_in=None, task_mean=None, task_std=None,
                                             atomref=None, **kwargs):
    """The flagship: 6 blocks on 128x0e+64x1e+32x2e, SH to l=2, nonlinear
    messages, 4 heads of 32x0e+16x1e+8x2e, alpha dropout 0.2 and no other
    dropout (``qm9_models.py`` of the JAX package, ``_gat(...,
    nonlinear=True)``).  Built on ``device``: CUDA unless the caller names
    another device; raises when there is no GPU.  The irreps and the
    reference-compat arguments as JAX's ``_gat`` takes them: ``task_mean`` /
    ``task_std`` kept on the model, ``atomref`` added per graph,
    ``irreps_in`` dropped."""
    del irreps_in  # the reference's one-hot input irreps; the embedding takes species
    if task_mean is not None:
        kwargs.setdefault("task_mean", float(task_mean))
    if task_std is not None:
        kwargs.setdefault("task_std", float(task_std))
    if atomref is not None:
        kwargs.setdefault("atomref", tuple(float(a) for a in np.asarray(atomref).ravel()))
    model = GraphAttentionTransformer(
        irreps_node_embedding=irreps_node_embedding,
        num_layers=6,
        irreps_sh=irreps_sh,
        max_radius=radius,
        number_of_basis=num_basis,
        fc_neurons=(64, 64),
        irreps_feature="512x0e",
        irreps_head=irreps_head,
        num_heads=4,
        irreps_mlp_mid=irreps_mlp_mid,
        alpha_drop=alpha_drop,
        proj_drop=proj_drop,
        out_drop=out_drop,
        drop_path_rate=drop_path_rate,
        max_atom_type=5,
        higher_order_grads=False,  # QM9 training never differentiates through pos
        **kwargs,
    )
    return model.to(resolve_device(device))
