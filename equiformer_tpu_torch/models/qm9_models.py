"""Registered QM9 entrypoints (the flagship only, so far)."""

from __future__ import annotations

from .equiformer import GraphAttentionTransformer
from .registry import register_model, resolve_device


@register_model
def graph_attention_transformer_nonlinear_l2(radius=5.0, num_basis=128, alpha_drop=0.2,
                                             proj_drop=0.0, out_drop=0.0,
                                             drop_path_rate=0.0, device=None, **kwargs):
    """The flagship: 6 blocks on 128x0e+64x1e+32x2e, SH to l=2, nonlinear
    messages, 4 heads of 32x0e+16x1e+8x2e, alpha dropout 0.2 and no other
    dropout (``qm9_models.py`` of the JAX package, ``_gat(...,
    nonlinear=True)``).  Built on ``device``: CUDA unless the caller names
    another device; raises when there is no GPU."""
    model = GraphAttentionTransformer(
        irreps_node_embedding="128x0e+64x1e+32x2e",
        num_layers=6,
        irreps_sh="1x0e+1x1e+1x2e",
        max_radius=radius,
        number_of_basis=num_basis,
        fc_neurons=(64, 64),
        irreps_feature="512x0e",
        irreps_head="32x0e+16x1e+8x2e",
        num_heads=4,
        irreps_mlp_mid="384x0e+192x1e+96x2e",
        alpha_drop=alpha_drop,
        proj_drop=proj_drop,
        out_drop=out_drop,
        drop_path_rate=drop_path_rate,
        max_atom_type=5,
        **kwargs,
    )
    return model.to(resolve_device(device))
