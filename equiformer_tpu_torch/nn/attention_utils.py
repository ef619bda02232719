"""Head reshaping and the attention aggregation tail.

Counterpart of ``equiformer_tpu.nn.attention_utils``.  A flat irreps feature
whose blocks have multiplicity mul*H is laid out [d, H, mul] per block (heads
major on the copy axis); ``vec2heads`` turns it into [N, H, head_dim] with
[d, mul] blocks per head, ``heads2vec`` inverts it.
"""

from __future__ import annotations

import torch

from ..core.irreps import Irreps
from ..graph.segment import segment_softmax, segment_sum
from ..kernels.attn_csr import attn_combine, attn_combine_plain
from .dropout import dropout_multiplier

FUSED_MIN_COLS = 128  # H*D below this takes the composed ops, as in JAX


def vec2heads(irreps_head: Irreps, num_heads: int, x: torch.Tensor) -> torch.Tensor:
    """[N, sum(mul*H*dim)] -> [N, H, irreps_head.dim]."""
    pieces, i = [], 0
    for mul, ir in irreps_head:
        size = mul * ir.dim * num_heads
        blk = x[..., i : i + size].reshape(x.shape[:-1] + (ir.dim, num_heads, mul))
        blk = blk.transpose(-3, -2)  # [..., H, d, mul]
        pieces.append(blk.reshape(blk.shape[:-2] + (ir.dim * mul,)))
        i += size
    return torch.cat(pieces, dim=-1)


def heads2vec(irreps_head: Irreps, x: torch.Tensor) -> torch.Tensor:
    """[N, H, irreps_head.dim] -> [N, H*irreps_head.dim] (inverse of vec2heads)."""
    pieces, i = [], 0
    H = x.shape[-2]
    for mul, ir in irreps_head:
        size = mul * ir.dim
        blk = x[..., i : i + size].reshape(x.shape[:-1] + (ir.dim, mul))
        blk = blk.transpose(-3, -2)  # [..., d, H, mul]
        pieces.append(blk.reshape(blk.shape[:-3] + (ir.dim * H * mul,)))
        i += size
    return torch.cat(pieces, dim=-1)


def heads_irreps(irreps_head: Irreps, num_heads: int) -> Irreps:
    """Flat irreps of num_heads stacked heads, sorted even-first and simplified."""
    irr, _, _ = (Irreps(irreps_head) * num_heads).sort_even_first()
    return irr.simplify()


def softmax_dropout_combine(alpha: torch.Tensor, value: torch.Tensor, dst: torch.Tensor,
                            mask: torch.Tensor, num_nodes: int, alpha_drop: float = 0.0,
                            training: bool = False, rng=None,
                            higher_order: bool = False) -> torch.Tensor:
    """``segment_sum(segment_softmax(alpha, dst) * dropmul * value, dst)``.

    alpha [E, H] logits, value [E, H, D], dst-sorted edges.  In training
    with ``alpha_drop`` > 0, ``dropmul`` = keep mask [E, H] / keep, drawn
    from ``rng`` or injected through it (``nn/dropout.py``); else 1.
    With ``higher_order`` (the force models) it is always the composed
    segment softmax and ``segment_sum`` (the CSR kernel at >= 128 columns);
    otherwise H*D >= 128 takes the fused combine (``kernels/attn_csr.py``)
    and narrower ones the composed ops — the JAX package's rule.
    """
    H, D = value.shape[1], value.shape[2]
    dropmul = None
    if training and alpha_drop != 0.0:
        dropmul = dropout_multiplier(rng, alpha.shape, alpha_drop, alpha.dtype, alpha.device)
    if higher_order:
        p = segment_softmax(alpha, dst, num_nodes, mask=mask, higher_order=True)
        if dropmul is not None:
            p = p * dropmul
        return segment_sum(value * p[..., None], dst, num_nodes, mask=mask)
    if H * D >= FUSED_MIN_COLS:
        return attn_combine(alpha, value, dst, num_nodes, mask=mask, dropmul=dropmul)
    return attn_combine_plain(alpha, value, dst, num_nodes, mask=mask, dropmul=dropmul)
