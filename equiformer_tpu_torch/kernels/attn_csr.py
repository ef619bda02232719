"""Fused attention combine over dst-sorted edges (K4).

Counterpart of ``equiformer_tpu/kernels/attn_csr_pallas.py``
(``csr_attention_combine``):

    out_u = sum_{e: dst_e=u} exp(s_e - m) * drop_e * v_e
            / max(sum_{e: dst_e=u} exp(s_e - m), 1e-16)

with ``m`` the global per-head max of the masked scores, floored at
``NEG * 1e-8`` so an all-masked head keeps exp(NEG - m) == 0, and masked
scores set to ``NEG``.  As on the TPU, ``m`` is computed outside the kernel.
The CUDA kernel is ``csrc/attn_csr.cu``: one launch on K3's block walk
(``csrc/csr_walk.cuh``: each block searches the sorted ``dst`` for its node
range's edges, cuts them into equal warp slices and skips masked edges by
the mask's bits, whose exponentials would be exactly 0); it also writes the
denominator ``den`` [N, H] in fp32.  ``attn_combine_plain`` (the composed
segment softmax + segment sum) and ``attn_den_plain`` are its plain PyTorch
versions.

The backward needs no scatter (``attn_csr_pallas.py:88-103``): with
``p = ex / den[dst]`` and ``r_u = <g_u, out_u>`` per head,

    dscores_e = p_e * (drop_e * <v_e, g[dst_e]> - r[dst_e])
    dvalue_e  = p_e * drop_e * g[dst_e]

written in plain torch ops, as JAX writes it in jnp outside any Pallas
kernel.  ``dropmul`` is a constant multiplier and gets no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .segment_csr import _INDEX_DTYPES, nodes_per_block, segment_sum_plain, vector_width

NEG = -1e30  # masked-edge score: exp underflows to exactly 0 in fp32
# the profiler range around the backward's torch ops (tools/profile_eval.py
# sums the kernels inside it)
ATTN_BWD_RANGE = "attn_combine_bwd"


def _acc(t: torch.Tensor) -> torch.dtype:
    """fp32 for half-precision inputs, else the input's own dtype (fp64 stays)."""
    return torch.promote_types(t.dtype, torch.float32)


def _shift(scores: torch.Tensor) -> torch.Tensor:
    """The per-head shift m: the max over the edges (the floor without edges)."""
    if scores.shape[0] == 0:
        return torch.full(scores.shape[1:], NEG * 1e-8, dtype=_acc(scores), device=scores.device)
    return torch.clamp(torch.amax(scores.to(_acc(scores)), dim=0), min=NEG * 1e-8)


def attn_combine_plain(scores, value, dst, num_nodes: int, mask=None, dropmul=None):
    """``segment_sum(segment_softmax(scores) * dropmul * value)``, composed."""
    from ..graph.segment import segment_softmax

    p = segment_softmax(scores, dst, num_nodes, mask=mask)
    if dropmul is not None:
        p = p * dropmul
    return segment_sum_plain(value * p[..., None], dst, num_nodes, mask=mask)


def attn_den_plain(scores, dst, num_nodes: int) -> torch.Tensor:
    """The kernel's ``den`` [N, H] (fp32, fp64 for fp64 scores) for scores
    already set to ``NEG`` on masked edges."""
    ex = torch.exp(scores.to(_acc(scores)) - _shift(scores))
    return torch.clamp(segment_sum_plain(ex, dst, num_nodes), min=1e-16)


def attn_combine_fwd(scores, value, dst, num_nodes: int, mask=None, dropmul=None):
    """K4: (out [N, H, D] in value's dtype, den [N, H] fp32) for ``scores``
    already set to ``NEG`` where ``mask`` is false (the kernel skips those
    edges).  CPU tensors take the plain versions; CUDA tensors launch the
    kernel (float32 or bfloat16) or raise."""
    if value.device.type == "cpu":
        return (attn_combine_plain(scores, value, dst, num_nodes, mask, dropmul),
                attn_den_plain(scores, dst, num_nodes))
    E, H = scores.shape
    if value.dim() != 3 or value.shape[:2] != (E, H) or dst.shape != (E,) or (
            dropmul is not None and dropmul.shape != (E, H)) or (
            mask is not None and (mask.dtype != torch.bool or mask.shape != (E,))):
        raise ValueError(f"bad shapes scores {scores.shape} value {value.shape} dst {dst.shape}")
    code = _build.dtype_code(value)
    if scores.dtype != value.dtype or (dropmul is not None and dropmul.dtype != value.dtype):
        raise TypeError("scores, value and dropmul must share a dtype")
    if dst.dtype not in _INDEX_DTYPES:
        raise TypeError("dst must be int64 or int32")
    if any(t is not None and t.device != value.device for t in (scores, dst, mask, dropmul)):
        raise ValueError("scores, value, dst, mask and dropmul must share a device")
    D = value.shape[2]
    shift = _shift(scores).contiguous()
    scores, value, dst = scores.contiguous(), value.contiguous(), dst.contiguous()
    dropmul = None if dropmul is None else dropmul.contiguous()
    mask = None if mask is None else mask.contiguous()
    out = torch.empty((num_nodes, H, D), dtype=value.dtype, device=value.device)
    den = torch.empty((num_nodes, H), dtype=torch.float32, device=value.device)
    if num_nodes == 0 or H * D == 0:
        return out, den
    vp, op = value.data_ptr(), out.data_ptr()
    vec = vector_width(H * D, value.element_size(), vp, op)
    err = _build.library().attn_combine(
        _build.ptr(scores), vp, _build.ptr(dropmul), _build.ptr(shift), dst.data_ptr(),
        dst.element_size(), _build.ptr(mask), E, op, _build.ptr(den), num_nodes, H, D,
        vec if D % vec == 0 else 1, nodes_per_block(num_nodes, E), code, _build.stream_ptr(),
    )
    _build.check(err, "attn_combine")
    attn_combine.launches += 1
    return out, den


class _AttnCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, value, dst, num_nodes, mask, dropmul):
        out, den = attn_combine_fwd(scores, value, dst, num_nodes, mask, dropmul)
        ctx.save_for_backward(scores, value, dst, dropmul, out, den)
        return out

    @staticmethod
    def backward(ctx, g):
        scores, value, dst, dropmul, out, den = ctx.saved_tensors
        with torch.profiler.record_function(ATTN_BWD_RANGE):
            acc = _acc(scores)
            ex = torch.exp(scores.to(acc) - _shift(scores))
            p = ex / den.to(acc)[dst]  # [E, H]; masked edges (NEG) -> 0
            gd = g[dst]  # [E, H, D]
            r = torch.sum(g.to(acc) * out.to(acc), dim=-1)  # [N, H]
            q = torch.sum(value.to(acc) * gd.to(acc), dim=-1)  # [E, H]
            drop = 1.0 if dropmul is None else dropmul.to(acc)
            dscores = (p * (drop * q - r[dst])).to(scores.dtype)
            dvalue = (p * drop).to(value.dtype)[..., None] * gd
        return dscores, dvalue, None, None, None, None


def attn_combine(
    scores: torch.Tensor,
    value: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    mask: Optional[torch.Tensor] = None,
    dropmul: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """scores [E, H], value [E, H, D], non-decreasing dst [E], optional bool
    mask [E] and dropmul [E, H] (keep mask / keep rate).  Returns
    [num_nodes, H, D] in value's dtype; differentiable in scores and value.
    The forward is ``attn_combine_fwd``."""
    if mask is not None:
        scores = torch.where(mask[:, None], scores, torch.full_like(scores, NEG))
    return _AttnCombine.apply(scores, value, dst, num_nodes, mask, dropmul)


attn_combine.launches = 0
