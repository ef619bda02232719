"""Fused attention combine over dst-sorted edges (K4).

Counterpart of ``equiformer_tpu/kernels/attn_csr_pallas.py``
(``csr_attention_combine``):

    out_u = sum_{e: dst_e=u} exp(s_e - m) * drop_e * v_e
            / max(sum_{e: dst_e=u} exp(s_e - m), 1e-16)

with ``m`` the global per-head max of the masked scores, floored at
``NEG * 1e-8`` so an all-masked head keeps exp(NEG - m) == 0, and masked
scores set to ``NEG``.  As on the TPU, ``m`` is computed outside the kernel.
The CUDA kernel is ``csrc/attn_csr.cu``; ``attn_combine_plain`` (the composed
segment softmax + segment sum) is its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .segment_csr import row_pointers, segment_sum_plain

NEG = -1e30  # masked-edge score: exp underflows to exactly 0 in fp32


def attn_combine_plain(scores, value, dst, num_nodes: int, mask=None, dropmul=None):
    """``segment_sum(segment_softmax(scores) * dropmul * value)``, composed."""
    from ..graph.segment import segment_softmax

    p = segment_softmax(scores, dst, num_nodes, mask=mask)
    if dropmul is not None:
        p = p * dropmul
    return segment_sum_plain(value * p[..., None], dst, num_nodes, mask=mask)


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
    [num_nodes, H, D] in value's dtype.

    CPU tensors take ``attn_combine_plain``; CUDA tensors launch the kernel
    (float32 or bfloat16) or raise.
    """
    if value.device.type == "cpu":
        return attn_combine_plain(scores, value, dst, num_nodes, mask, dropmul)
    E, H = scores.shape
    if value.dim() != 3 or value.shape[:2] != (E, H) or dst.shape != (E,) or (
            dropmul is not None and dropmul.shape != (E, H)):
        raise ValueError(f"bad shapes scores {scores.shape} value {value.shape} dst {dst.shape}")
    code = _build.dtype_code(value)
    if scores.dtype != value.dtype or (dropmul is not None and dropmul.dtype != value.dtype):
        raise TypeError("scores, value and dropmul must share a dtype")
    if any(t is not None and t.device != value.device for t in (scores, dst, mask, dropmul)):
        raise ValueError("scores, value, dst, mask and dropmul must share a device")
    D = value.shape[2]
    if mask is not None:
        scores = torch.where(mask[:, None], scores, torch.full_like(scores, NEG))
    shift = torch.clamp(torch.amax(scores.float(), dim=0), min=NEG * 1e-8).contiguous()
    scores = scores.contiguous()
    value = value.contiguous()
    dropmul = None if dropmul is None else dropmul.contiguous()
    rp = row_pointers(dst.contiguous(), num_nodes)
    out = torch.empty((num_nodes, H, D), dtype=value.dtype, device=value.device)
    if num_nodes == 0 or H * D == 0:
        return out
    err = _build.library().attn_combine(
        _build.ptr(scores), _build.ptr(value), _build.ptr(dropmul),
        _build.ptr(shift), _build.ptr(rp), _build.ptr(out),
        num_nodes, H, D, code, _build.stream_ptr(),
    )
    _build.check(err, "attn_combine")
    attn_combine.launches += 1
    return out


attn_combine.launches = 0
