"""CSR segment sum over dst-sorted edges (K3).

Counterpart of ``equiformer_tpu/kernels/segment_csr_pallas.py``
(``csr_segment_sum``, Pallas ``_kernel``): ``out[u] = sum of val[e] over the
edges with dst[e] == u``, accumulated in fp32 and written in val's dtype.
The CUDA kernel is ``csrc/segment_csr.cu``; ``segment_sum_plain`` is its
plain PyTorch version, used for CPU tensors and as the on-card reference.
The op is differentiable in ``val`` to any order: the backward is the gather
``take_rows(g, dst)`` of ``graph/linear_prims.py`` with masked rows zeroed
(``segment_csr_pallas.py:135-148``), whose own backward is this sum again.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build


def segment_sum_plain(val, dst, num_nodes: int, mask=None):
    """``index_add_`` over rows; half-precision inputs accumulate in fp32 like
    the kernel.  Masked rows contribute nothing."""
    acc_dtype = torch.float32 if val.dtype in (torch.bfloat16, torch.float16) else val.dtype
    v = val.to(acc_dtype)
    if mask is not None:
        v = torch.where(mask.reshape(mask.shape + (1,) * (v.dim() - 1)), v,
                        torch.zeros_like(v))
    out = torch.zeros((num_nodes,) + tuple(val.shape[1:]), dtype=acc_dtype,
                      device=val.device)
    out.index_add_(0, dst, v)
    return out.to(val.dtype)


def row_pointers(dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """int32 [num_nodes + 1]: edges of node u are ``[rp[u], rp[u+1])`` in a
    non-decreasing ``dst`` (the per-node form of the Pallas kernel's tile
    starts, ``segment_csr_pallas.py:128-130``)."""
    nodes = torch.arange(num_nodes + 1, device=dst.device, dtype=dst.dtype)
    return torch.searchsorted(dst, nodes, side="left").to(torch.int32)


def _segment_sum_fwd(val, dst, num_nodes: int, mask):
    if val.device.type == "cpu":
        return segment_sum_plain(val, dst, num_nodes, mask)
    if val.dim() != 2 or dst.shape != val.shape[:1]:
        raise ValueError(f"val must be [E, C] and dst [E], got {val.shape}, {dst.shape}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != dst.shape):
        raise ValueError("mask must be bool [E]")
    if any(t is not None and t.device != val.device for t in (dst, mask)):
        raise ValueError("val, dst and mask must share a device")
    code = _build.dtype_code(val)
    val = val.contiguous()
    rp = row_pointers(dst.contiguous(), num_nodes)
    mask = None if mask is None else mask.contiguous()
    out = torch.empty((num_nodes, val.shape[1]), dtype=val.dtype, device=val.device)
    if num_nodes == 0 or val.shape[1] == 0:
        return out
    err = _build.library().csr_segment_sum(
        _build.ptr(val), val.shape[1], _build.ptr(rp), _build.ptr(mask),
        _build.ptr(out), num_nodes, code, _build.stream_ptr(),
    )
    _build.check(err, "csr_segment_sum")
    csr_segment_sum.launches += 1
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, val, dst, num_nodes, mask):
        ctx.save_for_backward(dst, mask)
        return _segment_sum_fwd(val, dst, num_nodes, mask)

    @staticmethod
    def backward(ctx, g):
        from ..graph.linear_prims import masked_take  # graph imports this module

        dst, mask = ctx.saved_tensors
        return masked_take(g, dst, mask), None, None, None


def csr_segment_sum(
    val: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Segment sum of ``val`` [E, C] by non-decreasing ``dst`` [E] into
    ``num_nodes`` rows; ``mask`` [E] bool drops edges.  Differentiable in
    ``val``.

    CPU tensors take ``segment_sum_plain``; CUDA tensors launch the kernel
    (float32 or bfloat16) or raise.
    """
    return _SegmentSum.apply(val, dst, num_nodes, mask)


csr_segment_sum.launches = 0
