"""CSR segment sum over dst-sorted edges (K3).

Counterpart of ``equiformer_tpu/kernels/segment_csr_pallas.py``
(``csr_segment_sum``, Pallas ``_kernel``): ``out[u] = sum of val[e] over the
edges with dst[e] == u``, accumulated in fp32 and written in val's dtype.
The CUDA kernel is ``csrc/segment_csr.cu``: one launch per call, in which
each block finds its node range's edges by a search over the sorted
``dst`` (read in its own int64 or int32 type), cuts them into equal slices
across its warps whatever the degrees, and sums the live rows with 16-byte
loads, four edges in flight.  The wrapper only checks shapes and picks the
vector width (``vector_width``) and the node range of a block
(``nodes_per_block``); it builds no row pointers.  K4
(``attn_csr.py``) walks the edges the same way (``csrc/csr_walk.cuh``).
``segment_sum_plain`` is its plain PyTorch version, used for CPU tensors
and as the on-card reference.  The op is differentiable in ``val`` to any
order: the backward is the gather ``take_rows(g, dst)`` of
``graph/linear_prims.py`` with masked rows zeroed
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


VECTOR_BYTES = 16  # one load a lane in csrc/segment_csr.cu and csrc/attn_csr.cu
_INDEX_DTYPES = (torch.int64, torch.int32)  # dst as the kernel reads it
EDGES_PER_BLOCK = 256  # a block's edges on average: 16 warps' slices of 16


def vector_width(C: int, itemsize: int, val_ptr: int, out_ptr: int) -> int:
    """Elements a lane of K3 (or K4) loads at once: 16 bytes' worth when every row
    of the [E, C] operand and of the output starts on a 16-byte boundary
    (``C * itemsize`` and both base pointers multiples of 16), else 1 (one
    scalar column a lane: a tail of C or an unaligned row)."""
    if (C * itemsize) % VECTOR_BYTES or val_ptr % VECTOR_BYTES or out_ptr % VECTOR_BYTES:
        return 1
    return VECTOR_BYTES // itemsize


def nodes_per_block(num_nodes: int, E: int) -> int:
    """The node range of one K3 (or K4) block: about ``EDGES_PER_BLOCK`` edges at
    the batch's mean degree (E / num_nodes), at least 1 node."""
    return max(1, min(num_nodes, -(-EDGES_PER_BLOCK * num_nodes // max(E, 1))))


def _segment_sum_fwd(val, dst, num_nodes: int, mask):
    if not val.is_cuda:
        return segment_sum_plain(val, dst, num_nodes, mask)
    # the checks are few and cheap: at the MD17 shapes the host work is what a call costs
    if val.dim() != 2 or dst.dim() != 1 or dst.shape[0] != val.shape[0]:
        raise ValueError(f"val must be [E, C] and dst [E], got {val.shape}, {dst.shape}")
    dev = val.get_device()
    if dst.dtype not in _INDEX_DTYPES or dst.get_device() != dev:
        raise ValueError("dst must be int64 or int32 on val's device")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != dst.shape
                             or mask.get_device() != dev):
        raise ValueError("mask must be bool [E] on val's device")
    code = _build.dtype_code(val)
    if not val.is_contiguous():
        val = val.contiguous()
    if not dst.is_contiguous():
        dst = dst.contiguous()
    if mask is not None and not mask.is_contiguous():
        mask = mask.contiguous()
    E, C = val.shape
    out = val.new_empty((num_nodes, C))
    if num_nodes == 0 or C == 0:
        return out
    vp, op = val.data_ptr(), out.data_ptr()
    err = _build.library().csr_segment_sum(
        vp, C, dst.data_ptr(), dst.element_size(), E, 0 if mask is None else mask.data_ptr(),
        op, num_nodes, vector_width(C, val.element_size(), vp, op),
        nodes_per_block(num_nodes, E), code, _build.stream_ptr(),
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
    (float32 or bfloat16) or raise.  Without a gradient to track the call
    skips the autograd node (the host work is what the small MD17 sums pay).
    """
    if torch.is_grad_enabled() and val.requires_grad:
        return _SegmentSum.apply(val, dst, num_nodes, mask)
    return _segment_sum_fwd(val, dst, num_nodes, mask)


csr_segment_sum.launches = 0
