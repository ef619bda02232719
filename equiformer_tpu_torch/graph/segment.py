"""Masked segment reductions over padded edge/node arrays.

Counterpart of ``equiformer_tpu.graph.segment``.  ``segment_sum`` takes the
CSR kernel (``kernels/segment_csr.py``) under the JAX package's eligibility
rule (``_csr_eligible``): rank 2 or 3, at least 128 flat columns.  The port
has no grad-of-grad path yet, so the JAX package's ``higher_order`` routing
(its linear primitives) reduces here to the same first-order ops.
``take_rows`` is a row gather whose backward is a sorted segment sum (the
rev twin takes the src side there); ``gather_add`` is the message gather
built from two of them.  The ids must be non-decreasing, as every caller's
are (edges are dst-sorted, nodes graph-sorted).  The kernel module itself
decides by device: CPU tensors run its plain version, CUDA tensors the kernel.
"""

from __future__ import annotations

import math

import torch

from ..kernels.segment_csr import csr_segment_sum, segment_sum_plain

CSR_MIN_COLS = 128


def _flat_cols(data) -> int:
    return math.prod(data.shape[1:])


def fixed_order_segment_sum(data, segment_ids, num_segments: int, mask=None):
    """The model's segment sums too narrow for the CSR kernel, with the same
    bits on every run, so that a force evaluation repeats bit for bit.  On
    the card an accumulating ``index_put_``: it sorts the ids and sums each
    row in a fixed order, where ``index_add_`` adds with float atomics.  On
    the CPU ``segment_sum_plain``, whose ``index_add_`` is a serial loop.
    A QM9 step runs one (the per-graph readout), a force evaluation seven
    (the readout and the 6 softmax denominators); ``chip_smoke.py`` times
    them against ``index_add_``."""
    if not data.is_cuda:
        return segment_sum_plain(data, segment_ids, num_segments, mask)
    acc_dtype = torch.promote_types(data.dtype, torch.float32)
    v = data.to(acc_dtype)
    if mask is not None:
        v = torch.where(mask.reshape(mask.shape + (1,) * (v.dim() - 1)), v,
                        torch.zeros_like(v))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc_dtype,
                      device=data.device)
    return out.index_put_((segment_ids,), v, accumulate=True).to(data.dtype)


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    """Sum ``data`` [E, ...] into ``num_segments`` rows by the non-decreasing
    ``segment_ids``."""
    if data.dim() in (2, 3) and _flat_cols(data) >= CSR_MIN_COLS:
        shape = data.shape
        out = csr_segment_sum(data.reshape(shape[0], -1), segment_ids,
                              num_segments, mask=mask)
        return out.reshape((num_segments,) + tuple(shape[1:]))
    return fixed_order_segment_sum(data, segment_ids, num_segments, mask)


def scaled_scatter_sum(data, segment_ids, num_segments: int, avg_aggregate_num: float,
                       mask=None):
    """Degree-normalized aggregation: segment sum / sqrt(avg_aggregate_num)."""
    return segment_sum(data, segment_ids, num_segments, mask) / (
        avg_aggregate_num ** 0.5
    )


def segment_softmax(scores, segment_ids, num_segments: int, mask=None):
    """Softmax of ``scores`` [E, ...] within segments, with the global
    per-column max as the stability shift (the JAX package's
    ``_global_shift_softmax``): masked entries get probability 0 and empty
    segments all zeros."""
    emask = None
    masked = scores
    if mask is not None:
        emask = mask.reshape(mask.shape + (1,) * (scores.dim() - 1))
        neg = torch.finfo(scores.dtype).min
        masked = torch.where(emask, scores, torch.full_like(scores, neg))
    m = torch.amax(masked, dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    shifted = scores - m
    if emask is not None:
        shifted = torch.where(emask, shifted, torch.zeros_like(shifted))
        ex = torch.where(emask, torch.exp(shifted), torch.zeros_like(shifted))
    else:
        ex = torch.exp(shifted)
    denom = fixed_order_segment_sum(ex, segment_ids, num_segments)
    denom = torch.clamp(denom, min=1e-16)
    return ex / denom[segment_ids]


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, idx, dst, perm):
        ctx.num_rows = data.shape[0]
        ctx.save_for_backward(dst, perm)
        return data[idx]

    @staticmethod
    def backward(ctx, g):
        dst, perm = ctx.saved_tensors
        if perm is not None:
            g = g[perm]
        return segment_sum(g, dst, ctx.num_rows), None, None, None


def take_rows(data, idx, dst, perm=None):
    """``data[idx]`` (rows of ``data`` per edge) whose backward is a segment
    sum over the non-decreasing ``dst`` (the CSR kernel at >= 128 columns),
    not autograd's unsorted scatter-add.  ``idx`` is ``dst`` itself, or the
    src of a symmetric edge list with ``perm`` its reverse-twin permutation:
    summing g over src equals summing g[perm] over dst.  Padded edges map
    through ``perm`` arbitrarily; their cotangents must be zero."""
    return _TakeRows.apply(data, idx, dst, perm)


def gather_add(xs, xd, src, dst, num_nodes: int, rev):
    """``xs[src] + xd[dst]`` (``num_nodes`` rows each) whose backward is two
    segment sums over the non-decreasing ``dst`` (``take_rows``)."""
    if xs.shape[0] != num_nodes or xd.shape[0] != num_nodes:
        raise ValueError(f"gather_add takes [{num_nodes}, ...] node features")
    return take_rows(xs, src, dst, rev) + take_rows(xd, dst, dst)


def active_edge_bound(mask: torch.Tensor) -> torch.Tensor:
    """1 + index of the last real edge (0 if none), as an int32 device scalar:
    the fused DTP kernel writes zeros past it without a host sync."""
    E = mask.shape[0]
    idx = torch.arange(1, E + 1, dtype=torch.int32, device=mask.device)
    return torch.amax(torch.where(mask, idx, torch.zeros_like(idx)))
