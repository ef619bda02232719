"""Masked segment reductions over padded edge/node arrays.

Counterpart of ``equiformer_tpu.graph.segment``.  Every sum and gather here
goes through ``graph/linear_prims.py``, the family closed under
differentiation, so the force evaluation's backward and force training's
grad-of-grad stay on the sorted lowerings: ``segment_sum`` takes the CSR
kernel (``kernels/segment_csr.py``) under the JAX package's eligibility rule
(rank 2 or 3, at least 128 flat columns) and ``fixed_order_segment_sum``
below it; ``take_rows`` is a row gather whose backward is a sorted segment
sum (the rev twin takes the src side there); ``gather_add`` is the message
gather built from two of them.  The ids must be non-decreasing, as every
caller's are (edges are dst-sorted, nodes graph-sorted).  The kernel module
itself decides by device: CPU tensors run its plain version, CUDA tensors
the kernel.
"""

from __future__ import annotations

import torch

from . import linear_prims
from .linear_prims import CSR_MIN_COLS, fixed_order_segment_sum  # noqa: F401


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    """Sum ``data`` [E, ...] into ``num_segments`` rows by the non-decreasing
    ``segment_ids`` (``linear_prims.segsum_rows``)."""
    return linear_prims.segsum_rows(data, segment_ids, num_segments, mask)


def scaled_scatter_sum(data, segment_ids, num_segments: int, avg_aggregate_num: float,
                       mask=None):
    """Degree-normalized aggregation: segment sum / sqrt(avg_aggregate_num)."""
    return segment_sum(data, segment_ids, num_segments, mask) / (
        avg_aggregate_num ** 0.5
    )


def segment_softmax(scores, segment_ids, num_segments: int, mask=None,
                    higher_order: bool = False):
    """Softmax of ``scores`` [E, ...] within segments: masked entries get
    probability 0 and empty segments all zeros.

    The stability shift follows the JAX package's two routes.  By default
    (first order, as the fused attention combine K4) it is the global
    per-column max (``_global_shift_softmax``).  With ``higher_order`` (the
    force models) it is each segment's own max over its unmasked entries,
    detached (``stop_gradient``; empty segments shift by 0), so a segment
    whose scores all lie far below another segment's never underflows to
    zero, and no order of differentiation runs a max's backward.  The
    per-segment max is a scatter-``amax``, which is exact in any order, so
    the result repeats bit for bit."""
    emask = None
    masked = scores
    if mask is not None:
        emask = mask.reshape(mask.shape + (1,) * (scores.dim() - 1))
        neg = torch.finfo(scores.dtype).min
        masked = torch.where(emask, scores, torch.full_like(scores, neg))
    if higher_order:
        with torch.no_grad():
            idx = segment_ids.reshape(segment_ids.shape + (1,) * (scores.dim() - 1))
            m = torch.full((num_segments,) + tuple(scores.shape[1:]), float("-inf"),
                           dtype=scores.dtype, device=scores.device)
            m = m.scatter_reduce(0, idx.expand_as(masked), masked, "amax")
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))[segment_ids]
    else:
        m = torch.amax(masked, dim=0)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    shifted = scores - m
    if emask is not None:
        shifted = torch.where(emask, shifted, torch.zeros_like(shifted))
        ex = torch.where(emask, torch.exp(shifted), torch.zeros_like(shifted))
    else:
        ex = torch.exp(shifted)
    denom = linear_prims.segsum_rows(ex, segment_ids, num_segments)
    denom = torch.clamp(denom, min=1e-16)
    return ex / linear_prims.take_rows(denom, segment_ids, segment_ids)


def take_rows(data, idx, dst, perm=None):
    """``data[idx]`` (rows of ``data`` per edge) whose backward is a segment
    sum over the non-decreasing ``dst`` (the CSR kernel at >= 128 columns),
    not autograd's unsorted scatter-add, at every order of differentiation
    (``linear_prims.take_rows``).  ``idx`` is ``dst`` itself, or the src of a
    symmetric edge list with ``perm`` its reverse-twin permutation: summing g
    over src equals summing g[perm] over dst.  Padded edges map through
    ``perm`` arbitrarily; their cotangents must be zero."""
    return linear_prims.take_rows(data, idx, dst, perm)


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
