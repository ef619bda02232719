"""Masked segment reductions over padded edge/node arrays.

Counterpart of ``equiformer_tpu.graph.segment`` for the inference slice.
``segment_sum`` takes the CSR kernel (``kernels/segment_csr.py``) under the
JAX package's eligibility rule (``_csr_eligible``): first order, rank 2 or
3, at least 128 flat columns.  The ids must be non-decreasing, as every
caller's are (edges are dst-sorted, nodes graph-sorted).  The kernel module itself
decides by device: CPU tensors run its plain version, CUDA tensors the kernel.
"""

from __future__ import annotations

import math

import torch

from ..kernels.segment_csr import csr_segment_sum, segment_sum_plain

CSR_MIN_COLS = 128


def _flat_cols(data) -> int:
    return math.prod(data.shape[1:])


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    """Sum ``data`` [E, ...] into ``num_segments`` rows by the non-decreasing
    ``segment_ids``."""
    if data.dim() in (2, 3) and _flat_cols(data) >= CSR_MIN_COLS:
        shape = data.shape
        out = csr_segment_sum(data.reshape(shape[0], -1), segment_ids,
                              num_segments, mask=mask)
        return out.reshape((num_segments,) + tuple(shape[1:]))
    return segment_sum_plain(data, segment_ids, num_segments, mask)


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
    denom = segment_sum_plain(ex, segment_ids, num_segments)
    denom = torch.clamp(denom, min=1e-16)
    return ex / denom[segment_ids]


def active_edge_bound(mask: torch.Tensor) -> torch.Tensor:
    """1 + index of the last real edge (0 if none), as an int32 device scalar:
    the fused DTP kernel writes zeros past it without a host sync."""
    E = mask.shape[0]
    idx = torch.arange(1, E + 1, dtype=torch.int32, device=mask.device)
    return torch.amax(torch.where(mask, idx, torch.zeros_like(idx)))
