"""Row gathers, segment sums and row permutations differentiable to any order.

Counterpart of ``equiformer_tpu/graph/linear_prims.py``.  Force training
differentiates a loss of ``forces = -dE/dpos`` with respect to the
parameters, so every gather and segment sum of the model is differentiated
twice.  The three ops form a family closed under differentiation, so every
order stays on the sorted lowerings (the CSR kernel K3 for wide sums, the
fixed-order sum for narrow ones) and never reaches autograd's unsorted
scatter-add, whose float atomics would make a training step differ from run
to run:

    take(x, idx)     backward: segsum(perm(g), t_ids)
    segsum(v, ids)   backward: take(g, ids)
    perm(x, p)       backward: perm(g, p_inv)

``take_rows`` carries its own backward recipe as operands: ``t_ids`` are
non-decreasing segment ids that sort the cotangent rows (dst of a dst-sorted
edge list) and ``t_perm`` an optional involutive row permutation applied
first (the reverse-twin trick: summing g over src equals summing g[rev] over
dst).
"""

from __future__ import annotations

import math

import torch

from ..kernels.segment_csr import csr_segment_sum, segment_sum_plain

__all__ = ["take_rows", "segsum_rows", "permute_rows", "fixed_order_segment_sum"]

CSR_MIN_COLS = 128


def fixed_order_segment_sum(data, segment_ids, num_segments: int, mask=None):
    """The model's segment sums too narrow for the CSR kernel, with the same
    bits on every run, so that a force evaluation and a training step repeat
    bit for bit.  On the card an accumulating ``index_put_``: it sorts the
    ids and sums each row in a fixed order, where ``index_add_`` adds with
    float atomics.  On the CPU ``segment_sum_plain``, whose ``index_add_`` is
    a serial loop.  No autograd of its own: ``segsum_rows`` wraps it."""
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


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, t_ids, t_perm):
        ctx.num_rows = x.shape[0]
        ctx.save_for_backward(t_ids, t_perm)
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        t_ids, t_perm = ctx.saved_tensors
        if t_perm is not None:
            g = permute_rows(g, t_perm)  # an involution
        return segsum_rows(g, t_ids, ctx.num_rows), None, None, None


class _NarrowSegSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, ids, num_segments, mask):
        ctx.save_for_backward(ids, mask)
        return fixed_order_segment_sum(v, ids, num_segments, mask)

    @staticmethod
    def backward(ctx, g):
        ids, mask = ctx.saved_tensors
        return masked_take(g, ids, mask), None, None, None


class _Perm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, perm_inv):
        ctx.save_for_backward(perm, perm_inv)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        perm, perm_inv = ctx.saved_tensors
        return permute_rows(g, perm_inv, perm), None, None


def take_rows(x, idx, t_ids, t_perm=None):
    """``x[idx]`` whose backward is the sorted segment sum
    ``segsum_rows(g[t_perm], t_ids)``: ``idx`` is ``t_ids`` itself, or the
    src of a symmetric edge list with ``t_ids`` its dst and ``t_perm`` the
    reverse-twin permutation (an involution; rows whose cotangent is zero may
    map anywhere)."""
    return _Take.apply(x, idx, t_ids, t_perm)


def masked_take(g, ids, mask):
    """The backward of a masked segment sum: ``take_rows(g, ids)`` with the
    masked rows zeroed."""
    gd = take_rows(g, ids, ids)
    if mask is None:
        return gd
    return torch.where(mask.reshape(mask.shape + (1,) * (gd.dim() - 1)), gd,
                       torch.zeros_like(gd))


def segsum_rows(v, ids, num_segments: int, mask=None):
    """Sum ``v`` [E, ...] into ``num_segments`` rows by the non-decreasing
    ``ids``; ``mask`` [E] bool drops rows.  Rank 2 or 3 with at least 128
    flat columns takes the CSR kernel (``csr_segment_sum``, the JAX package's
    eligibility rule), anything narrower ``fixed_order_segment_sum``; the
    backward of both is ``take_rows``."""
    if v.dim() in (2, 3) and math.prod(v.shape[1:]) >= CSR_MIN_COLS:
        out = csr_segment_sum(v.reshape(v.shape[0], -1), ids, num_segments, mask=mask)
        return out.reshape((num_segments,) + tuple(v.shape[1:]))
    return _NarrowSegSum.apply(v, ids, num_segments, mask)


def permute_rows(x, perm, perm_inv=None):
    """``x[perm]`` for a permutation; the backward gathers by ``perm_inv``
    (``perm`` itself by default: an involution)."""
    return _Perm.apply(x, perm, perm if perm_inv is None else perm_inv)
