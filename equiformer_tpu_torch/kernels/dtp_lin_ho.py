"""Fused depthwise TP + linear heads on the force path (K1 forward, K5a backward).

Counterpart of ``equiformer_tpu/kernels/dtp_lin_ho.py`` at first order.  A
force evaluation differentiates the energy with respect to positions, so the
fused op needs the gradient of the SH too.  In the JAX package the
higher-order DTP's transpose binds ``_bwd3_p``, the Pallas ``_bwd3_kernel``:
dx, dsh and dw in one pass from the cotangent ``g`` of the fused output.
Per edge, with dz = g W^T per irrep group and component,

    dx[a+u]  += c * sh[col] * w[b+u] * dz[fc+u]
    dw[b+u]  += c * sh[col] * x[a+u] * dz[fc+u]
    dsh[col] += c * sum_u x[a+u] * w[b+u] * dz[fc+u]

(w = 1 when shared weights are folded into W).  Rows at or past ``n_edges``
get zero gradients.  The CUDA kernel is ``csrc/dtp_lin_bwd3.cu``;
``dtp_lin_bwd3_plain`` is its plain version, written out per group and TP
path.  The forward is K1 (``dtp_lin_fwd``), as the JAX ``out`` leg reuses
the first-order forward kernel.

``dtp_lin_ho`` raises ``NotImplementedError`` when its backward would have
to produce the gradient of the packed head weights or run under
``create_graph=True``: those are the W leg and the leg family of the
grad-of-grad training path, which is not ported.
"""

from __future__ import annotations

import torch

from . import _build
from .dtp_lin import (
    DTPLinPlan,
    _check_n_edges,
    _check_operands,
    _zero_past,
    dtp_lin_fwd,
    fold_shared_weights,
    plain_dz,
    plain_transposes,
)

_TRAINING_SLICE = ("the grad-of-grad training path of the force models (the W leg and "
                   "the leg family of equiformer_tpu/kernels/dtp_lin_ho.py) is not ported")


def bwd3_tables(plan: DTPLinPlan, device: torch.device):
    """``plan.bwd_tables`` with the term rows of each (group, component)
    stably sorted by SH column, so the kernel's running dsh sum is flushed
    once per column rather than once per term: (gk, terms, coeffs, dwmap,
    wt_index, span_max, cols_pad_max)."""
    key = ("bwd3", device)
    tabs = plan._tables.get(key)
    if tabs is not None:
        return tabs
    gk, terms, coeffs, *rest = plan.bwd_tables(device)
    order = []
    for begin, end in gk[:, 4:6].tolist():
        rows = list(range(begin, end))
        order.extend(sorted(rows, key=lambda t: int(terms[t, 1])))
    idx = torch.as_tensor(order, dtype=torch.int64, device=device)
    tabs = (gk, terms[idx].contiguous(), coeffs[idx].contiguous(), *rest)
    plan._tables[key] = tabs
    return tabs


def dtp_lin_bwd3_plain(plan: DTPLinPlan, x, sh, w, W_flat, g, n_edges=None):
    """Plain version of K5a: (dx [E, d_x], dsh [E, d_sh], dw [E, d_w] or None
    when ``w`` is None) for the cotangent ``g`` [E, d_out] of
    ``dtp_lin_plain`` on the same operands; no gradient of W."""
    g = _zero_past(g, n_edges)
    dx, dw, dsh = plain_transposes(plan, x, sh, w, plain_dz(plan, W_flat, g), True)
    return dx.to(x.dtype), dsh.to(sh.dtype), None if dw is None else dw.to(w.dtype)


def dtp_lin_bwd3(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w, W_flat: torch.Tensor,
                 g: torch.Tensor, n_edges=None, need_dx: bool = True, need_dsh: bool = True,
                 need_dw: bool = True):
    """K5a: (dx, dsh, dw) for the cotangent ``g`` [E, d_out] of
    ``dtp_lin_fwd`` on the same operands, each None when not needed (dw is
    None for a shared-weight plan).  CPU tensors take ``dtp_lin_bwd3_plain``;
    CUDA tensors launch the kernel (float32 or bfloat16) or raise.  One
    launch per call, whatever is needed."""
    need_dw = need_dw and w is not None
    if x.device.type == "cpu":
        dx, dsh, dw = dtp_lin_bwd3_plain(plan, x, sh, w, W_flat, g, n_edges)
        return dx if need_dx else None, dsh if need_dsh else None, dw if need_dw else None
    E = sh.shape[0]
    x, sh, w, W_flat = _check_operands(plan, x, sh, w, W_flat)
    if g.shape != (E, plan.d_out) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"cotangent must be [{E}, {plan.d_out}] in x's dtype and device")
    g = g.contiguous()
    n_edges = _check_n_edges(n_edges, E, x.device)
    gk, terms, coeffs, dwmap, wt_index, span_max, cols_pad_max = bwd3_tables(plan, x.device)
    dev = x.device
    empty = lambda d: torch.empty((E, d), dtype=x.dtype, device=dev)  # noqa: E731
    dx = empty(plan.d_x) if need_dx else None
    dsh = empty(plan.d_sh) if need_dsh else None
    dw = None
    if need_dw:
        dw = (torch.zeros if plan.dw_has_dead_cols else torch.empty)(
            (E, plan.d_w), dtype=x.dtype, device=dev)
    if E == 0:
        return dx, dsh, dw
    WT = torch.cat([W_flat, W_flat.new_zeros(1)])[wt_index]
    err = _build.library().dtp_lin_bwd3(
        _build.ptr(x), x.stride(0), plan.d_x, _build.ptr(sh), plan.d_sh, _build.ptr(w),
        plan.d_w, _build.ptr(WT), _build.ptr(g), plan.d_out, _build.ptr(n_edges), E,
        _build.ptr(gk), gk.shape[0], _build.ptr(terms), _build.ptr(coeffs), _build.ptr(dwmap),
        _build.ptr(dx), _build.ptr(dsh), _build.ptr(dw), span_max, cols_pad_max,
        plan.max_fan_stride, _build.dtype_code(x), _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_bwd3")
    dtp_lin_bwd3.launches += 1
    return dx, dsh, dw


dtp_lin_bwd3.launches = 0


def bwd3_occupancy(plan: DTPLinPlan, dtype: torch.dtype, need_dx: bool = True,
                   need_dw: bool = True) -> int:
    """Resident blocks per SM of the K5a kernel at this plan's shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the card."""
    *_, span_max, cols_pad_max = bwd3_tables(plan, torch.device("cpu"))
    code = _build.dtype_code(torch.empty((), dtype=dtype))
    blocks = _build.library().dtp_lin_bwd3_occupancy(
        plan.d_x if need_dx else 0, plan.d_sh,
        span_max if (need_dw and not plan.shared_weights) else 0, cols_pad_max,
        plan.max_fan_stride, code)
    if blocks < 0:
        _build.check(-blocks, "dtp_lin_bwd3_occupancy")
    return blocks


class _DTPLinHO(torch.autograd.Function):
    """K1 forward, K5a backward: gradients for x, sh and w, not for W_flat."""

    @staticmethod
    def forward(ctx, plan, x, sh, w, W_flat, n_edges):
        ctx.plan = plan
        ctx.save_for_backward(x, sh, w, W_flat, n_edges)
        return dtp_lin_fwd(plan, x, sh, w, W_flat, n_edges)

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise NotImplementedError(f"create_graph=True through dtp_lin_ho: {_TRAINING_SLICE}")
        if ctx.needs_input_grad[4]:
            raise NotImplementedError(
                f"dtp_lin_ho computes no gradient of the head weights: {_TRAINING_SLICE}")
        x, sh, w, W_flat, n_edges = ctx.saved_tensors
        _, need_dx, need_dsh, need_dw, _, _ = ctx.needs_input_grad
        dx, dsh, dw = dtp_lin_bwd3(ctx.plan, x, sh, w, W_flat, g, n_edges,
                                   need_dx, need_dsh, need_dw)
        return None, dx, dsh, dw, None, None


def dtp_lin_ho(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
               W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """Fused DTP + linear heads of the force models, differentiable in x, sh
    and w: [E, plan.d_out].  Same operands as ``dtp_lin``; a shared ``w`` is
    folded into ``W_flat`` here, outside the autograd op.  The backward is
    K5a (``dtp_lin_bwd3``) and raises ``NotImplementedError`` for a gradient
    of ``W_flat`` (or of a shared ``w``) and under ``create_graph=True``."""
    w, W_flat = fold_shared_weights(plan, w, W_flat)
    return _DTPLinHO.apply(plan, x, sh, w, W_flat, n_edges)
