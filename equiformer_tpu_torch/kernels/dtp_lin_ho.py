"""Fused depthwise TP + linear heads of the force models, differentiable to
any order (K1, K5a, K5b, K5c).

Counterpart of ``equiformer_tpu/kernels/dtp_lin_ho.py``.  A force model
differentiates the energy with respect to positions, and force training
differentiates a loss of those forces with respect to the parameters, so the
fused op ``out = Linear_W(DTP(x, sh, w))`` is differentiated twice.  The op is
multilinear in its legs (out, x, sh, w, W): transposing it swaps which leg is
the output, so the single-output leg functions

    out = F_out(x, sh, w, W)      dx  = F_x(g, sh, w, W)
    dsh = F_sh(g, x, w, W)        dw  = F_w(g, x, sh, W)
    dW  = F_W(g, x, sh, w)        (g: what sits in the out leg)

are closed under differentiation.  Per edge, with dz = g W^T per irrep group
and component,

    dx[a+u]  += c * sh[col] * w[b+u] * dz[fc+u]
    dw[b+u]  += c * sh[col] * x[a+u] * dz[fc+u]
    dsh[col] += c * sum_u x[a+u] * w[b+u] * dz[fc+u]
    dW_g     += z[g,k]^T g[g,k]          (z the TP output, recomputed)

(w = 1 when shared weights are folded into W).  Rows at or past ``n_edges``
give zeros and add nothing to dW.  On the card each is one hand-written
kernel: F_out is K1 (``dtp_lin_fwd``, ``csrc/dtp_lin.cu``), an edge leg K5b
(``dtp_lin_leg``, ``csrc/dtp_lin_leg.cu``), F_W K5c (``dtp_lin_legW``,
``csrc/dtp_lin_legW.cu``), and the three edge legs of one ``g`` together K5a
(``dtp_lin_bwd3``, ``csrc/dtp_lin_bwd3.cu``), the force backward.  Each has
its plain version here (``dtp_lin_leg_plain``, ``dtp_lin_legW_plain``,
``dtp_lin_bwd3_plain``), which CPU tensors take.

``_Leg`` and ``_Bwd3`` are the ``torch.autograd.Function`` family: the
backward of each calls other members through ``apply``, so
``create_graph=True`` records them and the grad-of-grad of force training
stays on the fused kernels.  A shared ``w`` is folded into ``W`` outside the
ops (``fold_shared_weights``, plain torch), which carries the folded dW back
to ``W`` and ``w`` at every order.
"""

from __future__ import annotations

import torch

from . import _build
from .dtp import _SKIPPED_LEGS, skip_leg_grads  # noqa: F401  (re-exported)
from .dtp_lin import (
    BWD_TILE,
    DTPLinPlan,
    _check_n_edges,
    _check_operands,
    _sm_count,
    _zero_past,
    dtp_lin_fwd,
    dtp_lin_legW_plain,
    fold_shared_weights,
    plain_dz,
    plain_transposes,
)

LEGS = ("out", "x", "sh", "w", "W")  # canonical leg order of the op
EDGE_LEGS = ("x", "sh", "w")
LEGW_BLOCKS_PER_SM = 2  # persistent blocks (and dW partial rows) per SM of K5c


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
    dx, dw, dsh = plain_transposes(plan, x, sh, w, plain_dz(plan, W_flat, g),
                                   EDGE_LEGS[:2] if w is None else EDGE_LEGS)
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


def _check_edge_leg(plan: DTPLinPlan, out_leg: str) -> None:
    if out_leg not in EDGE_LEGS or (out_leg == "w" and plan.shared_weights):
        raise ValueError(f"no edge leg {out_leg!r} for this plan")


def dtp_lin_leg_plain(plan: DTPLinPlan, out_leg: str, g, x, sh, w, W_flat, n_edges=None):
    """Plain version of K5b: the edge leg ``out_leg`` ("x", "sh" or "w") of
    the fused op for ``g`` [E, d_out] in its out leg, [E, d_x], [E, d_sh] or
    [E, d_w] in g's dtype.  The operand of ``out_leg`` itself is not read
    (pass None); ``w`` is also None for a shared-weight plan."""
    _check_edge_leg(plan, out_leg)
    ops = {"x": x, "sh": sh, "w": w}
    ops[out_leg] = None
    dz = plain_dz(plan, W_flat, _zero_past(g, n_edges))
    res = plain_transposes(plan, ops["x"], ops["sh"], ops["w"], dz, (out_leg,))
    return res[("x", "w", "sh").index(out_leg)].to(g.dtype)


def _check_leg_operands(plan: DTPLinPlan, skip: str, g, x, sh, w, W_flat=None):
    """Shapes, dtypes and devices the leg kernels take, for every operand but
    the one named ``skip``; returns them contiguous (x with a row stride of
    0 or d_x)."""
    E = g.shape[0]
    _build.dtype_code(g)
    want = {"out": (g, plan.d_out), "x": (x, plan.d_x), "sh": (sh, plan.d_sh)}
    if not plan.shared_weights:
        want["w"] = (w, plan.d_w)
    elif w is not None:
        raise ValueError("shared weights are folded into W_flat before the kernel")
    for leg, (t, width) in want.items():
        if leg == skip:
            continue
        if t is None or t.shape != (E, width) or t.dtype != g.dtype or t.device != g.device:
            raise ValueError(f"the {leg} leg must be [{E}, {width}] in g's dtype and device")
    if W_flat is not None and (W_flat.shape != (plan.w_numel,) or W_flat.dtype != g.dtype
                               or W_flat.device != g.device):
        raise ValueError("W_flat does not match the plan or g's dtype and device")
    if skip != "x" and (x.stride(1) != 1 or x.stride(0) not in (0, plan.d_x)):
        x = x.contiguous()
    cont = lambda t: None if t is None else t.contiguous()  # noqa: E731
    return (g.contiguous(), None if skip == "x" else x, None if skip == "sh" else cont(sh),
            None if skip == "w" else cont(w), cont(W_flat))


def dtp_lin_leg(plan: DTPLinPlan, out_leg: str, g: torch.Tensor, x, sh, w,
                W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """K5b: one edge leg of the fused op, ``F_x(g, sh, w, W)`` [E, d_x],
    ``F_sh(g, x, w, W)`` [E, d_sh] or ``F_w(g, x, sh, W)`` [E, d_w]; the
    operand of ``out_leg`` is not read (pass None).  CPU tensors take
    ``dtp_lin_leg_plain``; CUDA tensors launch the kernel (float32 or
    bfloat16) or raise."""
    if g.device.type == "cpu":
        return dtp_lin_leg_plain(plan, out_leg, g, x, sh, w, W_flat, n_edges)
    _check_edge_leg(plan, out_leg)
    E, dev = g.shape[0], g.device
    g, x, sh, w, W_flat = _check_leg_operands(plan, out_leg, g, x, sh, w, W_flat)
    n_edges = _check_n_edges(n_edges, E, dev)
    gk, terms, coeffs, dwmap, wt_index, span_max, cols_pad_max = bwd3_tables(plan, dev)
    width = {"x": plan.d_x, "sh": plan.d_sh, "w": plan.d_w}[out_leg]
    alloc = torch.zeros if out_leg == "w" and plan.dw_has_dead_cols else torch.empty
    out = alloc((E, width), dtype=g.dtype, device=dev)
    if E == 0:
        return out
    WT = torch.cat([W_flat, W_flat.new_zeros(1)])[wt_index]
    err = _build.library().dtp_lin_leg(
        EDGE_LEGS.index(out_leg), _build.ptr(x), 0 if x is None else x.stride(0), plan.d_x,
        _build.ptr(sh), plan.d_sh, _build.ptr(w), plan.d_w, _build.ptr(WT), _build.ptr(g),
        plan.d_out, _build.ptr(n_edges), E, _build.ptr(gk), gk.shape[0], _build.ptr(terms),
        _build.ptr(coeffs), _build.ptr(dwmap), _build.ptr(out), span_max, cols_pad_max,
        plan.max_fan_stride, _build.dtype_code(g), _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_leg")
    dtp_lin_leg.launches += 1
    return out


dtp_lin_leg.launches = 0


def dtp_lin_legW(plan: DTPLinPlan, g: torch.Tensor, x: torch.Tensor, sh: torch.Tensor, w,
                 n_edges=None) -> torch.Tensor:
    """K5c: the head-weight leg ``F_W(g, x, sh, w)``, the gradient of the
    packed ``W_flat`` [w_numel] in float32 for ``g`` [E, d_out] in the out
    leg; z is recomputed and never written to device memory.  CPU tensors
    take ``dtp_lin_legW_plain``; CUDA tensors launch the kernel (float32 or
    bfloat16) or raise."""
    if g.device.type == "cpu":
        return dtp_lin_legW_plain(plan, g, x, sh, w, n_edges)
    E, dev = g.shape[0], g.device
    g, x, sh, w, _ = _check_leg_operands(plan, "W", g, x, sh, w)
    n_edges = _check_n_edges(n_edges, E, dev)
    dW = torch.zeros((plan.w_numel,), dtype=torch.float32, device=dev)
    if E == 0:
        return dW
    gk, terms, coeffs, _, _, _, cols_pad_max = plan.bwd_tables(dev)
    n_parts = min(-(-E // BWD_TILE), LEGW_BLOCKS_PER_SM * _sm_count(dev))
    part = torch.empty((n_parts, plan.w_numel), dtype=torch.float32, device=dev)
    err = _build.library().dtp_lin_legW(
        _build.ptr(x), x.stride(0), _build.ptr(sh), plan.d_sh, _build.ptr(w), plan.d_w,
        _build.ptr(g), plan.d_out, _build.ptr(n_edges), E, _build.ptr(gk), gk.shape[0],
        _build.ptr(terms), _build.ptr(coeffs), _build.ptr(part), n_parts, _build.ptr(dW),
        plan.w_numel, cols_pad_max, plan.max_fan_stride, _build.dtype_code(g),
        _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_legW")
    dtp_lin_legW.launches += 1
    return dW


dtp_lin_legW.launches = 0


def leg_occupancy(plan: DTPLinPlan, dtype: torch.dtype, out_leg: str) -> int:
    """Resident blocks per SM of K5b's ``out_leg`` kernel ("x", "sh", "w") or
    of K5c ("W") at this plan's shared memory; needs the card."""
    *_, span_max, cols_pad_max = bwd3_tables(plan, torch.device("cpu"))
    code = _build.dtype_code(torch.empty((), dtype=dtype))
    if out_leg == "W":
        blocks = _build.library().dtp_lin_legW_occupancy(cols_pad_max, plan.max_fan_stride, code)
    else:
        blocks = _build.library().dtp_lin_leg_occupancy(
            EDGE_LEGS.index(out_leg), plan.d_x, plan.d_sh, span_max, cols_pad_max,
            plan.max_fan_stride, code)
    if blocks < 0:
        _build.check(-blocks, "leg_occupancy")
    return blocks


def _leg_value(plan: DTPLinPlan, out_leg: str, n_edges, ops: dict) -> torch.Tensor:
    """``F_out_leg`` of the other legs' operands, through the kernel wrappers."""
    if out_leg == "out":
        return dtp_lin_fwd(plan, ops["x"], ops["sh"], ops["w"], ops["W"], n_edges)
    if out_leg == "W":
        return dtp_lin_legW(plan, ops["out"], ops["x"], ops["sh"], ops["w"], n_edges)
    return dtp_lin_leg(plan, out_leg, ops["out"], ops["x"], ops["sh"], ops["w"], ops["W"],
                       n_edges)


def _apply_leg(plan: DTPLinPlan, out_leg: str, n_edges, ops: dict, like: torch.Tensor):
    """``_Leg.apply`` on ``ops`` cast to the op's compute dtype, its result in
    ``like``'s dtype (the W leg comes back in float32)."""
    dt = next(ops[leg] for leg in ("sh", "x", "out") if ops[leg] is not None).dtype
    args = [None if leg == out_leg or ops[leg] is None else ops[leg].to(dt) for leg in LEGS]
    return _Leg.apply(plan, out_leg, n_edges, *args).to(like.dtype)


class _Leg(torch.autograd.Function):
    """One leg of the fused op as a function of the others: ``forward(plan,
    out_leg, n_edges, out, x, sh, w, W)`` with None in ``out_leg``'s slot
    (and in w's for a shared-weight plan).  The gradient of an operand is the
    leg function of that operand with the cotangent in ``out_leg``'s slot;
    the out leg's edge gradients (x, sh, w) come from one ``_Bwd3`` when at
    least two are asked for."""

    @staticmethod
    def forward(ctx, plan, out_leg, n_edges, *ops):
        ctx.plan, ctx.out_leg = plan, out_leg
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(n_edges, *ops)
        return _leg_value(plan, out_leg, n_edges, dict(zip(LEGS, ops)))

    @staticmethod
    def backward(ctx, c):
        if c is None:
            return (None,) * 8
        plan, out_leg = ctx.plan, ctx.out_leg
        n_edges, *saved = ctx.saved_tensors
        ops = dict(zip(LEGS, saved))
        live = [leg for leg, need in zip(LEGS, ctx.needs_input_grad[3:])
                if need and leg not in _SKIPPED_LEGS]
        grads = {}
        edge = [leg for leg in live if leg in EDGE_LEGS]
        if out_leg == "out" and len(edge) >= 2:
            outs = _Bwd3.apply(plan, n_edges, c, ops["x"], ops["sh"], ops["w"], ops["W"],
                               *(leg in edge for leg in EDGE_LEGS))
            grads = {leg: o for leg, o in zip(EDGE_LEGS, outs) if leg in edge}
            live = [leg for leg in live if leg not in edge]
        for leg in live:
            grads[leg] = _apply_leg(plan, leg, n_edges, {**ops, out_leg: c}, ops[leg])
        return (None, None, None) + tuple(grads.get(leg) for leg in LEGS)


class _Bwd3(torch.autograd.Function):
    """(dx, dsh, dw) = (F_x, F_sh, F_w)(g, ...) in one K5a launch, each None
    when not needed.  dx does not depend on x, dsh on sh, nor dw on w, so the
    backward differentiates each output through its own leg function: for
    the cotangent of output ``o`` and the operand ``t``, the leg function of
    ``t`` with the cotangent in ``o``'s slot."""

    @staticmethod
    def forward(ctx, plan, n_edges, g, x, sh, w, W, need_dx, need_dsh, need_dw):
        ctx.plan = plan
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(n_edges, g, x, sh, w, W)
        return dtp_lin_bwd3(plan, x, sh, w, W, g, n_edges, need_dx, need_dsh, need_dw)

    @staticmethod
    def backward(ctx, *cots):
        plan = ctx.plan
        n_edges, *saved = ctx.saved_tensors
        ops = dict(zip(LEGS, saved))
        live = [leg for leg, need in zip(LEGS, ctx.needs_input_grad[2:7])
                if need and leg not in _SKIPPED_LEGS]
        grads = {}
        for o, c in zip(EDGE_LEGS, cots):
            if c is None:
                continue
            for t in live:
                if t == o:
                    continue
                term = _apply_leg(plan, t, n_edges, {**ops, o: c}, ops[t])
                grads[t] = term if t not in grads else grads[t] + term
        return (None, None) + tuple(grads.get(leg) for leg in LEGS) + (None, None, None)


def dtp_lin_ho(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
               W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """Fused DTP + linear heads of the force models, differentiable to any
    order in x, sh, w and the head weights: [E, plan.d_out].  Same operands
    as ``dtp_lin``; a shared ``w`` is folded into ``W_flat`` here, outside
    the autograd ops.  The forward is K1; the backward K5a for the edge legs
    (one K5b leg when only one is needed) and K5c for ``W_flat``; under
    ``create_graph=True`` their own backwards are further legs."""
    w, W_flat = fold_shared_weights(plan, w, W_flat)
    return _Leg.apply(plan, "out", n_edges, None, x, sh, w, W_flat)
