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
kernel: F_out is K1 (``dtp_lin_fwd``, ``csrc/dtp_lin.cu``); every edge leg
runs on K2's launch 1 (``csrc/dtp_lin_bwd.cu``), a block per (16-edge tile,
irrep group): an edge leg alone K5b (``dtp_lin_leg``: the x and w legs
``k2::edge_leg_kernel``, the sh leg ``k2::sh_leg_kernel``) and the three
edge legs of one ``g`` together K5a (``dtp_lin_bwd3``, ``k2::bwd3_kernel``),
the force backward, whose dsh sum has one fixed order; F_W is K5c
(``dtp_lin_legW``, K2's launch 2).  Each has its plain version here
(``dtp_lin_leg_plain``, ``dtp_lin_legW_plain``, ``dtp_lin_bwd3_plain``),
which CPU tensors take.

``_Leg`` and ``_Bwd3`` are the ``torch.autograd.Function`` family: the
backward of each calls other members through ``apply``, so
``create_graph=True`` records them and the grad-of-grad of force training
stays on the fused kernels.  A shared ``w`` is folded into ``W`` outside the
ops (``fold_shared_weights``, plain torch), which carries the folded dW back
to ``W`` and ``w`` at every order.

With the radial fold (JAX's ``EQUIFORMER_TPU_FOLD_RADIAL_HO``) the edge
operand is ``(h, [Wr; offset])``, ``w = [h, 1] @ [Wr; offset]``, and the op
is multilinear in six legs (``LEGS_RAD``: out, x, sh, h, Wr, W; the edge
legs x, sh, h), as JAX's ``_LEGS_RAD`` extends ``_LEGS``.  The same
``_Leg`` / ``_Bwd3`` family carries it: the out leg is K7-F
(``dtp_lin_rad_fwd``, ``csrc/dtp_lin.cu``: K1's block with w built from h
on the tensor cores), the x / sh / h legs K7-L (``dtp_lin_rad_leg``,
``csrc/dtp_lin_bwd.cu``: K5b's legs on K2's launch 1 with w built, or dh =
dw Wr^T taken, on the tensor cores, dw on chip), the W leg K7-LW
(``dtp_lin_rad_legW``, ``csrc/dtp_lin_bwd.cu``: K5c's launch with each
step's w rebuilt from h on the tensor cores), the Wr leg
K7-Wr (``dtp_lin_rad_legWr``, ``csrc/dtp_lin_bwd.cu``: K5b's w leg, then
[h, 1]^T dw on the tensor cores over K2's edge ranges, their fp32 partial
rows summed in order) and the three edge legs of one ``g`` together K7-B3
(``dtp_lin_rad_bwd3``, ``csrc/dtp_lin_bwd.cu``: K5a's launch with the
fold, ``k2::rad_bwd3_kernel``, w built and dh = dw Wr^T taken on the tensor
cores, dw on chip); all but K7-Wr, which reads no [Wr; offset], build w
from (h, [Wr; offset]) on chip.  Plain versions:
``dtp_lin_rad_leg_plain``, ``dtp_lin_rad_legW_plain``,
``dtp_lin_rad_legWr_plain``, ``dtp_lin_rad_bwd3_plain``.

The ones-column rule (``_put``).  The port's op is affine in h (the kernels
append h's ones column themselves); JAX's is linear in the padded ``[h, 1,
0...]`` that ``plan.pad_h`` builds outside its primitives.  So a tangent or
a cotangent carried in h's slot has 0, not 1, in that column: the legs
called with one there take ``[Wr; 0]`` (a ``torch.cat``, so autograd gives
the offset nothing through them) and K7-Wr's offset row is 0.
"""

from __future__ import annotations

import torch

from . import _build
from .dtp import _SKIPPED_LEGS, skip_leg_grads  # noqa: F401  (re-exported)
from .dtp_lin import (
    DTPLinPlan,
    _check_n_edges,
    _check_operands,
    _k2_call,
    _zero_past,
    dtp_lin_fwd,
    dtp_lin_legW_plain,
    dtp_lin_rad_fwd,
    fold_gather,
    fold_shared_weights,
    k2_packed_W,
    k7_wr_tiles,
    plain_dz,
    plain_transposes,
    radial_dh_plain,
    radial_dWrs_plain,
    radial_w_plain,
)

LEGS = ("out", "x", "sh", "w", "W")  # canonical leg order of the op
EDGE_LEGS = ("x", "sh", "w")
# a radial-folded plan's legs: w = [h, 1] @ [Wr; offset] splits w's slot in two
LEGS_RAD = ("out", "x", "sh", "h", "Wr", "W")
EDGE_LEGS_RAD = ("x", "sh", "h")
# K5c's and K7-LW's launch-2 blocks per SM (``k2_ranges``), apart from K2's:
# at MD17's 2944 edges one 64-edge step a range
LEGW_DW_BLOCKS_PER_SM = 32
# the leg argument of the dsh launches on K2's launch 1 (csrc/dtp_lin_bwd.cu
# k2::Leg1): K5b's sh leg, K5a
DSH_LEGS = {"sh": 1, "bwd3": 4}


def dtp_lin_bwd3_plain(plan: DTPLinPlan, x, sh, w, W_flat, g, n_edges=None):
    """Plain version of K5a: (dx [E, d_x], dsh [E, d_sh], dw [E, d_w] or None
    when ``w`` is None) for the cotangent ``g`` [E, d_out] of
    ``dtp_lin_plain`` on the same operands; no gradient of W."""
    g = _zero_past(g, n_edges)
    dx, dw, dsh = plain_transposes(plan, x, sh, w, plain_dz(plan, W_flat, g),
                                   EDGE_LEGS[:2] if w is None else EDGE_LEGS)
    return dx.to(x.dtype), dsh.to(sh.dtype), None if dw is None else dw.to(w.dtype)


def _dsh_launch(plan: DTPLinPlan, leg: str, g, x, sh, w, W_flat, n_edges, dx, dsh,
                dw) -> None:
    """K5a (``leg`` "bwd3": two or three of dx, dsh, dw, each None when not
    asked for) or K5b's sh leg ("sh": dsh alone, sh None) on K2's launch 1,
    on checked operands and K2's tables, a block per (16-edge tile, irrep
    group): at MD17's 2944 edges the tiles alone make 184 blocks of one an
    SM (1.4 waves on 132 SMs).  With more than one group the dx and dsh
    partials, one [E, width] fp32 per group, are summed in group order."""
    E, dev, n_split = g.shape[0], g.device, len(plan.groups)
    scratch = lambda out, width: (  # noqa: E731
        torch.empty((n_split, E, width), dtype=torch.float32, device=dev)
        if out is not None and n_split > 1 else None)
    part, part_sh = scratch(dx, plan.d_x), scratch(dsh, plan.d_sh)
    _k2_call("dtp_lin_bwd3", plan, g, x, sh, w, k2_packed_W(plan, W_flat), n_edges, dx, dw, None,
             part, _build.ptr(dsh), _build.ptr(part_sh), plan.k2_dsh_slots(), DSH_LEGS[leg],
             n_split)


def dtp_lin_bwd3(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w, W_flat: torch.Tensor,
                 g: torch.Tensor, n_edges=None, need_dx: bool = True, need_dsh: bool = True,
                 need_dw: bool = True):
    """K5a: (dx, dsh, dw) for the cotangent ``g`` [E, d_out] of
    ``dtp_lin_fwd`` on the same operands, each None when not needed (dw is
    None for a shared-weight plan).  CPU tensors take ``dtp_lin_bwd3_plain``;
    CUDA tensors launch the kernel (float32 or bfloat16) or raise: K2's
    launch 1 with a dsh accumulator (``csrc/dtp_lin_bwd.cu``,
    ``k2::bwd3_kernel``, compiled for each set of two or three outputs), a
    block per (16-edge tile, irrep group), then the dx and dsh partials
    summed in group order (``k2::split_sum_kernel``).  One output alone is
    that edge leg of K5b (``dtp_lin_leg``, which counts the launch)."""
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
    dev = x.device
    empty = lambda d: torch.empty((E, d), dtype=x.dtype, device=dev)  # noqa: E731
    dx = empty(plan.d_x) if need_dx else None
    dsh = empty(plan.d_sh) if need_dsh else None
    dw = None
    if need_dw:
        dw = (torch.zeros if plan.dw_has_dead_cols else torch.empty)(
            (E, plan.d_w), dtype=x.dtype, device=dev)
    if E == 0 or not (need_dx or need_dsh or need_dw):
        return dx, dsh, dw
    if need_dx + need_dsh + need_dw == 1:
        leg = "x" if need_dx else "sh" if need_dsh else "w"
        ops = {"x": x, "sh": sh, "w": w, leg: None}
        out = dtp_lin_leg(plan, leg, g, ops["x"], ops["sh"], ops["w"], W_flat, n_edges)
        return tuple(out if k == leg else None for k in ("x", "sh", "w"))
    _dsh_launch(plan, "bwd3", g, x, sh, w, W_flat, n_edges, dx, dsh, dw)
    dtp_lin_bwd3.launches += 1
    return dx, dsh, dw


dtp_lin_bwd3.launches = 0


def bwd3_occupancy(plan: DTPLinPlan, dtype: torch.dtype, need_dx: bool = True,
                   need_dw: bool = True, folded: bool = False, need_dsh: bool = True,
                   x_rows: bool = True) -> int:
    """Resident blocks per SM of the K5a launch with the two or three
    outputs asked for (x a row-broadcast without ``x_rows``), or with
    ``folded`` of K7-B3's (``need_dw`` its dh) on a radial-folded plan, at
    this plan's shared memory (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    needs the card."""
    code = _build.dtype_code(torch.empty((), dtype=dtype))
    if folded and plan.radial_fold is None:
        raise ValueError("K7-B3 needs a plan with radial_fold")
    has_w = folded or not plan.shared_weights
    need = (int(need_dx) | 2 * int(need_dsh) | 4 * int(need_dw and has_w))
    if need in (0, 1, 2, 4):
        raise ValueError("K5a and K7-B3 take two or three outputs: one alone is an edge leg's")
    blocks = _dsh_occupancy(plan, DSH_LEGS["bwd3"], has_w, x_rows, need, code,
                            plan.radial_fold if folded else 0)
    if blocks < 0:
        _build.check(-blocks, "dtp_lin_dsh_occupancy")
    return blocks


def _dsh_occupancy(plan: DTPLinPlan, leg: int, has_w: bool, x_rows: bool, need: int,
                   code: int, hd: int = 0) -> int:
    span_max = plan.bwd_tables(torch.device("cpu"))[5]
    kt = plan.k2_tables(torch.device("cpu"))
    return _build.library().dtp_lin_dsh_occupancy(
        leg, plan.d_x, plan.d_sh, span_max, kt.cp_max, kt.fd_max, int(has_w), int(x_rows), need,
        plan.k2_dsh_slots(), hd, code)


def dtp_lin_rad_bwd3_plain(plan: DTPLinPlan, x, sh, h, Wrs, W_flat, g, n_edges=None):
    """Plain version of K7-B3: (dx [E, d_x], dsh [E, d_sh], dh [E, hd]) for
    the cotangent ``g`` of ``dtp_lin_rad_plain`` on the same operands: K5a's
    plain version on ``w = radial_w_plain(h, Wrs)``, then ``dh = dw Wr^T``."""
    dx, dsh, dw = dtp_lin_bwd3_plain(plan, x, sh, radial_w_plain(h, Wrs), W_flat, g, n_edges)
    return dx, dsh, radial_dh_plain(Wrs, dw, h.dtype)


def dtp_lin_rad_bwd3(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, h: torch.Tensor,
                     Wrs: torch.Tensor, W_flat: torch.Tensor, g: torch.Tensor, n_edges=None,
                     need_dx: bool = True, need_dsh: bool = True, need_dh: bool = True):
    """K7-B3: (dx, dsh, dh [E, hd]) for the cotangent ``g`` [E, d_out] of
    ``dtp_lin_rad_fwd`` on the same operands, each None when not needed.
    K5a's launch with the fold (``csrc/dtp_lin_bwd.cu``,
    ``k2::rad_bwd3_kernel``, compiled for each set of two or three outputs),
    a block per (16-edge tile, irrep group): the group's w built from h and
    dh = dw Wr^T taken on the tensor cores, dw kept on chip; the dx, dsh and
    dh partials summed in group order by one launch.  W and [Wr; offset]
    are packed by one gather (``plan.k7_leg_tables``); the offset is read
    from ``Wrs``' last row.  One output alone is that folded edge leg of
    K7-L (``dtp_lin_rad_leg``, which counts the launch).  CPU tensors take
    ``dtp_lin_rad_bwd3_plain``; CUDA tensors launch the kernel (float32 or
    bfloat16) or raise."""
    if x.device.type == "cpu":
        dx, dsh, dh = dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wrs, W_flat, g, n_edges)
        return dx if need_dx else None, dsh if need_dsh else None, dh if need_dh else None
    E, hd = sh.shape[0], plan.radial_fold
    x, sh, (h, Wrs), W_flat = _check_operands(plan, x, sh, (h, Wrs), W_flat, local=False)
    if g.shape != (E, plan.d_out) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"cotangent must be [{E}, {plan.d_out}] in x's dtype and device")
    g = g.contiguous()
    dev = x.device
    n_edges = _check_n_edges(n_edges, E, dev)
    empty = lambda d: torch.empty((E, d), dtype=x.dtype, device=dev)  # noqa: E731
    dx = empty(plan.d_x) if need_dx else None
    dsh = empty(plan.d_sh) if need_dsh else None
    dh = empty(hd) if need_dh else None
    if E == 0 or not (need_dx or need_dsh or need_dh):
        return dx, dsh, dh
    if need_dx + need_dsh + need_dh == 1:
        leg = "x" if need_dx else "sh" if need_dsh else "h"
        ops = {"x": x, "sh": sh, "h": h, leg: None}
        out = dtp_lin_rad_leg(plan, leg, g, ops["x"], ops["sh"], ops["h"], Wrs, W_flat, n_edges)
        return tuple(out if k == leg else None for k in EDGE_LEGS_RAD)
    kl, kr = plan.k7_leg_tables(dev), plan.k7_tables(dev)
    packed = fold_gather(plan, W_flat, Wrs, kl.index)
    Wp, pk, Wl = packed[: kl.pk_off], packed[kl.pk_off : kl.wl_off], packed[kl.wl_off :]
    n_split = len(plan.groups)
    scratch = lambda out, width: (  # noqa: E731
        torch.empty((n_split, E, width), dtype=torch.float32, device=dev)
        if out is not None and n_split > 1 else None)
    # the splits' fp32 partials, held until the launches are enqueued (a
    # temporary's block would go back to the allocator at once)
    part, part_sh, part_dh = scratch(dx, plan.d_x), scratch(dsh, plan.d_sh), scratch(dh, hd)
    _k2_call("dtp_lin_rad_bwd3", plan, g, x, sh, None, Wp, n_edges, dx, None, None, part,
             _build.ptr(h), hd, _build.ptr(Wl), Wl.numel() // (hd + 1), _build.ptr(pk),
             _build.ptr(kr.rgk), _build.ptr(dh), _build.ptr(dsh), _build.ptr(part_sh),
             plan.k2_dsh_slots(), _build.ptr(part_dh), n_split)
    dtp_lin_rad_bwd3.launches += 1
    return dx, dsh, dh


dtp_lin_rad_bwd3.launches = 0


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
    0 or d_x).  On a radial-folded plan ``w`` is h [E, hd]."""
    E = g.shape[0]
    _build.dtype_code(g)
    want = {"out": (g, plan.d_out), "x": (x, plan.d_x), "sh": (sh, plan.d_sh)}
    if plan.radial_fold is not None:
        want["h"] = (w, plan.radial_fold)
    elif not plan.shared_weights:
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
            None if skip in ("w", "h") else cont(w), cont(W_flat))


def dtp_lin_leg(plan: DTPLinPlan, out_leg: str, g: torch.Tensor, x, sh, w,
                W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """K5b: one edge leg of the fused op, ``F_x(g, sh, w, W)`` [E, d_x],
    ``F_sh(g, x, w, W)`` [E, d_sh] or ``F_w(g, x, sh, W)`` [E, d_w]; the
    operand of ``out_leg`` is not read (pass None).  Each runs on K2's
    launch 1 (``csrc/dtp_lin_bwd.cu``: the x and w legs
    ``k2::edge_leg_kernel``, the sh leg ``k2::sh_leg_kernel``), a block per
    (16-edge tile, irrep group): at MD17's 2944 edges the tiles alone fill
    1.4 waves of one block an SM; the x and sh legs' per-group partials are
    summed in group order.  CPU
    tensors take ``dtp_lin_leg_plain``; CUDA tensors launch the kernel
    (float32 or bfloat16) or raise."""
    if g.device.type == "cpu":
        return dtp_lin_leg_plain(plan, out_leg, g, x, sh, w, W_flat, n_edges)
    _check_edge_leg(plan, out_leg)
    E, dev = g.shape[0], g.device
    g, x, sh, w, W_flat = _check_leg_operands(plan, out_leg, g, x, sh, w, W_flat)
    n_edges = _check_n_edges(n_edges, E, dev)
    width = {"x": plan.d_x, "sh": plan.d_sh, "w": plan.d_w}[out_leg]
    alloc = torch.zeros if out_leg == "w" and plan.dw_has_dead_cols else torch.empty
    out = alloc((E, width), dtype=g.dtype, device=dev)
    if E == 0:
        return out
    if out_leg == "sh":
        _dsh_launch(plan, "sh", g, x, None, w, W_flat, n_edges, None, out, None)
    else:
        n_split = len(plan.groups)
        part = None  # the x leg's dx partials, one [E, d_x] per group
        if out_leg == "x" and n_split > 1:
            part = torch.empty((n_split, E, plan.d_x), dtype=torch.float32, device=dev)
        _k2_call("dtp_lin_edge_leg", plan, g, x, sh, w, k2_packed_W(plan, W_flat), n_edges,
                 out if out_leg == "x" else None, out if out_leg == "w" else None, None, part,
                 EDGE_LEGS.index(out_leg), n_split)
    dtp_lin_leg.launches += 1
    return out


dtp_lin_leg.launches = 0


def dtp_lin_legW(plan: DTPLinPlan, g: torch.Tensor, x: torch.Tensor, sh: torch.Tensor, w,
                 n_edges=None) -> torch.Tensor:
    """K5c: the head-weight leg ``F_W(g, x, sh, w)``, the gradient of the
    packed ``W_flat`` [w_numel] in float32 for ``g`` [E, d_out] in the out
    leg: K2's launch 2 (``k2::W_leg_kernel``: z recomputed per dW tile and
    edge range, z^T g on the tensor cores) and the fixed-order sum of the
    ranges' partial rows.  CPU tensors take ``dtp_lin_legW_plain``; CUDA
    tensors launch the kernel (float32 or bfloat16) or raise."""
    if g.device.type == "cpu":
        return dtp_lin_legW_plain(plan, g, x, sh, w, n_edges)
    E, dev = g.shape[0], g.device
    g, x, sh, w, _ = _check_leg_operands(plan, "W", g, x, sh, w)
    n_edges = _check_n_edges(n_edges, E, dev)
    dW = torch.zeros((plan.w_numel,), dtype=torch.float32, device=dev)
    if E == 0:
        return dW
    _k2_call("dtp_lin_legW", plan, g, x, sh, w, None, n_edges, None, None, dW, None,
             blocks_per_sm=LEGW_DW_BLOCKS_PER_SM)
    dtp_lin_legW.launches += 1
    return dW


dtp_lin_legW.launches = 0


def _check_radial(plan: DTPLinPlan, Wrs: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[Wr; offset] [hd + 1, d_w] checked against the plan and ``like``'s
    dtype and device, contiguous (the TP's own column order)."""
    if (Wrs.shape != (plan.radial_fold + 1, plan.d_w) or Wrs.dtype != like.dtype
            or Wrs.device != like.device):
        raise ValueError(f"[Wr; offset] must be [{plan.radial_fold + 1}, {plan.d_w}] in g's "
                         f"dtype and device")
    return Wrs.contiguous()


def _local_radial(plan: DTPLinPlan, Wrs: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``_check_radial``'s [Wr; offset] with its columns gathered into the
    tables' local order (``plan.radial_cols``), as K7-LW reads it."""
    return _check_radial(plan, Wrs, like)[:, plan.radial_cols(like.device)].contiguous()


def _check_rad_leg(plan: DTPLinPlan, out_leg: str) -> None:
    if plan.radial_fold is None or out_leg not in EDGE_LEGS_RAD:
        raise ValueError(f"no folded edge leg {out_leg!r} for this plan")


def dtp_lin_rad_leg_plain(plan: DTPLinPlan, out_leg: str, g, x, sh, h, Wrs, W_flat,
                          n_edges=None):
    """Plain version of K7-L: the edge leg ``out_leg`` ("x", "sh" or "h") of
    the radial-folded op for ``g`` [E, d_out] in its out leg: K5b's plain
    version on ``w = radial_w_plain(h, Wrs)``, or for "h" its w leg and then
    ``dh = dw Wr^T`` [E, hd].  The operand of ``out_leg`` is not read (pass
    None)."""
    _check_rad_leg(plan, out_leg)
    if out_leg == "h":
        return radial_dh_plain(Wrs, dtp_lin_leg_plain(plan, "w", g, x, sh, None, W_flat, n_edges),
                               g.dtype)
    return dtp_lin_leg_plain(plan, out_leg, g, x, sh, radial_w_plain(h, Wrs), W_flat, n_edges)


def dtp_lin_rad_legW_plain(plan: DTPLinPlan, g, x, sh, h, Wrs, n_edges=None):
    """Plain version of K7-LW: K5c's plain version on ``w = radial_w_plain(h,
    Wrs)``, the gradient of ``W_flat`` [w_numel] in float32 (float64 for
    float64 inputs)."""
    return dtp_lin_legW_plain(plan, g, x, sh, radial_w_plain(h, Wrs), n_edges)


def dtp_lin_rad_legWr_plain(plan: DTPLinPlan, g, x, sh, h, W_flat, n_edges=None,
                            ones: bool = True):
    """Plain version of K7-Wr: d[Wr; offset] = [h, 1]^T dw [hd + 1, d_w] in
    float32 (float64 for float64 inputs), dw K5b's w leg; rows past
    ``n_edges`` add nothing, to the offset row too.  ``ones=False`` when h's
    slot holds a tangent or a cotangent: the offset row is then 0."""
    dw = dtp_lin_leg_plain(plan, "w", g, x, sh, None, W_flat, n_edges)
    return radial_dWrs_plain(h, dw, n_edges, ones)


def dtp_lin_rad_leg(plan: DTPLinPlan, out_leg: str, g: torch.Tensor, x, sh, h,
                    Wrs: torch.Tensor, W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """K7-L: one edge leg of the radial-folded op, ``F_x(g, sh, h, Wrs, W)``
    [E, d_x], ``F_sh(g, x, h, Wrs, W)`` [E, d_sh] or ``F_h(g, x, sh, Wrs, W)``
    [E, hd]; the operand of ``out_leg`` is not read (pass None).  K5b's leg
    on K2's launch 1 with the fold (``k2::rad_leg_kernel``), a block per
    (16-edge tile, irrep group): the x and sh legs build the group's w from
    h on the tensor cores, the h leg contracts the group's dw into dh = dw
    Wr^T there; dx, dsh and dh sum over groups, their per-group fp32
    partials in group order (whole tiles took 22% longer for the h leg at
    MD17's sep_act on an H100).  W and [Wr; offset] are packed by one
    gather (``plan.k7_leg_tables``).  CPU tensors take
    ``dtp_lin_rad_leg_plain``; CUDA tensors launch the kernel (float32 or
    bfloat16) or raise."""
    if g.device.type == "cpu":
        return dtp_lin_rad_leg_plain(plan, out_leg, g, x, sh, h, Wrs, W_flat, n_edges)
    _check_rad_leg(plan, out_leg)
    E, dev, hd = g.shape[0], g.device, plan.radial_fold
    g, x, sh, h, W_flat = _check_leg_operands(plan, out_leg, g, x, sh, h, W_flat)
    Wrs = _check_radial(plan, Wrs, g)
    n_edges = _check_n_edges(n_edges, E, dev)
    width = {"x": plan.d_x, "sh": plan.d_sh, "h": hd}[out_leg]
    out = torch.empty((E, width), dtype=g.dtype, device=dev)
    if E == 0:
        return out
    kl, kr = plan.k7_leg_tables(dev), plan.k7_tables(dev)
    packed = fold_gather(plan, W_flat, Wrs, kl.index)
    Wp, pk, Wl = packed[: kl.pk_off], packed[kl.pk_off : kl.wl_off], packed[kl.wl_off :]
    n_split = len(plan.groups)
    part = part_sh = None  # the splits' fp32 partials of the leg's output
    if n_split > 1:
        part = torch.empty((n_split, E, width), dtype=torch.float32, device=dev)
        part, part_sh = (None, part) if out_leg == "sh" else (part, None)
    _k2_call("dtp_lin_rad_leg", plan, g, x, sh, None, Wp, n_edges,
             out if out_leg == "x" else None, None, None, part, _build.ptr(h), hd,
             _build.ptr(Wl), Wl.numel() // (hd + 1), _build.ptr(pk), _build.ptr(kr.rgk),
             _build.ptr(out if out_leg == "h" else None),
             _build.ptr(out if out_leg == "sh" else None), _build.ptr(part_sh),
             plan.k2_dsh_slots(), EDGE_LEGS_RAD.index(out_leg), n_split)
    dtp_lin_rad_leg.launches += 1
    return out


dtp_lin_rad_leg.launches = 0


def dtp_lin_rad_legW(plan: DTPLinPlan, g: torch.Tensor, x: torch.Tensor, sh: torch.Tensor,
                     h: torch.Tensor, Wrs: torch.Tensor, n_edges=None) -> torch.Tensor:
    """K7-LW: the head-weight leg of the radial-folded op, ``F_W(g, x, sh, h,
    Wrs)``, the gradient of ``W_flat`` [w_numel] in float32: K5c's launch
    with w rebuilt from h (``k2::rad_W_leg_kernel``: per dW tile and 64-edge
    step the w fan slice [h, 1] Wl on the tensor cores, each group's Wr
    packed in fragment order by ``plan.k7_tables``, the offset read from
    ``Wrs``' last row), then z^T g on the tensor cores and the fixed-order
    sum of the ranges' partial rows; w and z never reach device memory.
    CPU tensors take ``dtp_lin_rad_legW_plain``; CUDA tensors launch the
    kernel (float32 or bfloat16) or raise."""
    if g.device.type == "cpu":
        return dtp_lin_rad_legW_plain(plan, g, x, sh, h, Wrs, n_edges)
    E, dev = g.shape[0], g.device
    g, x, sh, h, _ = _check_leg_operands(plan, "W", g, x, sh, h)
    Wl = _local_radial(plan, Wrs, g)
    n_edges = _check_n_edges(n_edges, E, dev)
    dW = torch.zeros((plan.w_numel,), dtype=torch.float32, device=dev)
    if E == 0:
        return dW
    kr = plan.k7_tables(dev)
    pk = torch.cat([Wl.reshape(-1), Wl.new_zeros(1)])[kr.index]
    _k2_call("dtp_lin_rad_legW", plan, g, x, sh, None, None, n_edges, None, None, dW, None,
             _build.ptr(h), plan.radial_fold, _build.ptr(Wl), Wl.shape[1], _build.ptr(pk),
             _build.ptr(kr.rgk), blocks_per_sm=LEGW_DW_BLOCKS_PER_SM)
    dtp_lin_rad_legW.launches += 1
    return dW


dtp_lin_rad_legW.launches = 0


def dtp_lin_rad_legWr(plan: DTPLinPlan, g: torch.Tensor, x: torch.Tensor, sh: torch.Tensor,
                      h: torch.Tensor, W_flat: torch.Tensor, n_edges=None,
                      ones: bool = True) -> torch.Tensor:
    """K7-Wr: the [Wr; offset] leg of the radial-folded op, ``F_Wr(g, x, sh,
    h, W)`` = [h, 1]^T dw [hd + 1, d_w] in float32, dw K5b's w leg: that
    leg's own launch (``k2::edge_leg_kernel``, cut by irrep group) writes dw
    to a workspace [E, d_w] in g's dtype, then the d[Wr; offset] tiles
    (``k2::Wr_leg_kernel``: [h, one]^T dw on the tensor cores per tile and
    K2 edge range) and the fixed-order sum of the ranges' partial rows.
    ``ones=False`` when h's slot holds a tangent or a cotangent (its
    appended column is 0, and so is the offset row).  Columns of no live
    group get 0.  CPU tensors take ``dtp_lin_rad_legWr_plain``; CUDA
    tensors launch the kernels (float32 or bfloat16) or raise."""
    if g.device.type == "cpu":
        return dtp_lin_rad_legWr_plain(plan, g, x, sh, h, W_flat, n_edges, ones)
    E, dev, hd = g.shape[0], g.device, plan.radial_fold
    g, x, sh, h, W_flat = _check_leg_operands(plan, "Wr", g, x, sh, h, W_flat)
    n_edges = _check_n_edges(n_edges, E, dev)
    cols = plan.radial_cols(dev)
    n_loc = cols.numel()
    red = torch.zeros(((hd + 1) * n_loc,), dtype=torch.float32, device=dev)
    if E > 0:
        dw = torch.empty((E, plan.d_w), dtype=g.dtype, device=dev)  # the dw workspace
        _k2_call("dtp_lin_rad_legWr", plan, g, x, sh, None, k2_packed_W(plan, W_flat), n_edges,
                 None, dw, red, None, _build.ptr(h), hd, n_loc, int(ones), len(plan.groups),
                 row=red.numel(), range_tiles=k7_wr_tiles(hd, n_loc))
        dtp_lin_rad_legWr.launches += 1
    dWrs = torch.zeros((hd + 1, plan.d_w), dtype=torch.float32, device=dev)
    dWrs[:, cols] = red.view(hd + 1, n_loc)
    return dWrs


dtp_lin_rad_legWr.launches = 0


def leg_occupancy(plan: DTPLinPlan, dtype: torch.dtype) -> int:
    """Resident blocks per SM at this plan's shared memory of K5b's sh leg
    (on K2's launch 1).  Needs the card."""
    code = _build.dtype_code(torch.empty((), dtype=dtype))
    blocks = _dsh_occupancy(plan, DSH_LEGS["sh"], not plan.shared_weights, True, 7, code)
    if blocks < 0:
        _build.check(-blocks, "leg_occupancy")
    return blocks


def legs_of(plan: DTPLinPlan):
    """(the op's legs, its per-edge legs) on this plan: JAX's ``_legs_of`` and
    ``_edge_legs`` (a shared-weight plan's w slot stays None)."""
    return (LEGS_RAD, EDGE_LEGS_RAD) if plan.radial_fold is not None else (LEGS, EDGE_LEGS)


def _leg_value(plan: DTPLinPlan, out_leg: str, n_edges, ones: bool, ops: dict) -> torch.Tensor:
    """``F_out_leg`` of the other legs' operands, through the kernel wrappers."""
    if plan.radial_fold is None:
        if out_leg == "out":
            return dtp_lin_fwd(plan, ops["x"], ops["sh"], ops["w"], ops["W"], n_edges)
        if out_leg == "W":
            return dtp_lin_legW(plan, ops["out"], ops["x"], ops["sh"], ops["w"], n_edges)
        return dtp_lin_leg(plan, out_leg, ops["out"], ops["x"], ops["sh"], ops["w"], ops["W"],
                           n_edges)
    if out_leg == "out":
        return dtp_lin_rad_fwd(plan, ops["x"], ops["sh"], ops["h"], ops["Wr"], ops["W"], n_edges)
    if out_leg == "W":
        return dtp_lin_rad_legW(plan, ops["out"], ops["x"], ops["sh"], ops["h"], ops["Wr"],
                                n_edges)
    if out_leg == "Wr":
        return dtp_lin_rad_legWr(plan, ops["out"], ops["x"], ops["sh"], ops["h"], ops["W"],
                                 n_edges, ones)
    return dtp_lin_rad_leg(plan, out_leg, ops["out"], ops["x"], ops["sh"], ops["h"], ops["Wr"],
                           ops["W"], n_edges)


def _put(ops: dict, ones: bool, leg: str, c: torch.Tensor):
    """``ops`` with the cotangent ``c`` in ``leg``'s slot, and the value of
    h's appended column that goes with them: the ones-column rule.

    The port's folded op is affine in h (the kernels append h's ones column
    themselves: w = [h, 1] @ [Wr; offset]); it is multilinear in [h, 1].  A
    tangent or a cotangent carried in h's slot has 0 in that column, so the
    legs called with one there see [Wr; 0] (``torch.cat`` on the tensor, so
    autograd gives the offset no gradient through them) and K7-Wr's offset
    row is 0 (``ones`` False, passed on to every leg below).  JAX needs no
    rule: ``plan.pad_h`` puts [h, 1, 0...] into the operand outside its
    primitives, and its tangents have a 0 there by construction."""
    ops = {**ops, leg: c}
    if leg == "h" and ones:
        Wrs = ops["Wr"]
        ops["Wr"] = torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])
        ones = False
    return ops, ones


def _apply_leg(plan: DTPLinPlan, out_leg: str, n_edges, ones: bool, ops: dict,
               like: torch.Tensor):
    """``_Leg.apply`` on ``ops`` cast to the op's compute dtype, its result in
    ``like``'s dtype (the W and Wr legs come back in float32)."""
    dt = next(ops[leg] for leg in ("sh", "x", "out") if ops[leg] is not None).dtype
    args = [None if leg == out_leg or ops[leg] is None else ops[leg].to(dt)
            for leg in legs_of(plan)[0]]
    return _Leg.apply(plan, out_leg, n_edges, ones, *args).to(like.dtype)


class _Leg(torch.autograd.Function):
    """One leg of the fused op as a function of the others: ``forward(plan,
    out_leg, n_edges, ones, *ops)``, the operands in ``legs_of(plan)``'s
    order with None in ``out_leg``'s slot (and in w's for a shared-weight
    plan); ``ones`` is the value of h's appended column on a folded plan
    (``_put``).  The gradient of an operand is the leg function of that
    operand with the cotangent in ``out_leg``'s slot; the out leg's edge
    gradients come from one ``_Bwd3`` when at least two are asked for."""

    @staticmethod
    def forward(ctx, plan, out_leg, n_edges, ones, *ops):
        ctx.plan, ctx.out_leg, ctx.ones = plan, out_leg, ones
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(n_edges, *ops)
        return _leg_value(plan, out_leg, n_edges, ones, dict(zip(legs_of(plan)[0], ops)))

    @staticmethod
    def backward(ctx, c):
        plan, out_leg = ctx.plan, ctx.out_leg
        legs, edge_legs = legs_of(plan)
        if c is None:
            return (None,) * (4 + len(legs))
        n_edges, *saved = ctx.saved_tensors
        ops = dict(zip(legs, saved))
        live = [leg for leg, need in zip(legs, ctx.needs_input_grad[4:])
                if need and leg not in _SKIPPED_LEGS]
        grads = {}
        edge = [leg for leg in live if leg in edge_legs]
        if out_leg == "out" and len(edge) >= 2:
            outs = _Bwd3.apply(plan, n_edges, ctx.ones, tuple(leg in edge for leg in edge_legs),
                               c, *saved[1:])
            grads = {leg: o for leg, o in zip(edge_legs, outs) if leg in edge}
            live = [leg for leg in live if leg not in edge]
        child, ones = _put(ops, ctx.ones, out_leg, c)
        for leg in live:
            grads[leg] = _apply_leg(plan, leg, n_edges, ones, child, ops[leg])
        return (None,) * 4 + tuple(grads.get(leg) for leg in legs)


class _Bwd3(torch.autograd.Function):
    """The out leg's edge gradients, (F_x, F_sh, F_w)(g, ...) in one K5a
    launch, or on a folded plan (F_x, F_sh, F_h)(g, ...) in one K7-B3
    launch; each None when not needed (``need``).  dx does not depend on x,
    dsh on sh, nor dw (dh) on w (h), so the backward differentiates each
    output through its own leg function: for the cotangent of output ``o``
    and the operand ``t``, the leg function of ``t`` with the cotangent in
    ``o``'s slot (JAX's ``_bwd3_jvp``)."""

    @staticmethod
    def forward(ctx, plan, n_edges, ones, need, g, *ops):
        ctx.plan, ctx.ones = plan, ones
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(n_edges, g, *ops)
        o = dict(zip(legs_of(plan)[0][1:], ops))
        if plan.radial_fold is None:
            return dtp_lin_bwd3(plan, o["x"], o["sh"], o["w"], o["W"], g, n_edges, *need)
        return dtp_lin_rad_bwd3(plan, o["x"], o["sh"], o["h"], o["Wr"], o["W"], g, n_edges,
                                *need)

    @staticmethod
    def backward(ctx, *cots):
        plan = ctx.plan
        legs, edge_legs = legs_of(plan)
        n_edges, *saved = ctx.saved_tensors
        ops = dict(zip(legs, saved))
        live = [leg for leg, need in zip(legs, ctx.needs_input_grad[4:])
                if need and leg not in _SKIPPED_LEGS]
        grads = {}
        for o, c in zip(edge_legs, cots):
            if c is None:
                continue
            child, ones = _put(ops, ctx.ones, o, c)
            for t in live:
                if t == o:
                    continue
                term = _apply_leg(plan, t, n_edges, ones, child, ops[t])
                grads[t] = term if t not in grads else grads[t] + term
        return (None,) * 4 + tuple(grads.get(leg) for leg in legs)


def dtp_lin_ho(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
               W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """Fused DTP + linear heads of the force models, differentiable to any
    order in x, sh, w and the head weights: [E, plan.d_out].  Same operands
    as ``dtp_lin``; a shared ``w`` is folded into ``W_flat`` here, outside
    the autograd ops.  The forward is K1; the backward K5a for the edge legs
    (one K5b leg when only one is needed) and K5c for ``W_flat``; under
    ``create_graph=True`` their own backwards are further legs.  On a plan
    with ``radial_fold``, ``w`` is ``(h, plan.pack_radial(Wr, offset))`` and
    the op is differentiable to any order in x, sh, h, [Wr; offset] and
    ``W_flat``: K7-F forward, K7-B3 for the edge legs (one K7-L leg when
    only one is needed), K7-Wr for [Wr; offset], K7-LW for ``W_flat``."""
    if isinstance(w, tuple):
        if plan.radial_fold is None:
            raise ValueError("(h, [Wr; offset]) needs a plan with radial_fold")
        return _Leg.apply(plan, "out", n_edges, True, None, x, sh, *w, W_flat)
    w, W_flat = fold_shared_weights(plan, w, W_flat)
    return _Leg.apply(plan, "out", n_edges, True, None, x, sh, w, W_flat)
