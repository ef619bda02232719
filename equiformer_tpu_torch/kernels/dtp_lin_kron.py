"""The fused DTP + linear heads in the kron basis (K8-F forward, K8-B backward).

Counterpart of ``equiformer_tpu/kernels/dtp_lin_kron.py``
(``make_fused_dtp_lin_kron`` -> ``_fwd_kernel``, ``_bwd_kernel``), the route
of JAX's ``EQUIFORMER_TPU_KRON_G=1``.  It computes the function of
``dtp_lin`` (K1 / K2) with the TP's definition substituted into the heads'
product:

    out[e, out_col(g, k) + c] = sum_q sum_u Kop[e, (q, u)] * G[(q, u), c]
    Kop[e, (q, u)]            = sh[e, col_q] * x[e, a_q + u] * w[e, b_q + u]
    G[(q, u), c]              = coeff_q * W_g[fc_q + u, c]

where q runs over the plan's CG triples (x component, SH column, weight
path) feeding component k of irrep group g.  ``KronMeta`` lays the triples
of each (g, k) out as one contiguous range of Kop columns ("K rows" of G);
the port pads nothing (JAX pads each triple to 16 rows for the TPU's
sublanes), so its G is not JAX's and the two packages compare through the
heads' weights.  ``KronMeta.build_G`` makes G from the packed W with one
gather and one product in plain PyTorch, outside the autograd op, so
autograd carries the op's dG back to W and, through ``fold_shared_weights``,
to a shared w (JAX's ``build_G``, ``:143``).

The kron op is K1's and K2's function with each (g, k) a group of one
component, its Kop rows the fan and its block of G the heads' weight, each
triple a term of coefficient 1.  So K8-F is K1's product over
``KronMeta.k1_tables`` on a 64-edge tile (``csrc/dtp_lin.cu``,
``k1::kron_fwd_kernel``), and K8-B K2's two launches
(``csrc/dtp_lin_bwd.cu``) over ``KronMeta.bwd_tables``.

The op has no dsh (JAX's kron plans are ``needs_dsh=False``) and is first
order only: its backward is not differentiable, as JAX's ``custom_vjp``
bwd is not.  It rounds its fp32 dG to G's dtype before autograd chains it to
dW (JAX's precision caveat, ``:56-60``, ``:456``, ``:485``).

``dtp_lin_kron_plain`` and ``dtp_lin_kron_bwd_plain`` are the plain
versions: Kop built with torch ops per (g, k) and contracted with
``torch.matmul``; like the plain versions of ``dtp_lin.py`` they round Kop
and dkop to the compute dtype, where K8-F keeps both in fp32 and K8-B keeps
dkop in fp32 (its bf16 products round Kop, as the plain version does).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _build
from .dtp_lin import (
    K1_VEC,
    K2_COL_TILE,
    K2_FAN_TILE,
    DTPLinPlan,
    _check_n_edges,
    _sm_count,
    _zero_past,
    fold_shared_weights,
    k1_pack_index,
    k2_pack_index,
    k2_ranges,
)


# K8-F (csrc/dtp_lin.cu k1::kron_fwd_kernel): edges a block, output columns
# a block
KRON_TILE, KRON_COLS = 64, 128


class Triple(NamedTuple):
    a_off: int  # first x column of the x component
    col_off: int  # SH column
    b_off: int  # first w column of the weight path
    coeff: float  # CG coefficient (with the fan-in rescale of external weights)
    fc: int  # first fan row of the group's packed W
    mul: int  # rows of G (columns of Kop) the triple takes


class KronFwdTables(NamedTuple):
    """K8-F's tables in K1's layout (``csrc/dtp_lin.cu``, k1::, as
    ``DTPLinPlan.k1_tables`` and ``device_tables``): each (g, k) a group of
    one component whose fan is its Kop rows, each CG triple a run of one
    term of coefficient 1."""
    gk: torch.Tensor  # int32 [n_gk, 8]
    runs: torch.Tensor  # int32 [n_triples, 5]
    terms: torch.Tensor  # int32 [n_triples, 5]
    coeffs: torch.Tensor  # float32 [n_triples]: ones (G holds the CG coefficients)
    gp_index: torch.Tensor  # int64: each (g, k)'s G block in B-fragment order, of cat([G, 0])
    fz_max: int  # the most Kop rows of a (g, k), padded to 16
    vec: int  # K1_VEC where every run and term offset is a multiple of it, else 1
    n_chunks: int  # the (g, k)'s column chunks of KRON_COLS (the kernel's grid)


class KronBwdTables(NamedTuple):
    """K8-B's tables in K2's layout (``csrc/dtp_lin_bwd.cu``, k2::): each
    (g, k) a group of one component, its Kop rows the fan, its block of G
    the W, each triple a term of coefficient 1."""
    gk: torch.Tensor  # int32 [n_gk, 12]
    terms: torch.Tensor  # int32 [n_triples, 6]
    coeffs: torch.Tensor  # float32 [n_triples]: ones (G holds the CG coefficients)
    dwmap: torch.Tensor  # int32: local dw column -> w column
    tiles: torch.Tensor  # int32 [n_tiles, 6]: launch 2's dG tiles
    gp_index: torch.Tensor  # int64: each (g, k)'s G^T in fragment order, a gather of cat([G, 0])
    span_max: int  # the widest group's dw span
    cp_max: int  # the widest (g, k)'s columns padded to 16
    fd_max: int  # the most Kop rows of a (g, k), padded to 8


class KronMeta:
    """The kron layout of a ``DTPLinPlan`` without radial fold.

    ``qcols[(gi, k)]``: the triples feeding component k of group gi, in the
    plan's term order; ``k_ranges[(gi, k)]``: their contiguous row range in
    the group's G [g_rows[gi], cols]; ``g_off[gi]``: where the group's G
    starts in the flat G (``numel`` elements, ``n_rows`` rows in all)."""

    def __init__(self, plan: DTPLinPlan):
        if plan.radial_fold is not None:
            raise ValueError("the kron route folds W into G and takes no radial fold")
        self.plan = plan
        qcols: Dict[Tuple[int, int], list] = {}
        for t, (gi, k, fc) in plan.terms:
            qs = qcols.setdefault((gi, k), [])
            if any((q.a_off, q.col_off, q.b_off) == (t.a_off, t.col_off, t.b_off) for q in qs):
                raise ValueError("duplicate CG entry")
            qs.append(Triple(t.a_off, t.col_off, t.b_off, t.coeff, fc, t.mul))
        self.qcols: Dict[Tuple[int, int], Tuple[Triple, ...]] = {}
        self.k_ranges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.g_rows, self.g_off = [], []
        numel = 0
        for gi, g in enumerate(plan.groups):
            acc = 0
            for k in range(g.ir.dim):
                qs = qcols.get((gi, k))
                if not qs:
                    raise ValueError("an output component with no CG terms")
                self.qcols[(gi, k)] = tuple(qs)
                self.k_ranges[(gi, k)] = (acc, acc + sum(q.mul for q in qs))
                acc += sum(q.mul for q in qs)
            self.g_rows.append(acc)
            self.g_off.append(numel)
            numel += acc * g.cols
        self.numel = numel
        self.n_rows = sum(self.g_rows)
        self._cache: Dict[tuple, object] = {}

    def blocks(self):
        """(gi, k, first flat row, row count, cols, output column, G element
        offset) of each (group, component), in order."""
        row = 0
        for gi, g in enumerate(self.plan.groups):
            for k in range(g.ir.dim):
                rs, re = self.k_ranges[(gi, k)]
                yield gi, k, row, re - rs, g.cols, g.out_off + k * g.cols, \
                    self.g_off[gi] + rs * g.cols
                row += re - rs

    def _host(self):
        """numpy tables, built once: per flat row (x column, SH column, w
        column), and per G element its W_flat element and coefficient."""
        tabs = self._cache.get("host")
        if tabs is None:
            rows, gidx, gcoef = [], [], []
            for gi, k, _, _, cols, _, _ in self.blocks():
                g = self.plan.groups[gi]
                for q in self.qcols[(gi, k)]:
                    for u in range(q.mul):
                        rows.append((q.a_off + u, q.col_off, q.b_off + u))
                        gidx.append(g.w_off + (q.fc + u) * cols + np.arange(cols))
                        gcoef.append(np.full(cols, q.coeff))
            tabs = (np.asarray(rows, np.int64).reshape(-1, 3), np.concatenate(gidx),
                    np.concatenate(gcoef))
            self._cache["host"] = tabs
        return tabs

    def _on(self, key, device, make):
        k = (key, device)
        t = self._cache.get(k)
        if t is None:
            t = self._cache[k] = make()
        return t

    def row_index(self, device: torch.device):
        """(x column, SH column, w column) int64 [n_rows] each: the operands
        of each Kop column."""
        rows = self._host()[0]
        return self._on("rows", device,
                        lambda: tuple(torch.as_tensor(rows[:, i], device=device) for i in range(3)))

    def build_G(self, W_flat: torch.Tensor) -> torch.Tensor:
        """The flat G [numel] in W_flat's dtype: each (g, k) block [rows,
        cols] row-major, a triple's rows its coefficient times the fan rows
        of the packed W.  One gather and one product, differentiable in
        W_flat."""
        _, gidx, gcoef = self._host()
        dev = W_flat.device
        idx = self._on("gidx", dev, lambda: torch.as_tensor(gidx, device=dev))
        coef = self._on(("gcoef", W_flat.dtype), dev,
                        lambda: torch.as_tensor(gcoef, device=dev).to(W_flat.dtype))
        return W_flat[idx] * coef

    # ------------------------------------------------------- device tables
    def k1_tables(self, device: torch.device) -> KronFwdTables:
        """K8-F's tables on ``device`` in K1's layout (``DTPLinPlan.k1_tables``),
        as ``k1::kron_fwd_kernel`` (csrc/dtp_lin.cu) reads them.

        gk per (g, k), K1's 8 ints: its Kop rows padded to 16, cols, output
        column, the offset of its packed G block in ``gp_index``'s gather,
        its run range, its column n-tiles, its Kop rows n_k.  runs: per
        triple, its first Kop row in the (g, k) block, mul, w column, term
        range (one term).  terms: per triple x column, SH column, w column,
        first Kop row, mul; coeffs all 1.  ``gp_index`` gathers ``cat([G,
        0])`` into each (g, k)'s block [n_k, cols] in B-fragment order
        (``k1_pack_index``).  ``n_chunks``: the (g, k)'s column chunks of
        ``KRON_COLS``, a block each per 64-edge tile."""
        return self._on("k1", device, lambda: self._k1_tables(device))

    def _k1_tables(self, device):
        gk, runs, terms, index = [], [], [], []
        gp_off, vec = 0, K1_VEC if self.plan.d_x % K1_VEC == 0 and self.plan.d_w % K1_VEC == 0 \
            else 1
        for q, (gi, k, _, n, cols, out_col, g_off) in enumerate(self.blocks()):
            run_begin, fc = len(runs), 0
            for t in self.qcols[(gi, k)]:
                runs.append((fc, t.mul, t.b_off, len(terms), len(terms) + 1))
                terms.append((t.a_off, t.col_off, t.b_off, fc, t.mul))
                if (t.a_off | t.b_off | fc | t.mul) % K1_VEC:
                    vec = 1
                fc += t.mul
            gk.append((-(-n // 16) * 16, cols, out_col, gp_off, run_begin, len(runs),
                       -(-cols // 8), n))
            idx = k1_pack_index(n, cols, g_off, self.numel)
            index.append(idx)
            gp_off += idx.size
        i32 = lambda t: torch.tensor(t, dtype=torch.int32, device=device)  # noqa: E731
        return KronFwdTables(
            i32(gk), i32(runs), i32(terms),
            torch.ones(len(terms), dtype=torch.float32, device=device),
            torch.as_tensor(np.concatenate(index), device=device), max(r[0] for r in gk), vec,
            sum(-(-r[1] // KRON_COLS) for r in gk))

    def _local_dw(self):
        """(dwmap, per group its dw span (begin in dwmap, length), per w
        block its local dw column): a group's w blocks get consecutive local
        columns (every w column feeds one group, ``DTPLinPlan.bwd_tables``);
        none with shared weights."""
        plan = self.plan
        dwmap, spans, local = [], [], {}
        for gi in range(len(plan.groups)):
            begin = len(dwmap)
            if not plan.shared_weights:
                for b_off, mul in sorted({(q.b_off, q.mul) for (g_, _), qs in self.qcols.items()
                                          if g_ == gi for q in qs}):
                    local[b_off] = len(dwmap) - begin
                    dwmap.extend(range(b_off, b_off + mul))
            spans.append((begin, len(dwmap) - begin))
        return dwmap, spans, local

    def _fwd_tables(self, device):
        _, _, local = self._local_dw()
        gk, rows = [], []
        for gi, k, row0, n, cols, out_col, g_off in self.blocks():
            for q in self.qcols[(gi, k)]:
                rows.extend((q.a_off + u, q.col_off, q.b_off + u, local.get(q.b_off, 0) + u)
                            for u in range(q.mul))
            gk.append((row0, row0 + n, cols, out_col, g_off) + (0,) * 7)
        i32 = lambda t: torch.tensor(t, dtype=torch.int32, device=device)  # noqa: E731
        return i32(gk), i32(rows)

    def bwd_tables(self, device: torch.device) -> KronBwdTables:
        """K8-B's tables on ``device`` in K2's layout, as its two launches
        (csrc/dtp_lin_bwd.cu, k2::kron_dxdw_kernel and k2::kron_dG_kernel)
        read them.

        gk per (g, k), K2's 12 ints: its Kop rows n_k (the fan), cols,
        output column, its G element offset (dG's too), triple range, the
        offset of its packed G^T in ``gp_index``'s gather and its columns
        padded to 16 (the mma K step), its group's dw span (begin in
        ``dwmap``, length), first / last component of the group.  terms per
        triple: x column, SH column, w column, its first Kop row in the (g,
        k) block, mul, local dw column; coeffs all 1.  tiles: launch 2's dG
        tiles, (gk row, 1, first Kop row, rows, first column, columns),
        ``K2_FAN_TILE`` x ``K2_COL_TILE`` at most; together they cover every
        element of G once.  ``gp_index`` gathers ``cat([G, 0])`` into each
        (g, k)'s G^T [cols, n_k] in B-fragment order (``k2_pack_index``)."""
        return self._on("bwd", device, lambda: self._bwd_tables(device))

    def _bwd_tables(self, device):
        dwmap, spans, local = self._local_dw()
        gk, terms, tiles, index = [], [], [], []
        gp_off = 0
        for q, (gi, k, _, n, cols, out_col, g_off) in enumerate(self.blocks()):
            t_begin, fc = len(terms), 0
            for t in self.qcols[(gi, k)]:
                terms.append((t.a_off, t.col_off, t.b_off, fc, t.mul, local.get(t.b_off, 0)))
                fc += t.mul
            gk.append((n, cols, out_col, g_off, t_begin, len(terms), gp_off,
                       -(-cols // 16) * 16) + spans[gi]
                      + (int(k == 0), int(k == self.plan.groups[gi].ir.dim - 1)))
            for f0 in range(0, n, K2_FAN_TILE):
                for j0 in range(0, cols, K2_COL_TILE):
                    tiles.append((q, 1, f0, min(K2_FAN_TILE, n - f0), j0,
                                  min(K2_COL_TILE, cols - j0)))
            idx = k2_pack_index(n, n, cols, g_off, self.numel)
            index.append(idx)
            gp_off += idx.size
        i32 = lambda t: torch.tensor(t, dtype=torch.int32, device=device)  # noqa: E731
        return KronBwdTables(
            i32(gk), i32(terms), torch.ones(len(terms), dtype=torch.float32, device=device),
            i32(dwmap or [0]), i32(tiles), torch.as_tensor(np.concatenate(index), device=device),
            max(n for _, n in spans), max(r[7] for r in gk), max(-(-r[0] // 8) * 8 for r in gk))


def kron_meta(plan: DTPLinPlan) -> KronMeta:
    """The plan's ``KronMeta``, built once and kept on the plan."""
    meta = getattr(plan, "_kron_meta", None)
    if meta is None:
        meta = plan._kron_meta = KronMeta(plan)
    return meta


def _kop(meta: KronMeta, x, sh, w, r0: int, n: int) -> torch.Tensor:
    """Kop [E, n] for the flat rows r0..r0+n, in x's dtype."""
    xi, col, wi = (t[r0 : r0 + n] for t in meta.row_index(x.device))
    k = sh[:, col] * x[:, xi]
    return k if w is None else k * w[:, wi]


def dtp_lin_kron_plain(meta, x, sh, w, G, n_edges=None):
    """Plain version of K8-F: [E, d_out].  ``w`` [E, d_w], or None when the
    plan's shared weights are folded into G; ``G`` the flat ``build_G``."""
    out = x.new_empty((sh.shape[0], meta.plan.d_out))
    for _, _, row0, n, cols, oc, g_off in meta.blocks():
        out[:, oc : oc + cols] = _kop(meta, x, sh, w, row0, n) @ G[g_off : g_off + n * cols] \
            .view(n, cols)
    return _zero_past(out, n_edges)


def dtp_lin_kron_bwd_plain(meta, x, sh, w, G, g, n_edges=None):
    """Plain version of K8-B for the cotangent ``g`` [E, d_out] of
    ``dtp_lin_kron_plain``: (dx [E, d_x], dw [E, d_w] or None when ``w`` is
    None, dG [numel] in float32, or float64 for float64 inputs), written out
    per (g, k): dkop = g G^T, dG = Kop^T g, and per Kop column dx += sh dkop
    w, dw += sh dkop x."""
    plan = meta.plan
    g = _zero_past(g, n_edges)
    acc = torch.promote_types(x.dtype, torch.float32)
    E = sh.shape[0]
    dx = torch.zeros((E, plan.d_x), dtype=acc, device=x.device)
    dw = None if w is None else torch.zeros((E, plan.d_w), dtype=acc, device=x.device)
    dG = torch.zeros((meta.numel,), dtype=acc, device=x.device)
    xi_all, col_all, wi_all = meta.row_index(x.device)
    for _, _, row0, n, cols, oc, g_off in meta.blocks():
        gb = g[:, oc : oc + cols]
        Gb = G[g_off : g_off + n * cols].view(n, cols)
        kop = _kop(meta, x, sh, w, row0, n)
        dG[g_off : g_off + n * cols] = (kop.to(acc).T @ gb.to(acc)).reshape(-1)
        xi, col, wi = (t[row0 : row0 + n] for t in (xi_all, col_all, wi_all))
        d = (gb @ Gb.T).to(x.dtype).to(acc) * sh[:, col].to(acc)
        if w is None:
            dx.index_add_(1, xi, d)
        else:
            dx.index_add_(1, xi, d * w[:, wi].to(acc))
            dw.index_add_(1, wi, d * x[:, xi].to(acc))
    return dx.to(x.dtype), None if dw is None else dw.to(x.dtype), dG


def _check_operands(meta: KronMeta, x, sh, w, G):
    """Shapes, dtypes and devices the kernels take; returns x with a row
    stride of 0 or d_x and contiguous sh / w / G."""
    plan = meta.plan
    E = sh.shape[0]
    if x.dim() != 2 or x.shape != (E, plan.d_x) or sh.shape != (E, plan.d_sh):
        raise ValueError(f"bad shapes x {tuple(x.shape)} sh {tuple(sh.shape)}")
    _build.dtype_code(x)
    if plan.shared_weights:
        if w is not None:
            raise ValueError("shared weights are folded into G before the kernel")
    elif w is None or w.shape != (E, plan.d_w):
        raise ValueError(f"per-edge w must be [{E}, {plan.d_w}]")
    if G.shape != (meta.numel,):
        raise ValueError("G does not match the plan's kron layout")
    for t in (sh, G) + (() if w is None else (w,)):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError("x, sh, w and G must share a dtype and a device")
    if x.stride(1) != 1 or (x.stride(0) not in (0, plan.d_x)):
        x = x.contiguous()
    return x, sh.contiguous(), None if w is None else w.contiguous(), G.contiguous()


def dtp_lin_kron_fwd(meta, x: torch.Tensor, sh: torch.Tensor, w, G: torch.Tensor,
                     n_edges=None) -> torch.Tensor:
    """K8-F: [E, d_out].  ``meta`` the plan's ``KronMeta``; x [E, d_x]
    (a row-broadcast ``expand`` is read with row stride 0), sh [E, d_sh], w
    [E, d_w] or None for a shared-weight plan (folded into G), G the flat
    ``build_G``, ``n_edges`` an int32 device scalar or None.  A block per
    (64-edge tile, 128-column chunk of a (g, k)) over ``meta.k1_tables``
    (``csrc/dtp_lin.cu``, ``k1::kron_fwd_kernel``): Kop built 32 rows at a
    time into shared memory, times the chunk of the (g, k)'s block of G on
    the tensor cores into registers, G packed in B-fragment order by one
    gather a call.  CPU tensors take ``dtp_lin_kron_plain``; CUDA tensors
    launch the kernel (float32 or bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_lin_kron_plain(meta, x, sh, w, G, n_edges)
    plan, E = meta.plan, sh.shape[0]
    x, sh, w, G = _check_operands(meta, x, sh, w, G)
    n_edges = _check_n_edges(n_edges, E, x.device)
    kt = meta.k1_tables(x.device)
    out = torch.empty((E, plan.d_out), dtype=x.dtype, device=x.device)
    if E == 0:
        return out
    zero = meta._on(("zero", G.dtype), G.device, lambda: G.new_zeros(1))
    Gp = torch.cat([G, zero])[kt.gp_index]
    # x and w read a quad at a time through L2: both 16-byte aligned
    aligned = x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0 and (w is None
                                                                    or w.data_ptr() % 16 == 0)
    err = _build.library().dtp_lin_kron_fwd(
        _build.ptr(x), x.stride(0), _build.ptr(sh), plan.d_sh, _build.ptr(w), plan.d_w,
        _build.ptr(Gp), _build.ptr(out), plan.d_out, _build.ptr(n_edges), E, _build.ptr(kt.gk),
        kt.gk.shape[0], _build.ptr(kt.runs), _build.ptr(kt.terms), _build.ptr(kt.coeffs),
        kt.fz_max, kt.vec if aligned else 1, kt.n_chunks, _build.dtype_code(x),
        _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_kron_fwd")
    dtp_lin_kron_fwd.launches += 1
    return out


def dtp_lin_kron_bwd(meta, x: torch.Tensor, sh: torch.Tensor, w, G: torch.Tensor,
                     g: torch.Tensor, n_edges=None):
    """K8-B: (dx [E, d_x], dw [E, d_w] or None, dG [numel] float32) for the
    cotangent ``g`` [E, d_out] of ``dtp_lin_kron_fwd`` on the same
    operands, on K2's two launches over ``meta.bwd_tables``
    (``csrc/dtp_lin_bwd.cu``): dx and dw per 16-edge tile with dkop = g
    G^T on the tensor cores (G^T packed in fragment order by one gather a
    call), dG = Kop^T g per tile of G and edge range (``k2_ranges``), and the
    fixed-order sum of the ranges' partial rows.  CPU tensors take
    ``dtp_lin_kron_bwd_plain``; CUDA tensors launch the kernels (float32 or
    bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_lin_kron_bwd_plain(meta, x, sh, w, G, g, n_edges)
    plan, E = meta.plan, sh.shape[0]
    x, sh, w, G = _check_operands(meta, x, sh, w, G)
    if g.shape != (E, plan.d_out) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"cotangent must be [{E}, {plan.d_out}] in x's dtype and device")
    g = g.contiguous()
    dev = x.device
    n_edges = _check_n_edges(n_edges, E, dev)
    kt = meta.bwd_tables(dev)
    dx = torch.empty((E, plan.d_x), dtype=x.dtype, device=dev)
    dw = None
    if w is not None:
        dw = (torch.zeros if plan.dw_has_dead_cols else torch.empty)(
            (E, plan.d_w), dtype=x.dtype, device=dev)
    dG = torch.empty((meta.numel,), dtype=torch.float32, device=dev)
    if E == 0:
        return dx, dw, dG.zero_()
    Gp = torch.cat([G, G.new_zeros(1)])[kt.gp_index]
    n_tiles = kt.tiles.shape[0]
    n_ranges, range_len = k2_ranges(E, n_tiles, _sm_count(dev))
    part = torch.empty((n_ranges, meta.numel), dtype=torch.float32, device=dev)
    err = _build.library().dtp_lin_kron_bwd(
        _build.ptr(x), x.stride(0), plan.d_x, _build.ptr(sh), plan.d_sh, _build.ptr(w),
        plan.d_w, _build.ptr(Gp), _build.ptr(g), plan.d_out, _build.ptr(n_edges), E,
        _build.ptr(kt.gk), kt.gk.shape[0], _build.ptr(kt.terms), _build.ptr(kt.coeffs),
        _build.ptr(kt.dwmap), _build.ptr(dx), _build.ptr(dw), kt.span_max, kt.cp_max,
        kt.fd_max, _build.ptr(kt.tiles), n_tiles, _build.ptr(part), n_ranges, range_len,
        _build.ptr(dG), meta.numel, _build.dtype_code(x), _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_kron_bwd")
    dtp_lin_kron_bwd.launches += 1
    return dx, dw, dG


dtp_lin_kron_fwd.launches = 0
dtp_lin_kron_bwd.launches = 0


class _DTPLinKron(torch.autograd.Function):
    """K8-F forward, K8-B backward; gradients for x, w and G (not sh).
    First order only: the backward is not differentiable."""

    @staticmethod
    def forward(ctx, meta, x, sh, w, G, n_edges):
        ctx.meta = meta
        ctx.save_for_backward(x, sh, w, G, n_edges)
        return dtp_lin_kron_fwd(meta, x, sh, w, G, n_edges)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, sh, w, G, n_edges = ctx.saved_tensors
        dx, dw, dG = dtp_lin_kron_bwd(ctx.meta, x, sh, w, G, g, n_edges)
        # JAX's precision caveat: dG is rounded to G's dtype before it
        # chains to dW through build_G
        return None, dx, None, dw, dG.to(G.dtype), None


def dtp_lin_kron(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w,
                 W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """The fused DTP + linear heads on the kron route, with the call
    signature of ``dtp_lin``: [E, plan.d_out], differentiable (first order)
    in x, w (per-edge or shared) and W_flat.  A shared w is folded into
    W_flat and G is built from W_flat here, outside the autograd op.
    Raises if ``sh`` needs a gradient."""
    if sh.requires_grad:
        raise ValueError("dtp_lin_kron computes no gradient for sh (the kron route is "
                         "first order and takes no position gradient)")
    meta = kron_meta(plan)
    w, W_flat = fold_shared_weights(plan, w, W_flat)
    return _DTPLinKron.apply(meta, x, sh, w, meta.build_G(W_flat), n_edges)
