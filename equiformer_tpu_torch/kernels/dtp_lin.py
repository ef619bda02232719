"""Fused depthwise tensor product + per-irrep linear heads (K1 forward, K2 backward).

Counterpart of ``equiformer_tpu/kernels/dtp_lin_pallas.py``
(``make_fused_dtp_lin`` -> ``_fwd_kernel``, ``make_bwd_call`` ->
``_bwd_kernel``): per edge, the depthwise ('uvu') TP with the SH

    z[g, k][fan col fc + u] += c * sh[col] * x[a_off + u] * w[b_off + u]

followed, per irrep group ``g`` and component ``k``, by ``z[g, k] @ W_g`` for
all linear heads reading z at once.  z (3136 wide for the flagship) never
goes to device memory, in the forward or the backward (which recomputes
it).  Two launch modes share each kernel: per-edge ``w`` (``sep_act``, the
edge-degree embedding) and shared weights folded into the rows of ``W``
(``sep_value``).  The fold runs outside the autograd op, as in JAX, so
autograd turns the folded ``dW`` into the gradients of ``W`` and of the
shared ``w``.  Rows at or past ``n_edges`` (a device scalar) are written as
zeros and get zero gradients.

``DTPLinPlan`` is the port's own plan: the term table from the port's CG
tables, the irrep groups, weight packing and output splitting.  It keeps no
TPU layout tricks (no 128-lane slots, fan padding or lane packing): a
group's fan is padded only to a multiple of 4 for vector loads.
``dtp_lin_plain`` (einsum TP + the heads' linear maps) and
``dtp_lin_bwd_plain`` (the same backward written out per group and term)
are the plain versions.

The radial fold (K7, JAX's ``EQUIFORMER_TPU_FOLD_RADIAL``): a plan with
``radial_fold=hd`` takes, in place of ``w``, the radial MLP's last hidden
activation ``h`` [E, hd] and ``Wrs = [Wr; offset]`` [hd + 1, d_w]
(``pack_radial``), and the kernels build ``w = h @ Wr + offset`` on chip:
K7-F ``dtp_lin_rad_fwd`` and K7-B ``dtp_lin_rad_bwd`` (dx, dh, d[Wr;
offset], dW), with the plain versions ``dtp_lin_rad_plain`` and
``dtp_lin_rad_bwd_plain``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.irreps import Irreps
from ..core.tensor_product import TensorProduct, split_blocks
from . import _build
from .dtp import plan_terms


class Group(NamedTuple):
    ir: object  # Irrep
    blocks: Tuple[int, ...]  # tp.irreps_out block indices of this irrep
    fan_slot: Dict[int, int]  # block index -> first fan column
    fan: int  # sum of the blocks' multiplicities
    fan_stride: int  # fan rounded up to 4 (rows of the packed W)
    cols: int  # output columns of all heads together
    out_off: int  # offset of the group in the fused flat output
    w_off: int  # offset of the group's [fan_stride, cols] W in the flat buffer


class DTPLinPlan:
    """Static metadata for the fused DTP + linear heads.

    ``tp`` is a depthwise plan with mul-1 SH; head ``h`` is
    ``IrrepsLinear(tp.irreps_out, head_irreps[h])`` reading the whole
    unsimplified TP output.  ``shared_weights`` means ``w`` is one internal
    vector, folded into the rows of ``W`` per call; otherwise ``w`` holds raw
    external per-edge weights, and their fan-in rescale is folded into the
    CG coefficients (``fold_rescale``).  ``radial_fold`` (the radial MLP's
    last hidden width, a multiple of 4) makes the per-edge operand ``(h,
    [Wr; offset])`` instead of ``w``; it is ignored with shared weights, as
    in JAX.
    """

    def __init__(self, tp: TensorProduct, head_irreps: Sequence[Irreps],
                 shared_weights: bool = False, radial_fold: Optional[int] = None):
        self.tp = tp
        self.head_irreps = [Irreps(h) for h in head_irreps]
        self.shared_weights = shared_weights
        self.radial_fold = None if shared_weights else radial_fold
        if self.radial_fold is not None and (self.radial_fold <= 0 or self.radial_fold % 4):
            raise ValueError(f"radial_fold {radial_fold}: the hidden width must be a "
                             f"positive multiple of 4")
        self.fold_rescale = fold_rescale = not shared_weights
        self.d_x = tp.irreps_in1.dim
        self.d_sh = tp.irreps_in2.dim
        self.d_w = tp.weight_numel

        order, by_ir = [], {}
        for bo, (_, ir) in enumerate(tp.irreps_out):
            if ir not in by_ir:
                by_ir[ir] = []
                order.append(ir)
            by_ir[ir].append(bo)

        # head_cols[h] = [(target block, irrep, first column in group or -1, mul_out)]
        self.head_cols: List[List[Tuple[int, object, int, int]]] = []
        group_cols = {ir: 0 for ir in order}
        for hirr in self.head_irreps:
            segs = []
            for ti, (mul_out, ir_out) in enumerate(hirr):
                if ir_out not in group_cols:
                    segs.append((ti, ir_out, -1, mul_out))  # IrrepsLinear emits zeros
                    continue
                segs.append((ti, ir_out, group_cols[ir_out], mul_out))
                group_cols[ir_out] += mul_out
            self.head_cols.append(segs)

        self.groups: List[Group] = []
        out_off = w_off = 0
        for ir in order:
            cols = group_cols[ir]
            if cols == 0:
                continue  # no head reads this irrep: its terms are dropped
            fan_slot, fan = {}, 0
            for bo in by_ir[ir]:
                fan_slot[bo] = fan
                fan += tp.irreps_out[bo].mul
            fan_stride = -(-fan // 4) * 4
            self.groups.append(Group(ir, tuple(by_ir[ir]), fan_slot, fan, fan_stride,
                                     cols, out_off, w_off))
            out_off += ir.dim * cols
            w_off += fan_stride * cols
        self.d_out = out_off
        self.w_numel = w_off

        # z column -> (group, component, fan column) for live blocks
        out_slices = tp.irreps_out.slices()
        zmap = {}
        for gi, g in enumerate(self.groups):
            for bo in g.blocks:
                mul = tp.irreps_out[bo].mul
                for k in range(g.ir.dim):
                    zmap[out_slices[bo].start + k * mul] = (gi, k, g.fan_slot[bo])
        self.terms = sorted(
            ((t, zmap[t.out_off]) for t in plan_terms(tp, fold_rescale)
             if t.out_off in zmap),
            key=lambda tz: tz[1],
        )
        written = {loc for _, loc in self.terms}
        for gi, g in enumerate(self.groups):
            for bo in g.blocks:
                for k in range(g.ir.dim):
                    if (gi, k, g.fan_slot[bo]) not in written:
                        raise ValueError("a fan column of z is never written")

        if shared_weights:
            # fold: z @ (diag(w rows) W) == (z * w cols) @ W, one w entry per
            # fan row; a fan row fed by two weight paths cannot be folded
            src = {}
            for t, (gi, _, fc) in self.terms:
                if src.setdefault((gi, fc), (t.b_off, t.mul)) != (t.b_off, t.mul):
                    raise ValueError("fan column fed by several weight paths")
            elem = np.full((self.w_numel,), self.d_w, np.int64)  # d_w -> 0
            for (gi, fc), (b_off, mul) in src.items():
                g = self.groups[gi]
                for u in range(mul):
                    row0 = g.w_off + (fc + u) * g.cols
                    elem[row0 : row0 + g.cols] = b_off + u
            self._fold_index = elem
        self._tables: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self._fold_cache: Dict[torch.device, torch.Tensor] = {}

    @property
    def max_fan_stride(self) -> int:
        return max(g.fan_stride for g in self.groups)

    # ------------------------------------------------------------- weights
    def pack_weights(self, head_weights: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
        """``head_weights[h][i]``: the ``IrrepsLinear`` weight [fan, mul_out] of
        head h's i-th output block (``weight_list`` order).  Returns the flat
        buffer of per-group [fan_stride, cols] matrices (zero pad rows)."""
        flat = []
        for g in self.groups:
            pieces = [head_weights[h][ti]
                      for h, segs in enumerate(self.head_cols)
                      for ti, ir, col0, _ in segs if ir == g.ir and col0 >= 0]
            W = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
            if W.shape[0] != g.fan:
                raise ValueError(f"head weight has {W.shape[0]} rows, group fan {g.fan}")
            if g.fan_stride != g.fan:
                W = torch.cat([W, W.new_zeros(g.fan_stride - g.fan, g.cols)])
            flat.append(W.reshape(-1))
        return torch.cat(flat)

    def group_weight(self, W_flat: torch.Tensor, gi: int) -> torch.Tensor:
        g = self.groups[gi]
        return W_flat[g.w_off : g.w_off + g.fan_stride * g.cols].view(g.fan_stride, g.cols)

    def fold_shared(self, w: torch.Tensor, W_flat: torch.Tensor) -> torch.Tensor:
        """Scale each fan row of the packed W by its shared weight entry."""
        idx = self._fold_cache.get(W_flat.device)
        if idx is None:
            idx = torch.as_tensor(self._fold_index, device=W_flat.device)
            self._fold_cache[W_flat.device] = idx
        w_ext = torch.cat([w.reshape(-1).to(W_flat.dtype), W_flat.new_zeros(1)])
        return W_flat * w_ext[idx]

    # -------------------------------------------------------------- output
    def split_output(self, out_flat: torch.Tensor) -> List[torch.Tensor]:
        """Fused flat output -> per-head flat arrays in ``IrrepsLinear`` layout."""
        heads = []
        for h, _ in enumerate(self.head_irreps):
            pieces = []
            for _, ir_out, col0, mul_out in self.head_cols[h]:
                if col0 < 0:
                    pieces.append(out_flat.new_zeros(out_flat.shape[:-1] + (ir_out.dim * mul_out,)))
                    continue
                g = next(g for g in self.groups if g.ir == ir_out)
                for k in range(ir_out.dim):
                    s = g.out_off + k * g.cols + col0
                    pieces.append(out_flat[..., s : s + mul_out])
            heads.append(torch.cat(pieces, dim=-1) if len(pieces) > 1 else pieces[0])
        return heads

    # -------------------------------------------------------- device tables
    def device_tables(self, device: torch.device):
        """(gk int32 [n_gk, 8], terms int32 [n_terms, 5], coeffs float32) on
        ``device``; terms sorted by (group, component, fan column)."""
        tabs = self._tables.get(device)
        if tabs is None:
            gk, tt, cc = [], [], []
            for gi, g in enumerate(self.groups):
                for k in range(g.ir.dim):
                    begin = len(tt)
                    for t, (tg, tk, fc) in self.terms:
                        if (tg, tk) == (gi, k):
                            tt.append((t.a_off, t.col_off, t.b_off, fc, t.mul))
                            cc.append(t.coeff)
                    # 8 ints per entry (two spare), as csrc/dtp_lin.cu reads them
                    gk.append((g.fan_stride, g.cols, g.out_off + k * g.cols, g.w_off,
                               begin, len(tt), 0, 0))
            tabs = (
                torch.tensor(gk, dtype=torch.int32, device=device),
                torch.tensor(tt, dtype=torch.int32, device=device),
                torch.tensor(cc, dtype=torch.float32, device=device),
            )
            self._tables[device] = tabs
        return tabs

    def bwd_tables(self, device: torch.device):
        """The backward's tables on ``device``, as csrc/dtp_lin_bwd.cu reads
        them: (gk int32 [n_gk, 12], terms int32 [n_terms, 6], coeffs float32,
        dwmap int32, wt_index int64, span_max, cols_pad_max).

        gk per (group, component): fan_stride, cols, output column, W offset,
        term range, W^T offset and padded column count, the group's dw span
        (begin in ``dwmap``, length), first / last component.  A group's w
        blocks get consecutive local dw columns (``dwmap`` maps them back to
        w columns): every w column feeds exactly one group, so the kernel
        keeps only one group's dw in shared memory.  ``wt_index`` gathers
        ``cat([W_flat, 0])`` into each group's [cols_pad, fan_stride] W^T."""
        key = ("bwd", device)
        tabs = self._tables.get(key)
        if tabs is not None:
            return tabs
        per_edge_w = not self.shared_weights
        b_loc, spans, dwmap = [], [], []
        for gi in range(len(self.groups)):
            local = {}
            begin = len(dwmap)
            if per_edge_w:
                for b_off, mul in sorted({(t.b_off, t.mul) for t, (tg, _, _) in self.terms
                                          if tg == gi}):
                    local[b_off] = len(dwmap) - begin
                    dwmap.extend(range(b_off, b_off + mul))
            spans.append((begin, len(dwmap) - begin))
            # self.terms is sorted by group first, so b_loc follows its order
            b_loc.extend(local.get(t.b_off, 0) for t, (tg, _, _) in self.terms if tg == gi)
        gk, tt, cc, wt_index = [], [], [], []
        by_gk: Dict[Tuple[int, int], list] = {}
        for (t, (tg, tk, fc)), bl in zip(self.terms, b_loc):
            by_gk.setdefault((tg, tk), []).append((t, fc, bl))
        wt_off = 0
        for gi, g in enumerate(self.groups):
            cp = -(-g.cols // 4) * 4
            j, f = np.meshgrid(np.arange(cp), np.arange(g.fan_stride), indexing="ij")
            wt_index.append(np.where(j < g.cols, g.w_off + f * g.cols + j, self.w_numel)
                            .reshape(-1))
            for k in range(g.ir.dim):
                begin = len(tt)
                for t, fc, bl in by_gk.get((gi, k), ()):
                    tt.append((t.a_off, t.col_off, t.b_off, fc, t.mul, bl))
                    cc.append(t.coeff)
                gk.append((g.fan_stride, g.cols, g.out_off + k * g.cols, g.w_off, begin,
                           len(tt), wt_off, cp) + spans[gi]
                          + (int(k == 0), int(k == g.ir.dim - 1)))
            wt_off += cp * g.fan_stride
        tabs = (
            torch.tensor(gk, dtype=torch.int32, device=device),
            torch.tensor(tt, dtype=torch.int32, device=device),
            torch.tensor(cc, dtype=torch.float32, device=device),
            torch.tensor(dwmap or [0], dtype=torch.int32, device=device),
            torch.as_tensor(np.concatenate(wt_index), device=device),
            max(n for _, n in spans),
            max(-(-g.cols // 4) * 4 for g in self.groups),
        )
        self._tables[key] = tabs
        return tabs

    def pack_radial(self, Wr: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        """``[Wr; offset]`` [hd + 1, d_w] (the TP's own weight order), built
        with ``torch.cat`` outside the fused op, so autograd splits its
        gradient into dWr and doffset."""
        hd = self.radial_fold
        if hd is None or Wr.shape != (hd, self.d_w) or offset.shape != (self.d_w,):
            raise ValueError(f"Wr must be [{hd}, {self.d_w}] and offset [{self.d_w}] "
                             f"for this plan (radial_fold={hd})")
        return torch.cat([Wr, offset.to(Wr.dtype)[None]])

    def radial_cols(self, device: torch.device) -> torch.Tensor:
        """int64 [n_loc]: the w columns of each group in the backward tables'
        local order (``dwmap``), which the folded kernels read [Wr; offset]
        in; the columns that feed no live group are left out."""
        key = ("rad", device)
        cols = self._tables.get(key)
        if cols is None:
            cols = self.bwd_tables(device)[3].long()
            self._tables[key] = cols
        return cols

    @property
    def dw_has_dead_cols(self) -> bool:
        """Whether some w column feeds no live group (its dw stays zero)."""
        return sum(m for _, m in {(t.b_off, t.mul) for t, _ in self.terms}) != self.d_w


def _zero_past(out: torch.Tensor, n_edges) -> torch.Tensor:
    if n_edges is None:
        return out
    rows = torch.arange(out.shape[0], device=out.device) < n_edges
    return torch.where(rows[:, None], out, torch.zeros_like(out))


def _group_z(plan: DTPLinPlan, z: torch.Tensor, gi: int, k: int) -> torch.Tensor:
    """Component k of group gi's fan, [E, fan], gathered from the TP output."""
    g = plan.groups[gi]
    slices = plan.tp.irreps_out.slices()
    cols = []
    for bo in g.blocks:
        mul = plan.tp.irreps_out[bo].mul
        s = slices[bo].start + k * mul
        cols.append(z[:, s : s + mul])
    return torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]


def dtp_lin_plain(plan: DTPLinPlan, x, sh, w, W_flat, n_edges=None):
    """Plain version: the einsum TP, then each group's z columns times its
    packed linear weights.  ``w`` is [E, d_w] per edge, the shared [d_w], or
    None when shared weights are already folded into ``W_flat``."""
    z = plan.tp.apply(x, sh, w, scale_weights=plan.fold_rescale)
    pieces = []
    for gi, g in enumerate(plan.groups):
        W = plan.group_weight(W_flat, gi)[: g.fan]
        for k in range(g.ir.dim):
            pieces.append(_group_z(plan, z, gi, k) @ W)
    return _zero_past(torch.cat(pieces, dim=1), n_edges)


def plain_dz(plan: DTPLinPlan, W_flat, g) -> torch.Tensor:
    """dz [E, tp.irreps_out.dim]: each group's cotangent slices times its
    packed W transposed, placed at the TP output's columns (zero where no
    head reads them)."""
    tp = plan.tp
    slices = tp.irreps_out.slices()
    dz = g.new_zeros((g.shape[0], tp.irreps_out.dim))
    for gi, grp in enumerate(plan.groups):
        W = plan.group_weight(W_flat, gi)[: grp.fan]
        for k in range(grp.ir.dim):
            dzk = g[:, grp.out_off + k * grp.cols : grp.out_off + (k + 1) * grp.cols] @ W.T
            for bo in grp.blocks:
                mul = tp.irreps_out[bo].mul
                s = slices[bo].start + k * mul
                fc = grp.fan_slot[bo]
                dz[:, s : s + mul] = dzk[:, fc : fc + mul]
    return dz


def plain_transposes(plan: DTPLinPlan, x, sh, w, dz, want=("x", "sh", "w")):
    """The transposes of each depthwise path
    z[e,k,u] = s * sum_ij C[i,j,k] x[e,i,u] sh[e,j] w[e,u] for the TP output
    cotangent ``dz``: (dx, dw, dsh) in dz's dtype, each None unless named in
    ``want``.  ``w`` None means a weight of 1 (shared weights folded into W,
    or the w transpose itself, which never reads w); the x transpose never
    reads ``x`` nor the sh transpose ``sh``, which may then be None."""
    tp = plan.tp
    E = dz.shape[0]
    xb = None if x is None else split_blocks(x, tp.irreps_in1)
    shb = None if sh is None else split_blocks(sh, tp.irreps_in2)
    dzb = split_blocks(dz, tp.irreps_out)

    def zeros(mul_ir):
        return torch.zeros((E, mul_ir.ir.dim, mul_ir.mul), dtype=dz.dtype, device=dz.device)

    dxb = [zeros(mi) for mi in tp.irreps_in1] if "x" in want else None
    dshb = [zeros(mi) for mi in tp.irreps_in2] if "sh" in want else None
    dw = (torch.zeros((E, plan.d_w), dtype=dz.dtype, device=dz.device)
          if "w" in want else None)
    for idx, ins in enumerate(tp.instructions):
        C = tp._cg_tensor(idx, dz.dtype, dz.device)
        if shb is not None:
            M = torch.einsum("ej,ijk->eki", shb[ins.i_in2][:, :, 0], C)
        scale = tp.slice_sqrt_k[ins.i_out] if plan.fold_rescale else 1.0
        d = dzb[ins.i_out] * scale  # [E, d3, mul]
        off, mul = tp._offsets[idx], tp.irreps_in1[ins.i_in1].mul
        if dw is not None:
            dw[:, off : off + mul] = torch.einsum(
                "eku,eki,eiu->eu", d, M, xb[ins.i_in1])
        if w is not None:
            d = d * w[:, off : off + mul][:, None, :]
        if dxb is not None:
            dxb[ins.i_in1] = dxb[ins.i_in1] + torch.einsum("eku,eki->eiu", d, M)
        if dshb is not None:
            dshb[ins.i_in2] = dshb[ins.i_in2] + torch.einsum(
                "eku,ijk,eiu->ej", d, C, xb[ins.i_in1])[:, :, None]
    dx = None if dxb is None else torch.cat([b.reshape(E, -1) for b in dxb], dim=1)
    dsh = None if dshb is None else torch.cat([b.reshape(E, -1) for b in dshb], dim=1)
    return dx, dw, dsh


def dtp_lin_legW_plain(plan: DTPLinPlan, g, x, sh, w, n_edges=None):
    """Plain version of the head-weight leg (K5c): the gradient of the packed
    ``W_flat`` [w_numel] for the cotangent ``g`` [E, d_out] of
    ``dtp_lin_plain``, dW_g = sum over edges and components of z[g,k]^T
    g[g,k] with z the TP output; float32, or float64 for float64 inputs."""
    g = _zero_past(g, n_edges)
    z = plan.tp.apply(x, sh, w, scale_weights=plan.fold_rescale)
    acc = torch.promote_types(g.dtype, torch.float32)
    dW = torch.zeros((plan.w_numel,), dtype=acc, device=g.device)
    for gi, grp in enumerate(plan.groups):
        dWg = torch.zeros((grp.fan_stride, grp.cols), dtype=acc, device=g.device)
        for k in range(grp.ir.dim):
            gk = g[:, grp.out_off + k * grp.cols : grp.out_off + (k + 1) * grp.cols]
            dWg[: grp.fan] += _group_z(plan, z, gi, k).to(acc).T @ gk.to(acc)
        dW[grp.w_off : grp.w_off + grp.fan_stride * grp.cols] = dWg.reshape(-1)
    return dW


def dtp_lin_bwd_plain(plan: DTPLinPlan, x, sh, w, W_flat, g, n_edges=None):
    """Plain backward of ``dtp_lin_plain`` for the cotangent ``g`` [E, d_out],
    written out per group and TP path: returns (dx [E, d_x], dw [E, d_w] or
    None when ``w`` is None, dW_flat [w_numel] in float32, or float64 for
    float64 inputs).  No dsh."""
    dW = dtp_lin_legW_plain(plan, g, x, sh, w, n_edges)
    dz = plain_dz(plan, W_flat, _zero_past(g, n_edges)).to(x.dtype)
    dx, dw, _ = plain_transposes(plan, x, sh, w, dz, ("x",) if w is None else ("x", "w"))
    return dx.to(x.dtype), None if dw is None else dw.to(w.dtype), dW


def radial_w_plain(h: torch.Tensor, Wrs: torch.Tensor) -> torch.Tensor:
    """``w = [h, 1] @ [Wr; offset]`` summed in at least fp32 and rounded to
    h's dtype, where the folded kernels round it (in shared memory) and the
    unfolded route stores it."""
    acc = torch.promote_types(h.dtype, torch.float32)
    return (h.to(acc) @ Wrs[:-1].to(acc) + Wrs[-1].to(acc)).to(h.dtype)


def radial_dh_plain(Wrs: torch.Tensor, dw: torch.Tensor, dtype) -> torch.Tensor:
    """``dh = dw @ Wr^T`` summed in at least fp32, in ``dtype``."""
    acc = torch.promote_types(dw.dtype, torch.float32)
    return (dw.to(acc) @ Wrs[:-1].to(acc).T).to(dtype)


def radial_dWrs_plain(h: torch.Tensor, dw: torch.Tensor, n_edges=None) -> torch.Tensor:
    """``d[Wr; offset] = [h, 1]^T @ dw`` over the rows below ``n_edges``, in
    float32 (float64 for float64 inputs): the ones column gives doffset, so
    padded rows must add nothing."""
    acc = torch.promote_types(h.dtype, torch.float32)
    hx = torch.cat([h.to(acc), torch.ones_like(h[:, :1], dtype=acc)], dim=1)
    return _zero_past(hx, n_edges).T @ _zero_past(dw.to(acc), n_edges)


def dtp_lin_rad_plain(plan: DTPLinPlan, x, sh, h, Wrs, W_flat, n_edges=None):
    """Plain version of K7-F: ``dtp_lin_plain`` of ``w = radial_w_plain(h,
    Wrs)`` (w rounded to h's dtype, as the kernel rounds it)."""
    return dtp_lin_plain(plan, x, sh, radial_w_plain(h, Wrs), W_flat, n_edges)


def dtp_lin_rad_bwd_plain(plan: DTPLinPlan, x, sh, h, Wrs, W_flat, g, n_edges=None):
    """Plain version of K7-B: (dx [E, d_x], dh [E, hd] in h's dtype, d[Wr;
    offset] [hd + 1, d_w] and dW_flat [w_numel] in float32, or float64 for
    float64 inputs) for the cotangent ``g`` of ``dtp_lin_rad_plain``.  dz
    and dw round to the compute dtype here; the kernel keeps them in fp32."""
    w = radial_w_plain(h, Wrs)
    dx, dw, dW = dtp_lin_bwd_plain(plan, x, sh, w, W_flat, g, n_edges)
    return dx, radial_dh_plain(Wrs, dw, h.dtype), radial_dWrs_plain(h, dw, n_edges), dW


def _check_n_edges(n_edges, E: int, device) -> torch.Tensor:
    if n_edges is None:
        return torch.full((), E, dtype=torch.int32, device=device)
    if n_edges.dtype != torch.int32 or n_edges.numel() != 1 or n_edges.device != device:
        raise TypeError("n_edges must be an int32 scalar tensor on x's device")
    return n_edges


def _check_operands(plan: DTPLinPlan, x, sh, w, W_flat):
    """Shapes, dtypes and devices the kernels take; returns x with a row
    stride of 0 or d_x and contiguous sh / w / W_flat.  ``w`` is the
    per-edge w, None (shared weights), or the radial fold's ``(h, Wrs)``,
    returned as ``(h, Wl)``: Wl is [Wr; offset] with its columns in the
    backward tables' local order (``plan.radial_cols``), as the folded
    kernels read it."""
    E = sh.shape[0]
    if x.dim() != 2 or x.shape != (E, plan.d_x) or sh.shape != (E, plan.d_sh):
        raise ValueError(f"bad shapes x {tuple(x.shape)} sh {tuple(sh.shape)}")
    _build.dtype_code(x)
    folded = isinstance(w, tuple)
    if folded:
        hd = plan.radial_fold
        if hd is None or w[0].shape != (E, hd) or w[1].shape != (hd + 1, plan.d_w):
            raise ValueError(f"the radial fold takes h [{E}, {hd}] and [Wr; offset] "
                             f"[hd + 1, {plan.d_w}] (plan radial_fold={hd})")
        edge = w
    elif plan.shared_weights:
        if w is not None:
            raise ValueError("shared weights are folded into W_flat before the kernel")
        edge = ()
    elif w is None or w.shape != (E, plan.d_w):
        raise ValueError(f"per-edge w must be [{E}, {plan.d_w}]")
    else:
        edge = (w,)
    if W_flat.shape != (plan.w_numel,):
        raise ValueError("W_flat does not match the plan")
    for t in (sh, W_flat, *edge):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError("x, sh, w (or h and [Wr; offset]) and W must share a dtype "
                            "and a device")
    if x.stride(1) != 1 or (x.stride(0) not in (0, plan.d_x)):
        x = x.contiguous()
    if folded:
        w = (w[0].contiguous(), w[1][:, plan.radial_cols(x.device)].contiguous())
    elif w is not None:
        w = w.contiguous()
    return x, sh.contiguous(), w, W_flat.contiguous()


def dtp_lin_fwd(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w, W_flat: torch.Tensor,
                n_edges=None) -> torch.Tensor:
    """K1: [E, plan.d_out].  x [E, d_x] (a row-broadcast ``expand`` is read
    with row stride 0), sh [E, d_sh], w [E, d_w] or None for a shared-weight
    plan (already folded into ``W_flat``), ``n_edges`` an int32 device scalar
    or None.  CPU tensors take ``dtp_lin_plain``; CUDA tensors launch the
    kernel (float32 or bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_lin_plain(plan, x, sh, w, W_flat, n_edges)
    E = sh.shape[0]
    x, sh, w, W_flat = _check_operands(plan, x, sh, w, W_flat)
    n_edges = _check_n_edges(n_edges, E, x.device)
    gk, terms, coeffs = plan.device_tables(x.device)
    out = torch.empty((E, plan.d_out), dtype=x.dtype, device=x.device)
    if E == 0:
        return out
    err = _build.library().dtp_lin_fwd(
        _build.ptr(x), x.stride(0), _build.ptr(sh), _build.ptr(w), _build.ptr(W_flat),
        _build.ptr(out), _build.ptr(n_edges), E, plan.d_sh, plan.d_w, plan.d_out,
        _build.ptr(gk), gk.shape[0], _build.ptr(terms), _build.ptr(coeffs),
        plan.max_fan_stride, _build.dtype_code(x), _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_fwd")
    dtp_lin_fwd.launches += 1
    return out


def dtp_lin_bwd(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w, W_flat: torch.Tensor,
                g: torch.Tensor, n_edges=None):
    """K2: (dx [E, d_x], dw [E, d_w] or None, dW_flat [w_numel] float32) for
    the cotangent ``g`` [E, d_out] of ``dtp_lin_fwd`` on the same operands.
    CPU tensors take ``dtp_lin_bwd_plain``; CUDA tensors launch the kernel
    (float32 or bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_lin_bwd_plain(plan, x, sh, w, W_flat, g, n_edges)
    E = sh.shape[0]
    x, sh, w, W_flat = _check_operands(plan, x, sh, w, W_flat)
    if g.shape != (E, plan.d_out) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"cotangent must be [{E}, {plan.d_out}] in x's dtype and device")
    g = g.contiguous()
    n_edges = _check_n_edges(n_edges, E, x.device)
    gk, terms, coeffs, dwmap, wt_index, span_max, cols_pad_max = plan.bwd_tables(x.device)
    dev = x.device
    dx = torch.empty((E, plan.d_x), dtype=x.dtype, device=dev)
    dw = None
    if w is not None:
        dw = (torch.zeros if plan.dw_has_dead_cols else torch.empty)(
            (E, plan.d_w), dtype=x.dtype, device=dev)
    dW = torch.zeros((plan.w_numel,), dtype=torch.float32, device=dev)
    if E == 0:
        return dx, dw, dW
    WT = torch.cat([W_flat, W_flat.new_zeros(1)])[wt_index]
    n_tiles = -(-E // BWD_TILE)
    n_parts = min(n_tiles, BWD_BLOCKS_PER_SM * _sm_count(dev))
    part = torch.empty((n_parts, plan.w_numel), dtype=torch.float32, device=dev)
    err = _build.library().dtp_lin_bwd(
        _build.ptr(x), x.stride(0), plan.d_x, _build.ptr(sh), plan.d_sh, _build.ptr(w),
        plan.d_w, _build.ptr(WT), _build.ptr(g), plan.d_out, _build.ptr(n_edges), E,
        _build.ptr(gk), gk.shape[0], _build.ptr(terms), _build.ptr(coeffs), _build.ptr(dwmap),
        _build.ptr(dx), _build.ptr(dw), _build.ptr(part), n_parts, _build.ptr(dW),
        plan.w_numel, span_max, cols_pad_max, plan.max_fan_stride, _build.dtype_code(x),
        _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_bwd")
    dtp_lin_bwd.launches += 1
    return dx, dw, dW


dtp_lin_fwd.launches = 0
dtp_lin_bwd.launches = 0
BWD_TILE = 16  # edges per tile of csrc/dtp_lin_bwd.cu
BWD_BLOCKS_PER_SM = 2  # persistent blocks (and dW partial rows) per SM


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


RAD_BWD_BLOCKS_PER_SM = 1  # K7-B's shared memory (135 KB at QM9) fits one block per SM
_WORKSPACE: Dict[torch.device, torch.Tensor] = {}


def _workspace(device: torch.device, numel: int) -> torch.Tensor:
    """One fp32 scratch buffer per device for K7-B's partial rows, grown to
    the largest call and reused: kernels on one stream run in order, and the
    reduction reads the rows before the next launch writes them."""
    buf = _WORKSPACE.get(device)
    if buf is None or buf.numel() < numel:
        buf = torch.empty((numel,), dtype=torch.float32, device=device)
        _WORKSPACE[device] = buf
    return buf[:numel]


def dtp_lin_rad_fwd(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, h: torch.Tensor,
                    Wrs: torch.Tensor, W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """K7-F: K1 with ``w = [h, 1] @ Wrs`` built in the kernel, [E, d_out].
    ``h`` [E, hd] is the radial MLP's last hidden activation and ``Wrs`` the
    plan's ``pack_radial(Wr, offset)`` [hd + 1, d_w].  CPU tensors take
    ``dtp_lin_rad_plain``; CUDA tensors launch the kernel (float32 or
    bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_lin_rad_plain(plan, x, sh, h, Wrs, W_flat, n_edges)
    E = sh.shape[0]
    x, sh, (h, Wl), W_flat = _check_operands(plan, x, sh, (h, Wrs), W_flat)
    n_edges = _check_n_edges(n_edges, E, x.device)
    gk, terms, coeffs, _, _, span_max, _ = plan.bwd_tables(x.device)
    out = torch.empty((E, plan.d_out), dtype=x.dtype, device=x.device)
    if E == 0:
        return out
    err = _build.library().dtp_lin_rad_fwd(
        _build.ptr(x), x.stride(0), _build.ptr(sh), _build.ptr(W_flat), _build.ptr(out),
        _build.ptr(n_edges), E, plan.d_sh, plan.d_out, _build.ptr(gk), gk.shape[0],
        _build.ptr(terms), _build.ptr(coeffs), plan.max_fan_stride, _build.ptr(h),
        plan.radial_fold, _build.ptr(Wl), Wl.shape[1], span_max, _build.dtype_code(x),
        _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_rad_fwd")
    dtp_lin_rad_fwd.launches += 1
    return out


def dtp_lin_rad_bwd(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, h: torch.Tensor,
                    Wrs: torch.Tensor, W_flat: torch.Tensor, g: torch.Tensor, n_edges=None):
    """K7-B: (dx [E, d_x], dh [E, hd], d[Wr; offset] [hd + 1, d_w] float32,
    dW_flat [w_numel] float32) for the cotangent ``g`` [E, d_out] of
    ``dtp_lin_rad_fwd`` on the same operands, in one launch (and the
    fixed-order sum of its partial rows); dw stays on chip.  CPU tensors
    take ``dtp_lin_rad_bwd_plain``; CUDA tensors launch the kernel (float32
    or bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_lin_rad_bwd_plain(plan, x, sh, h, Wrs, W_flat, g, n_edges)
    E = sh.shape[0]
    x, sh, (h, Wl), W_flat = _check_operands(plan, x, sh, (h, Wrs), W_flat)
    if g.shape != (E, plan.d_out) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"cotangent must be [{E}, {plan.d_out}] in x's dtype and device")
    g = g.contiguous()
    n_edges = _check_n_edges(n_edges, E, x.device)
    gk, terms, coeffs, _, wt_index, span_max, cols_pad_max = plan.bwd_tables(x.device)
    dev, hd, n_loc = x.device, plan.radial_fold, Wl.shape[1]
    dx = torch.empty((E, plan.d_x), dtype=x.dtype, device=dev)
    dh = torch.empty((E, hd), dtype=x.dtype, device=dev)
    row = plan.w_numel + (hd + 1) * n_loc  # a partial row: dW, then d[Wr; offset]
    red = torch.zeros((row,), dtype=torch.float32, device=dev)
    if E > 0:
        WT = torch.cat([W_flat, W_flat.new_zeros(1)])[wt_index]
        n_parts = min(-(-E // BWD_TILE), RAD_BWD_BLOCKS_PER_SM * _sm_count(dev))
        part = _workspace(dev, n_parts * row)
        err = _build.library().dtp_lin_rad_bwd(
            _build.ptr(x), x.stride(0), plan.d_x, _build.ptr(sh), plan.d_sh, _build.ptr(WT),
            _build.ptr(g), plan.d_out, _build.ptr(n_edges), E, _build.ptr(gk), gk.shape[0],
            _build.ptr(terms), _build.ptr(coeffs), _build.ptr(dx), _build.ptr(part), n_parts,
            _build.ptr(red), plan.w_numel, span_max, cols_pad_max, plan.max_fan_stride,
            _build.ptr(h), hd, _build.ptr(Wl), n_loc, _build.ptr(dh), _build.dtype_code(x),
            _build.stream_ptr(),
        )
        _build.check(err, "dtp_lin_rad_bwd")
        dtp_lin_rad_bwd.launches += 1
    dWrs = torch.zeros((hd + 1, plan.d_w), dtype=torch.float32, device=dev)
    dWrs[:, plan.radial_cols(dev)] = red[plan.w_numel:].view(hd + 1, n_loc)
    return dx, dh, dWrs, red[: plan.w_numel]


dtp_lin_rad_fwd.launches = 0
dtp_lin_rad_bwd.launches = 0


class _DTPLinRad(torch.autograd.Function):
    """K7-F forward, K7-B backward; gradients for x, h, [Wr; offset] and
    W_flat (not sh)."""

    @staticmethod
    def forward(ctx, plan, x, sh, h, Wrs, W_flat, n_edges):
        ctx.plan = plan
        ctx.save_for_backward(x, sh, h, Wrs, W_flat, n_edges)
        return dtp_lin_rad_fwd(plan, x, sh, h, Wrs, W_flat, n_edges)

    @staticmethod
    def backward(ctx, g):
        x, sh, h, Wrs, W_flat, n_edges = ctx.saved_tensors
        dx, dh, dWrs, dW = dtp_lin_rad_bwd(ctx.plan, x, sh, h, Wrs, W_flat, g, n_edges)
        return None, dx, None, dh, dWrs.to(Wrs.dtype), dW.to(W_flat.dtype), None


class _DTPLin(torch.autograd.Function):
    """K1 forward, K2 backward; gradients for x, w and W_flat (not sh)."""

    @staticmethod
    def forward(ctx, plan, x, sh, w, W_flat, n_edges):
        ctx.plan = plan
        ctx.save_for_backward(x, sh, w, W_flat, n_edges)
        return dtp_lin_fwd(plan, x, sh, w, W_flat, n_edges)

    @staticmethod
    def backward(ctx, g):
        x, sh, w, W_flat, n_edges = ctx.saved_tensors
        dx, dw, dW = dtp_lin_bwd(ctx.plan, x, sh, w, W_flat, g, n_edges)
        return None, dx, None, dw, dW.to(W_flat.dtype), None


def dtp_lin(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
            W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """Fused DTP + linear heads, differentiable in x, w and W_flat:
    [E, plan.d_out] (split with ``plan.split_output``).

    ``w`` is [E, d_w] per edge, or the shared [d_w] of a shared-weight plan,
    which is folded into the rows of ``W_flat`` here, outside the autograd
    op, so autograd carries the folded dW back to W and w.  The forward is
    K1 (``dtp_lin_fwd``), the backward K2 (``dtp_lin_bwd``); both take their
    plain versions on CPU tensors.  On a plan with ``radial_fold``, ``w``
    may be the pair ``(h, plan.pack_radial(Wr, offset))``: then K7-F and
    K7-B, differentiable in x, h, [Wr; offset] and W_flat.  Raises if ``sh``
    needs a gradient (the backward computes no dsh)."""
    if sh.requires_grad:
        raise ValueError("dtp_lin computes no gradient for sh (force models take "
                         "kernels/dtp_lin_ho.py: higher_order_grads=True)")
    if isinstance(w, tuple):
        return _DTPLinRad.apply(plan, x, sh, *w, W_flat, n_edges)
    w, W_flat = fold_shared_weights(plan, w, W_flat)
    return _DTPLin.apply(plan, x, sh, w, W_flat, n_edges)


def fold_shared_weights(plan: DTPLinPlan, w, W_flat):
    """(w, W_flat) as the autograd ops take them: a shared-weight plan's
    ``w`` folded into the rows of ``W_flat`` (outside the op, so autograd
    carries the folded dW back to both) and replaced by None."""
    if not plan.shared_weights:
        return w, W_flat
    if w.numel() != plan.d_w:
        raise ValueError(f"shared w must have {plan.d_w} entries")
    return None, plan.fold_shared(w, W_flat)
