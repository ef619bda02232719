"""Fused depthwise tensor product + per-irrep linear heads (K1, forward).

Counterpart of ``equiformer_tpu/kernels/dtp_lin_pallas.py``
(``make_fused_dtp_lin`` -> ``_fwd_kernel``): per edge, the depthwise ('uvu')
TP with the SH

    z[g, k][fan col fc + u] += c * sh[col] * x[a_off + u] * w[b_off + u]

followed, per irrep group ``g`` and component ``k``, by ``z[g, k] @ W_g`` for
all linear heads reading z at once.  z (3136 wide for the flagship) never
goes to device memory.  Two launch modes share one kernel: per-edge ``w``
(``sep_act``, the edge-degree embedding) and shared weights folded into the
rows of ``W`` outside the kernel (``sep_value``).  Rows at or past
``n_edges`` (a device scalar) are written as zeros.

``DTPLinPlan`` is the port's own plan: the term table from the port's CG
tables, the irrep groups, weight packing and output splitting.  It keeps no
TPU layout tricks (no 128-lane slots, fan padding or lane packing): a
group's fan is padded only to a multiple of 4 for vector loads.
``dtp_lin_plain`` (einsum TP + the heads' linear maps) is the plain version.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.irreps import Irreps
from ..core.tensor_product import TensorProduct
from . import _build


class Term(NamedTuple):
    a_off: int  # x column of the term's first copy
    col: int  # sh column
    b_off: int  # w column of the term's first copy
    out_off: int  # column of the unsimplified TP output z
    mul: int
    coeff: float


class Group(NamedTuple):
    ir: object  # Irrep
    blocks: Tuple[int, ...]  # tp.irreps_out block indices of this irrep
    fan_slot: Dict[int, int]  # block index -> first fan column
    fan: int  # sum of the blocks' multiplicities
    fan_stride: int  # fan rounded up to 4 (rows of the packed W)
    cols: int  # output columns of all heads together
    out_off: int  # offset of the group in the fused flat output
    w_off: int  # offset of the group's [fan_stride, cols] W in the flat buffer


def plan_terms(tp: TensorProduct, fold_rescale: bool, eps: float = 1e-10) -> List[Term]:
    """Nonzero CG terms of a depthwise plan with mul-1 second input; with
    ``fold_rescale`` the fan-in rescale of external weights is in ``coeff``."""
    in_off = [s.start for s in tp.irreps_in1.slices()]
    sh_off = [s.start for s in tp.irreps_in2.slices()]
    out_off = [s.start for s in tp.irreps_out.slices()]
    terms = []
    for idx, ins in enumerate(tp.instructions):
        if ins.mode != "uvu" or tp.irreps_in2[ins.i_in2].mul != 1:
            raise ValueError("the DTP kernel supports depthwise uvu with mul-1 SH")
        mul = tp.irreps_in1[ins.i_in1].mul
        C = tp._cg[idx] * (tp.slice_sqrt_k[ins.i_out] if fold_rescale else 1.0)
        d1, d2, d3 = C.shape
        for i in range(d1):
            for j in range(d2):
                for k in range(d3):
                    c = float(C[i, j, k])
                    if abs(c) < eps:
                        continue
                    terms.append(Term(in_off[ins.i_in1] + i * mul,
                                      sh_off[ins.i_in2] + j, tp._offsets[idx],
                                      out_off[ins.i_out] + k * mul, mul, c))
    return terms


class DTPLinPlan:
    """Static metadata for the fused DTP + linear heads.

    ``tp`` is a depthwise plan with mul-1 SH; head ``h`` is
    ``IrrepsLinear(tp.irreps_out, head_irreps[h])`` reading the whole
    unsimplified TP output.  ``shared_weights`` means ``w`` is one internal
    vector, folded into the rows of ``W`` per call; otherwise ``w`` holds raw
    external per-edge weights, and their fan-in rescale is folded into the
    CG coefficients (``fold_rescale``).
    """

    def __init__(self, tp: TensorProduct, head_irreps: Sequence[Irreps],
                 shared_weights: bool = False):
        self.tp = tp
        self.head_irreps = [Irreps(h) for h in head_irreps]
        self.shared_weights = shared_weights
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
                            tt.append((t.a_off, t.col, t.b_off, fc, t.mul))
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


def _zero_past(out: torch.Tensor, n_edges) -> torch.Tensor:
    if n_edges is None:
        return out
    rows = torch.arange(out.shape[0], device=out.device) < n_edges
    return torch.where(rows[:, None], out, torch.zeros_like(out))


def dtp_lin_plain(plan: DTPLinPlan, x, sh, w, W_flat, n_edges=None):
    """Plain version: the einsum TP, then each group's z columns times its
    packed linear weights.  ``w`` is [E, d_w] per edge or the shared [d_w]."""
    z = plan.tp.apply(x, sh, w, scale_weights=plan.fold_rescale)
    slices = plan.tp.irreps_out.slices()
    pieces = []
    for gi, g in enumerate(plan.groups):
        W = plan.group_weight(W_flat, gi)[: g.fan]
        for k in range(g.ir.dim):
            cols = []
            for bo in g.blocks:
                mul = plan.tp.irreps_out[bo].mul
                s = slices[bo].start + k * mul
                cols.append(z[:, s : s + mul])
            zk = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
            pieces.append(zk @ W)
    return _zero_past(torch.cat(pieces, dim=1), n_edges)


def dtp_lin(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
            W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """Fused DTP + linear heads: [E, plan.d_out] (split with ``plan.split_output``).

    x [E, d_x] (a row-broadcast ``expand`` is read with row stride 0),
    sh [E, d_sh], w [E, d_w] or the shared [d_w], ``W_flat`` from
    ``plan.pack_weights``, ``n_edges`` an int32 device scalar or None.
    CPU tensors take ``dtp_lin_plain``; CUDA tensors launch the kernel
    (float32 or bfloat16) or raise.
    """
    if x.device.type == "cpu":
        return dtp_lin_plain(plan, x, sh, w, W_flat, n_edges)
    E = sh.shape[0]
    if x.dim() != 2 or x.shape != (E, plan.d_x) or sh.shape != (E, plan.d_sh):
        raise ValueError(f"bad shapes x {tuple(x.shape)} sh {tuple(sh.shape)}")
    code = _build.dtype_code(x)
    if plan.shared_weights:
        if w.numel() != plan.d_w:
            raise ValueError(f"shared w must have {plan.d_w} entries")
        W_flat = plan.fold_shared(w, W_flat)
        w = None
    elif w.shape != (E, plan.d_w):
        raise ValueError(f"per-edge w must be [{E}, {plan.d_w}], got {tuple(w.shape)}")
    if W_flat.shape != (plan.w_numel,):
        raise ValueError("W_flat does not match the plan")
    for t in (sh, w, W_flat):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise TypeError("x, sh, w and W must share a dtype and a device")
    if x.stride(1) != 1 or (x.stride(0) not in (0, plan.d_x)):
        x = x.contiguous()
    sh = sh.contiguous()
    w = None if w is None else w.contiguous()
    W_flat = W_flat.contiguous()
    if n_edges is None:
        n_edges = torch.full((), E, dtype=torch.int32, device=x.device)
    elif n_edges.dtype != torch.int32 or n_edges.numel() != 1 or n_edges.device != x.device:
        raise TypeError("n_edges must be an int32 scalar tensor on x's device")
    gk, terms, coeffs = plan.device_tables(x.device)
    out = torch.empty((E, plan.d_out), dtype=x.dtype, device=x.device)
    if E == 0:
        return out
    err = _build.library().dtp_lin_fwd(
        _build.ptr(x), x.stride(0), _build.ptr(sh), _build.ptr(w), _build.ptr(W_flat),
        _build.ptr(out), _build.ptr(n_edges), E, plan.d_sh, plan.d_w, plan.d_out,
        _build.ptr(gk), gk.shape[0], _build.ptr(terms), _build.ptr(coeffs),
        plan.max_fan_stride, code, _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_fwd")
    dtp_lin.launches += 1
    return out


dtp_lin.launches = 0
