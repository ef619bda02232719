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
group's fan is padded only to a multiple of 4 for vector loads.  K1 and K2
run their head products on the tensor cores from each group's W_g packed in
``mma.sync`` fragment order by one gather a call (``k1_tables``,
``k2_tables``).
``dtp_lin_plain`` (einsum TP + the heads' linear maps) and
``dtp_lin_bwd_plain`` (the same backward written out per group and term)
are the plain versions.

The radial fold (K7, JAX's ``EQUIFORMER_TPU_FOLD_RADIAL``): a plan with
``radial_fold=hd`` takes, in place of ``w``, the radial MLP's last hidden
activation ``h`` [E, hd] and ``Wrs = [Wr; offset]`` [hd + 1, d_w]
(``pack_radial``), and the kernels build ``w = h @ Wr + offset`` on chip:
K7-F ``dtp_lin_rad_fwd`` (K1's block with the group's w built from h on the
tensor cores) and K7-B ``dtp_lin_rad_bwd`` (dx, dh, d[Wr; offset], dW: K2's
two launches with the fold a compile-time variant, w built on chip in both),
with the plain versions ``dtp_lin_rad_plain`` and
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


K2_FAN_TILE, K2_COL_TILE = 64, 128  # a dW tile of launch 2 (csrc/dtp_lin_bwd.cu k2::)
K2_EDGES = 64  # edges per step of launch 2 (k2::kEdges2): edge ranges are multiples
K2_DW_BLOCKS_PER_SM = 8  # launch 2's blocks (dW tiles x edge ranges) per SM
K1_TILES = (32, 16)  # K1's edge tiles (csrc/dtp_lin.cu k1::): fp32's where it pays, the rest
# the shared memory a K1 block may take so that two share an SM: (228 KB - 1 KB
# reserved per block) / 2
K1_TWO_BLOCKS_SMEM = (233472 - 2 * 1024) // 2
K1_VEC = 4  # u elements a thread of K1's z walk takes at once, where the tables allow
# the waves of two blocks an SM that K1's 32-edge tile must fill: MD17's 2944
# edges make 368 blocks of 32 edges (1.4 waves), slower than 736 of 16
K1_MIN_WAVES = 4


class K2Tables(NamedTuple):
    gk: torch.Tensor  # int32 [n_gk, 12]
    tiles: torch.Tensor  # int32 [n_tiles, 6]
    wp_index: torch.Tensor  # int64: the packed W as a gather of cat([W_flat, 0])
    cp_max: int  # the widest group's columns padded to 16
    fd_max: int  # the widest group's fan_stride padded to 8


class K7Tables(NamedTuple):
    index: torch.Tensor  # int64: each group's Wr packed twice, a gather of cat([Wl_flat, 0])
    rgk: torch.Tensor  # int32 [n_gk, 2]: the offsets of a gk row's group's packings in it


class K1Tables(NamedTuple):
    gk: torch.Tensor  # int32 [n_gk, 8]
    groups: torch.Tensor  # int32 [n_groups, 2]: first gk row, components
    runs: torch.Tensor  # int32 [n_runs, 5]
    # int64: the packed W as a gather of cat([W_flat, 0]); with the fold of
    # cat([W_flat, Wrs.reshape(-1), 0]), then each group's packed Wr and offsets
    wp_index: torch.Tensor
    fz_max: int  # the widest group's fan padded to 16
    vec: int  # K1_VEC where every run and term offset is a multiple of it, else 1
    # the fold (K7-F): per group the offsets of its packed Wr and of its
    # offsets in the gather after pk_base, and its span; the widest span
    rg: Optional[torch.Tensor] = None
    pk_base: int = 0
    span_max: int = 0


class K7LegTables(NamedTuple):
    # int64: K2's packed W, then k7_tables' packings, then Wl [hd + 1, n_loc]
    # flat, as a gather of cat([W_flat, Wrs.reshape(-1), 0])
    index: torch.Tensor
    pk_off: int  # where k7_tables' packings start
    wl_off: int  # where Wl starts


def b_fragment_index(K: int, N: int, k_valid: int, n_valid: int, flat, zero: int) -> np.ndarray:
    """Where each value of a K x N matrix B packed in mma B-fragment order
    comes from: [N8 / 8, K16 / 16, 32, 4] flattened (N8, K16: N and K
    rounded up to 8 and 16).  For n-tile nt, K step ks and lane (g, q) =
    (lane // 4, lane % 4) the four values are B[k][n] for n = 8 nt + g and k
    = 16 ks + 2q + (0, 1, 8, 9): one K step's B fragment of ``mma.sync``
    m16n8k16 (and of 3xTF32's two m16n8k8 halves, ``eqt::mma::mma16n``),
    read with one 16-byte (fp32) or 8-byte (bf16) load a lane.  ``flat(k,
    n)`` gives the source index of B[k][n]; k >= k_valid or n >= n_valid
    take ``zero``."""
    n_nt, n_ks = -(-N // 8), -(-K // 16)
    nt, ks, lane, v = np.meshgrid(np.arange(n_nt), np.arange(n_ks), np.arange(32), np.arange(4),
                                  indexing="ij")
    n = 8 * nt + lane // 4
    k = 16 * ks + 2 * (lane % 4) + (v & 1) + 8 * (v >> 1)
    return np.where((k < k_valid) & (n < n_valid), flat(k, n), zero).reshape(-1)


def k2_pack_index(fan: int, fan_stride: int, cols: int, w_off: int, zero: int) -> np.ndarray:
    """One group's W_g^T [cols, fan] (K2's dz = G W_g^T: K = cols, N = the
    fan rounded to 8) in B-fragment order (``b_fragment_index``) as indices
    into ``W_flat``: the four values of a lane are W_g[f, j] for f = 8 nt +
    g and j = 16 ks + 2q + (0, 1, 8, 9).  Rows at or past ``fan`` and
    columns past ``cols`` are zero."""
    return b_fragment_index(cols, fan_stride, cols, fan, lambda j, f: w_off + f * cols + j, zero)


def k1_pack_index(fan: int, cols: int, w_off: int, zero: int) -> np.ndarray:
    """One group's W_g [fan, cols] (K1's out = z W_g: K = the fan rounded to
    16, N = cols) in B-fragment order (``b_fragment_index``) as indices into
    ``W_flat``: the four values of a lane are W_g[f, j] for j = 8 nt + g and
    f = 16 ks + 2q + (0, 1, 8, 9).  Rows at or past ``fan`` and columns past
    ``cols`` are zero."""
    return b_fragment_index(fan, cols, fan, cols, lambda f, j: w_off + f * cols + j, zero)


def _stride_mod(n: int, m: int, r: int) -> int:
    """The least stride >= n that is r modulo m (``eqt::mma::stride_mod``)."""
    return n + ((r - n % m) + m) % m


def k1_smem_bytes(plan: "DTPLinPlan", tile: int, itemsize: int, x_rows: bool,
                  fold: bool = False, x_global: bool = False) -> int:
    """Shared memory of one K1 block (``k1::layout``): x [tile or 1, d_x
    rounded to 8] in the dtype (none with ``x_global``: read through L2), sh
    [tile, d_sh] fp32, z [tile, ld] in the dtype; with ``fold`` (K7-F) also
    h [tile, ld of hd] and w [tile, ld of the widest span] in the dtype;
    each 16-byte aligned."""
    def a16(b):
        return -(-b // 16) * 16

    def ld(n):  # k1::ld_z
        return _stride_mod(n, 32, 8) if itemsize == 4 else _stride_mod(n, 64, 8)

    fz = max(-(-g.fan // 16) * 16 for g in plan.groups)
    total = (0 if x_global else a16((tile if x_rows else 1) * -(-plan.d_x // 8) * 8 * itemsize))
    total += a16(tile * plan.d_sh * 4) + a16(tile * ld(fz) * itemsize)
    if fold:
        span = max(g.fan for g in plan.groups)  # a group's span is its fan (k7_tables)
        total += (a16(tile * ld(-(-plan.radial_fold // 16) * 16) * itemsize)
                  + a16(tile * ld(-(-span // 8) * 8) * itemsize))
    return total


def k1_tile(plan: "DTPLinPlan", itemsize: int, x_rows: bool, E: int, sm_count: int,
            fold: bool = False) -> int:
    """K1's edge tile: 32 in fp32 where a block leaves room for a second on
    its SM and the grid (tiles x groups) fills the card's two blocks an SM
    ``K1_MIN_WAVES`` times (QM9), so that two m-tiles share each B
    fragment's 3xTF32 split; else 16 (MD17 L3's 864-wide x tile and its
    2944 edges in fp32; bf16, whose product is cheap and whose twice as
    many 16-edge blocks run faster).  ``fold``: K7-F's block, whose h and w
    tiles count too (the 16-edge tile at QM9 in fp32)."""
    tile = K1_TILES[0]
    if (itemsize == 4
            and k1_smem_bytes(plan, tile, itemsize, x_rows, fold) <= K1_TWO_BLOCKS_SMEM
            and -(-E // tile) * len(plan.groups) >= K1_MIN_WAVES * 2 * sm_count):
        return tile
    return K1_TILES[-1]


def k1_x_global(plan: "DTPLinPlan", itemsize: int, x_rows: bool, tile: int) -> bool:
    """Whether K7-F reads x through L2 instead of staging it: with the
    16-edge tile where the staged x alone keeps a second block off the SM
    (MD17 L3 in fp32: 145 KB a block, 91 KB without x; on an H100 0.33 ms a
    call at its sep_act against 0.48 with x staged)."""
    return (tile == K1_TILES[-1] and x_rows
            and k1_smem_bytes(plan, tile, itemsize, x_rows, True) > K1_TWO_BLOCKS_SMEM
            and k1_smem_bytes(plan, tile, itemsize, x_rows, True, True) <= K1_TWO_BLOCKS_SMEM)


def k2_ranges(E: int, n_tiles: int, sm_count: int,
              blocks_per_sm: int = K2_DW_BLOCKS_PER_SM) -> Tuple[int, int]:
    """(n_ranges, range_len) of K2's launch 2: about ``blocks_per_sm``
    blocks per SM over the dW tiles, ranges of whole ``K2_EDGES`` steps,
    none empty; each range adds one fp32 partial row of dW."""
    n_steps = -(-E // K2_EDGES)
    want = -(-blocks_per_sm * sm_count // max(n_tiles, 1))
    range_len = -(-n_steps // max(1, min(n_steps, want))) * K2_EDGES
    return -(-E // range_len), range_len


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
        """(terms int32 [n_terms, 5], coeffs float32) on ``device``, as K1
        reads them (``k1_tables``' runs index them): per term a_off, sh
        column, b_off, fan column, mul, sorted by (group, component, fan
        column)."""
        tabs = self._tables.get(device)
        if tabs is None:
            tabs = (
                torch.tensor([(t.a_off, t.col_off, t.b_off, fc, t.mul)
                              for t, (_, _, fc) in self.terms], dtype=torch.int32, device=device),
                torch.tensor([t.coeff for t, _ in self.terms], dtype=torch.float32,
                             device=device),
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

    def k2_tables(self, device: torch.device) -> "K2Tables":
        """K2's tables on ``device``, as ``csrc/dtp_lin_bwd.cu`` (namespace
        k2) reads them; the terms, coefficients and ``dwmap`` are
        ``bwd_tables``'.

        gk per (group, component), 12 ints: fan_stride, cols, output column,
        W offset, term range, the group's offset in the packed W and its
        columns padded to 16 (the mma K step), its dw span (begin in
        ``dwmap``, length), first / last component.  tiles: launch 2's dW
        tiles, 6 ints each: the gk row of the group's component 0, the
        group's components, fan rows [f0, f0 + fm), columns [j0, j0 + fn)
        (``K2_FAN_TILE`` x ``K2_COL_TILE`` at most); together they cover
        every element of ``W_flat`` once.  ``wp_index`` gathers ``cat([W_flat,
        0])`` into each group's W_g in mma fragment order
        (``k2_pack_index``)."""
        key = ("k2", device)
        tabs = self._tables.get(key)
        if tabs is not None:
            return tabs
        bgk = self.bwd_tables(torch.device("cpu"))[0].tolist()
        gk, tiles, index = [], [], []
        wp_off, row = 0, 0
        for g in self.groups:
            cp = -(-g.cols // 16) * 16
            for k in range(g.ir.dim):
                r = bgk[row + k]
                gk.append(r[:6] + [wp_off, cp] + r[8:])
            for f0 in range(0, g.fan_stride, K2_FAN_TILE):
                for j0 in range(0, g.cols, K2_COL_TILE):
                    tiles.append((row, g.ir.dim, f0, min(K2_FAN_TILE, g.fan_stride - f0), j0,
                                  min(K2_COL_TILE, g.cols - j0)))
            idx = k2_pack_index(g.fan, g.fan_stride, g.cols, g.w_off, self.w_numel)
            index.append(idx)
            wp_off += idx.size
            row += g.ir.dim
        tabs = K2Tables(
            torch.tensor(gk, dtype=torch.int32, device=device),
            torch.tensor(tiles, dtype=torch.int32, device=device),
            torch.as_tensor(np.concatenate(index), device=device),
            max(-(-g.cols // 16) * 16 for g in self.groups),
            max(-(-g.fan_stride // 8) * 8 for g in self.groups),
        )
        self._tables[key] = tabs
        return tabs

    def k7_tables(self, device: torch.device) -> "K7Tables":
        """The radial fold's tables for K7-B on K2's launches
        (``csrc/dtp_lin_bwd.cu``, k2::RadOps) on ``device``.  A group's fan
        column f is its local w column sb + f (checked here: each fan block
        is one TP path, and both orders follow the paths), so per group one
        B operand in fragment order (``b_fragment_index``) of its columns of
        Wl = [Wr; offset] in local order ([hd + 1, n_loc], row hd the
        offset, not packed) serves the w build of both launches, ``w = h
        Wr_g`` (K = hd, N = span), and a second one ``dh = dw Wr_g^T`` (K =
        span, N = hd).  ``index`` gathers ``cat([Wl.reshape(-1), 0])`` into
        both packings of every group; ``rgk`` gives per gk row of
        ``k2_tables`` the offsets of its group's two packings."""
        hd = self.radial_fold
        if hd is None:
            raise ValueError("k7_tables needs a plan with radial_fold")
        key = ("k7", device)
        tabs = self._tables.get(key)
        if tabs is not None:
            return tabs
        gk = self._check_fold_order()
        n_loc = int(self.radial_cols(torch.device("cpu")).numel())
        zero = (hd + 1) * n_loc
        index, rgk, off = [], [], 0
        for row in gk:
            sb, span, first = row[8], row[9], row[10]
            if first:
                wb = b_fragment_index(hd, span, hd, span, lambda k, n: k * n_loc + sb + n, zero)
                wd = b_fragment_index(span, hd, span, hd, lambda k, n: n * n_loc + sb + k, zero)
                index += [wb, wd]
                group = (off, off + wb.size)
                off += wb.size + wd.size
            rgk.append(group)
        tabs = K7Tables(torch.as_tensor(np.concatenate(index), device=device),
                        torch.tensor(rgk, dtype=torch.int32, device=device))
        self._tables[key] = tabs
        return tabs

    def k2_dsh_slots(self) -> int:
        """The width of the dsh slot rows of K5a and K5b's sh leg on K2's
        launch 1: a slot a term and row, so the most terms of a (group,
        component)."""
        slots = self._tables.get("k2_dsh_slots")
        if slots is None:
            gk = self.bwd_tables(torch.device("cpu"))[0]
            slots = int((gk[:, 5] - gk[:, 4]).max())
            self._tables["k2_dsh_slots"] = slots
        return slots

    def k1_tables(self, device: torch.device, fold: bool = False) -> "K1Tables":
        """K1's tables on ``device``, as ``csrc/dtp_lin.cu`` (namespace k1)
        reads them; the terms and coefficients are ``device_tables'``.

        gk per (group, component), 8 ints: the fan padded to 16, cols, output
        column, the group's offset in the packed W, its run range, its column
        n-tiles (cols rounded up to 8, over 8), the fan.  groups: per group
        its first gk row and its components (a block's group).  runs: per
        fan block of a (group, component) (the terms of one TP path, sorted
        by fan column in ``device_tables``), 5 ints: the fan column, mul, the
        w column, the term range; a run's elements are written once, so z
        needs no zeroing.  ``wp_index`` gathers ``cat([W_flat, 0])`` into
        each group's W_g in B-fragment order (``k1_pack_index``).

        ``fold`` (K7-F, a plan with ``radial_fold``): a run's w column is
        its column in the group's w tile, which is its fan column (the
        fold's order, ``_check_fold_order``); ``wp_index`` gathers
        ``cat([W_flat, Wrs.reshape(-1), 0])`` into the packed W, then from
        ``pk_base`` on per group its columns of Wr in B-fragment order (K =
        hd, N = the span) and its offsets in local column order; ``rg`` per
        group the offsets of those two after ``pk_base``, and its span."""
        key = ("k1f" if fold else "k1", device)
        tabs = self._tables.get(key)
        if tabs is not None:
            return tabs
        if fold:
            tabs = self._k1_fold_tables(device)
            self._tables[key] = tabs
            return tabs
        terms = self.device_tables(torch.device("cpu"))[0].tolist()
        gk_of = [loc[:2] for _, loc in self.terms]  # each term's (group, component)
        gk, groups, runs, index = [], [], [], []
        wp_off = row = t = 0
        vec = K1_VEC if self.d_x % K1_VEC == 0 and self.d_w % K1_VEC == 0 else 1
        for gi, g in enumerate(self.groups):
            f16 = -(-g.fan // 16) * 16
            groups.append((row, g.ir.dim))
            for k in range(g.ir.dim):
                run_begin = len(runs)
                while t < len(terms) and gk_of[t] == (gi, k):
                    a_off, _, b_off, fc, mul = terms[t]
                    if len(runs) > run_begin and runs[-1][0] == fc:
                        if runs[-1][1:3] != [mul, b_off]:
                            raise ValueError("terms of one fan column differ in mul or w block")
                        runs[-1][4] = t + 1
                    else:
                        runs.append([fc, mul, b_off, t, t + 1])
                    if (a_off | b_off | fc | mul) % K1_VEC:
                        vec = 1
                    t += 1
                gk.append((f16, g.cols, g.out_off + k * g.cols, wp_off, run_begin, len(runs),
                           -(-g.cols // 8), g.fan))
            idx = k1_pack_index(g.fan, g.cols, g.w_off, self.w_numel)
            index.append(idx)
            wp_off += idx.size
            row += g.ir.dim
        tabs = K1Tables(
            torch.tensor(gk, dtype=torch.int32, device=device),
            torch.tensor(groups, dtype=torch.int32, device=device),
            torch.tensor(runs, dtype=torch.int32, device=device),
            torch.as_tensor(np.concatenate(index), device=device),
            max(-(-g.fan // 16) * 16 for g in self.groups),
            vec,
        )
        self._tables[key] = tabs
        return tabs

    def _check_fold_order(self):
        """The fold's kernels take a group's fan column f as its local w
        column sb + f: each fan block is one TP path, and both orders
        follow the paths.  Returns ``bwd_tables``' gk rows on the CPU."""
        gk, terms, *_ = self.bwd_tables(torch.device("cpu"))
        if not bool((terms[:, 3] == terms[:, 5]).all()):
            raise ValueError("the fold's kernels need each group's fan columns in its local "
                             "w column order")
        return gk.tolist()

    def _over_wrs(self, index: np.ndarray, wl: bool) -> np.ndarray:
        """A gather of ``cat([W_flat, 0])`` (``wl`` False) or of
        ``cat([Wl.reshape(-1), 0])`` (Wl = [Wr; offset] in local column
        order, ``wl`` True) as the same gather of ``cat([W_flat,
        Wrs.reshape(-1), 0])``, so that one gather packs W and [Wr; offset]
        together."""
        hd, d_w = self.radial_fold, self.d_w
        zero = self.w_numel + (hd + 1) * d_w
        if not wl:
            return np.where(index == self.w_numel, zero, index)
        cols = self.radial_cols(torch.device("cpu")).numpy()
        n_loc = cols.size
        k, c = np.divmod(np.minimum(index, (hd + 1) * n_loc - 1), n_loc)
        return np.where(index == (hd + 1) * n_loc, zero, self.w_numel + k * d_w + cols[c])

    def _k1_fold_tables(self, device: torch.device) -> "K1Tables":
        """``k1_tables(device, fold=True)``."""
        if self.radial_fold is None:
            raise ValueError("the fold's tables need a plan with radial_fold")
        hd, bgk = self.radial_fold, self._check_fold_order()
        n_loc = int(self.radial_cols(torch.device("cpu")).numel())
        base = self.k1_tables(torch.device("cpu"))
        runs = base.runs.clone()
        runs[:, 2] = runs[:, 0]  # the w column in the group's tile: the fan column
        index = [self._over_wrs(base.wp_index.numpy(), False)]
        pk_base = off = index[0].size
        rg = []
        for row in bgk:
            sb, span = row[8], row[9]
            if not row[10]:
                continue
            if span != self.groups[len(rg)].fan:
                raise ValueError("a group's w span differs from its fan")
            wb = b_fragment_index(hd, span, hd, span, lambda k, n: k * n_loc + sb + n,
                                  (hd + 1) * n_loc)
            offs = np.full(-(-span // 4) * 4, (hd + 1) * n_loc)  # 16-byte aligned segments
            offs[:span] = hd * n_loc + sb + np.arange(span)
            index += [self._over_wrs(wb, True), self._over_wrs(offs, True)]
            rg.append((off - pk_base, off - pk_base + wb.size, span))
            off += wb.size + offs.size
        return base._replace(
            runs=runs.to(device), gk=base.gk.to(device), groups=base.groups.to(device),
            wp_index=torch.as_tensor(np.concatenate(index), device=device),
            rg=torch.tensor(rg, dtype=torch.int32, device=device), pk_base=pk_base,
            span_max=max(r[2] for r in rg))

    def k7_leg_tables(self, device: torch.device) -> "K7LegTables":
        """K7-L's gather (``kernels/dtp_lin_ho.py``, ``dtp_lin_rad_leg``):
        ``index`` gathers ``cat([W_flat, Wrs.reshape(-1), 0])`` into K2's
        packed W (``k2_tables``), then from ``pk_off`` on ``k7_tables``'
        packings of each group's Wr (whose ``rgk`` offsets count from
        there), then from ``wl_off`` on Wl = [Wr; offset] in local column
        order [hd + 1, n_loc], whose row hd the w build reads the offset
        from: one gather where three (W, Wl, the packings) were."""
        key = ("k7l", device)
        tabs = self._tables.get(key)
        if tabs is not None:
            return tabs
        cpu = torch.device("cpu")
        n_wl = (self.radial_fold + 1) * int(self.radial_cols(cpu).numel())
        wp = self._over_wrs(self.k2_tables(cpu).wp_index.numpy(), False)
        pk = self._over_wrs(self.k7_tables(cpu).index.numpy(), True)
        tabs = K7LegTables(
            torch.as_tensor(np.concatenate([wp, pk, self._over_wrs(np.arange(n_wl), True)]),
                            device=device),
            wp.size, wp.size + pk.size)
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


def radial_dWrs_plain(h: torch.Tensor, dw: torch.Tensor, n_edges=None,
                      ones: bool = True) -> torch.Tensor:
    """``d[Wr; offset] = [h, 1]^T @ dw`` over the rows below ``n_edges``, in
    float32 (float64 for float64 inputs): the ones column gives doffset, so
    padded rows must add nothing.  ``ones=False``: h's appended column is 0
    (h holds a tangent or a cotangent), and so is the offset row."""
    acc = torch.promote_types(h.dtype, torch.float32)
    hx = torch.cat([h.to(acc), torch.full_like(h[:, :1], float(ones), dtype=acc)], dim=1)
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


def _check_operands(plan: DTPLinPlan, x, sh, w, W_flat, local: bool = True):
    """Shapes, dtypes and devices the kernels take; returns x with a row
    stride of 0 or d_x and contiguous sh / w / W_flat.  ``w`` is the
    per-edge w, None (shared weights), or the radial fold's ``(h, Wrs)``,
    returned as ``(h, Wl)``: Wl is [Wr; offset] with its columns in the
    backward tables' local order (``plan.radial_cols``), as the folded
    kernels read it, or with ``local`` False Wrs itself (contiguous), for
    the kernels whose wrapper gathers it with W in one index."""
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
        w = (w[0].contiguous(), w[1][:, plan.radial_cols(x.device)].contiguous() if local
             else w[1].contiguous())
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
    terms, coeffs = plan.device_tables(x.device)
    kt = plan.k1_tables(x.device)
    out = torch.empty((E, plan.d_out), dtype=x.dtype, device=x.device)
    if E == 0:
        return out
    Wp = torch.cat([W_flat, W_flat.new_zeros(1)])[kt.wp_index]
    vec = kt.vec if w is None or w.data_ptr() % 16 == 0 else 1
    err = _build.library().dtp_lin_fwd(
        _build.ptr(x), x.stride(0), plan.d_x, _build.ptr(sh), plan.d_sh, _build.ptr(w),
        plan.d_w, _build.ptr(Wp), _build.ptr(out), plan.d_out, _build.ptr(n_edges), E,
        _build.ptr(kt.gk), _build.ptr(kt.groups), kt.groups.shape[0], _build.ptr(kt.runs),
        _build.ptr(terms), _build.ptr(coeffs), kt.fz_max,
        k1_tile(plan, x.element_size(), x.stride(0) != 0, E, _sm_count(x.device)), vec,
        _build.dtype_code(x),
        _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_fwd")
    dtp_lin_fwd.launches += 1
    return out


def fold_gather(plan: DTPLinPlan, W_flat: torch.Tensor, Wrs: torch.Tensor,
                index: torch.Tensor) -> torch.Tensor:
    """``cat([W_flat, Wrs.reshape(-1), 0])[index]``: W and [Wr; offset]
    packed together for a folded kernel (``k1_tables(fold=True)``,
    ``k7_leg_tables``) in two launches; the zero is kept on the plan."""
    key = ("zero", W_flat.device, W_flat.dtype)
    zero = plan._tables.get(key)
    if zero is None:
        zero = plan._tables[key] = W_flat.new_zeros(1)
    return torch.cat([W_flat, Wrs.reshape(-1), zero])[index]


def k2_packed_W(plan: DTPLinPlan, W_flat: torch.Tensor) -> torch.Tensor:
    """Each group's W_g in mma fragment order, as K2's dz product and K5b's
    x and w legs read it (``k2_tables().wp_index``)."""
    return torch.cat([W_flat, W_flat.new_zeros(1)])[plan.k2_tables(W_flat.device).wp_index]


def _k2_call(entry: str, plan: DTPLinPlan, g, x, sh, w, Wp, n_edges, dx, dw, dW, part, *extra,
             blocks_per_sm: int = K2_DW_BLOCKS_PER_SM, row: Optional[int] = None,
             range_tiles: Optional[int] = None):
    """The C entry ``entry`` of ``csrc/dtp_lin_bwd.cu`` launched on checked
    operands, K2's argument list on K2's tables: ``dtp_lin_bwd`` (K2),
    ``dtp_lin_bwd_stage`` (S3), ``dtp_lin_edge_leg`` (K5b's x and w legs),
    ``dtp_lin_legW`` (K5c), ``dtp_lin_rad_bwd`` (K7-B), ``dtp_lin_rad_legW``
    (K7-LW) or ``dtp_lin_rad_legWr`` (K7-Wr), with None for what it does not read or
    write and its own trailing arguments in ``extra``.  With ``dW`` the
    launch-2 partial rows [n_ranges, row] (``row`` w_numel by default) are
    allocated here (``k2_ranges`` at ``blocks_per_sm`` over ``range_tiles``
    tiles, the dW tiles by default); else ``part`` is the entry's scratch
    or None."""
    E, dev = g.shape[0], g.device
    _, terms, coeffs, dwmap, _, span_max, _ = plan.bwd_tables(dev)
    kt = plan.k2_tables(dev)
    n_tiles = kt.tiles.shape[0]
    n_ranges, range_len = k2_ranges(E, n_tiles if range_tiles is None else range_tiles,
                                    _sm_count(dev), blocks_per_sm)
    if dW is not None:
        part = torch.empty((n_ranges, plan.w_numel if row is None else row),
                           dtype=torch.float32, device=dev)
    err = getattr(_build.library(), entry)(
        _build.ptr(x), 0 if x is None else x.stride(0), plan.d_x, _build.ptr(sh), plan.d_sh,
        _build.ptr(w), plan.d_w, _build.ptr(Wp), _build.ptr(g), plan.d_out,
        _build.ptr(n_edges), E, _build.ptr(kt.gk), kt.gk.shape[0], _build.ptr(terms),
        _build.ptr(coeffs), _build.ptr(dwmap), _build.ptr(dx), _build.ptr(dw), span_max,
        kt.cp_max, kt.fd_max, _build.ptr(kt.tiles), n_tiles, _build.ptr(part), n_ranges,
        range_len, _build.ptr(dW), plan.w_numel, *extra, _build.dtype_code(g),
        _build.stream_ptr(),
    )
    _build.check(err, entry)


def _k2_launch(entry: str, plan: DTPLinPlan, x, sh, w, W_flat, g, n_edges, *extra):
    """K2's operands checked and laid out, its outputs allocated, and the C
    entry ``entry`` (``dtp_lin_bwd`` or ``dtp_lin_bwd_stage``, whose stage
    is ``extra``) launched on them: (dx, dw or None, dW, launched)."""
    E = sh.shape[0]
    x, sh, w, W_flat = _check_operands(plan, x, sh, w, W_flat)
    if g.shape != (E, plan.d_out) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"cotangent must be [{E}, {plan.d_out}] in x's dtype and device")
    g = g.contiguous()
    n_edges = _check_n_edges(n_edges, E, x.device)
    dev = x.device
    dx = torch.empty((E, plan.d_x), dtype=x.dtype, device=dev)
    dw = None
    if w is not None:
        dw = (torch.zeros if plan.dw_has_dead_cols else torch.empty)(
            (E, plan.d_w), dtype=x.dtype, device=dev)
    dW = torch.zeros((plan.w_numel,), dtype=torch.float32, device=dev)
    if E == 0:
        return dx, dw, dW, False
    _k2_call(entry, plan, g, x, sh, w, k2_packed_W(plan, W_flat), n_edges, dx, dw, dW, None,
             *extra)
    return dx, dw, dW, True


def dtp_lin_bwd(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w, W_flat: torch.Tensor,
                g: torch.Tensor, n_edges=None):
    """K2: (dx [E, d_x], dw [E, d_w] or None, dW_flat [w_numel] float32) for
    the cotangent ``g`` [E, d_out] of ``dtp_lin_fwd`` on the same operands.
    CPU tensors take ``dtp_lin_bwd_plain``; CUDA tensors launch the kernel
    (float32 or bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_lin_bwd_plain(plan, x, sh, w, W_flat, g, n_edges)
    dx, dw, dW, launched = _k2_launch("dtp_lin_bwd", plan, x, sh, w, W_flat, g, n_edges)
    dtp_lin_bwd.launches += launched
    return dx, dw, dW


# K2 cut after each of its phases, in the kernels' order (S3,
# tools/bwd_attr.py).  Launch 1 (dx, dw): the tile loop, zeroing and the x /
# w staging, + G staged, + the dz product, + the term transposes and the dx
# / dw flush; launch 2 (dW): the loop and G staged, + z recomputed, + the dW
# product (the whole of K2).
BWD_STAGES = ("x, w staged", "+G", "+dz", "+transposes", "+dW: G", "+z", "+dW product")
FULL_STAGE = len(BWD_STAGES) - 1
DXDW_STAGE = BWD_STAGES.index("+transposes")  # launch 1 whole: dx and dw as K2's


def dtp_lin_bwd_stage_plain(plan: DTPLinPlan, x, sh, w, W_flat, g, stage: int, n_edges=None):
    """Plain version of ``dtp_lin_bwd_stage``: ``dtp_lin_bwd_plain``'s
    outputs at the full stage; before it dW = 0, and dx, dw are
    ``dtp_lin_bwd_plain``'s from ``DXDW_STAGE`` on (zero before)."""
    if not 0 <= stage <= FULL_STAGE:
        raise ValueError(f"stage must be 0..{FULL_STAGE}, got {stage}")
    dx, dw, dW = dtp_lin_bwd_plain(plan, x, sh, w, W_flat, g, n_edges)
    if stage == FULL_STAGE:
        return dx, dw, dW
    if stage < DXDW_STAGE:
        dx = torch.zeros_like(dx)
        dw = None if dw is None else torch.zeros_like(dw)
    return dx, dw, torch.zeros_like(dW)


def dtp_lin_bwd_stage(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, w,
                      W_flat: torch.Tensor, g: torch.Tensor, stage: int, n_edges=None):
    """S3: K2 (``dtp_lin_bwd``, same operands and outputs) with the phases
    after ``stage`` (``BWD_STAGES``) left out, to time each phase; the full
    stage is K2's own code.  CPU tensors take ``dtp_lin_bwd_stage_plain``;
    CUDA tensors launch the kernel (float32 or bfloat16) or raise."""
    if not 0 <= stage <= FULL_STAGE:
        raise ValueError(f"stage must be 0..{FULL_STAGE}, got {stage}")
    if x.device.type == "cpu":
        return dtp_lin_bwd_stage_plain(plan, x, sh, w, W_flat, g, stage, n_edges)
    dx, dw, dW, launched = _k2_launch("dtp_lin_bwd_stage", plan, x, sh, w, W_flat, g, n_edges,
                                      stage)
    dtp_lin_bwd_stage.launches += launched
    return dx, dw, dW


dtp_lin_fwd.launches = 0
dtp_lin_bwd.launches = 0
dtp_lin_bwd_stage.launches = 0


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _k7f_launch_shape(plan: DTPLinPlan, x: torch.Tensor, E: int) -> Tuple[int, bool]:
    """K7-F's edge tile and whether it reads x through L2 (``k1_tile``,
    ``k1_x_global``), kept on the plan per dtype, row stride and E: the
    folded force step calls K7-F 27 times, and its host time is its
    limit."""
    size, x_rows = x.element_size(), x.stride(0) != 0
    key = ("k7f", size, x_rows, E)
    shape = plan._tables.get(key)
    if shape is None:
        tile = k1_tile(plan, size, x_rows, E, _sm_count(x.device), fold=True)
        shape = plan._tables[key] = (tile, k1_x_global(plan, size, x_rows, tile))
    return shape


def dtp_lin_rad_fwd(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, h: torch.Tensor,
                    Wrs: torch.Tensor, W_flat: torch.Tensor, n_edges=None) -> torch.Tensor:
    """K7-F: K1 with ``w = [h, 1] @ Wrs`` built in the kernel, [E, d_out].
    ``h`` [E, hd] is the radial MLP's last hidden activation and ``Wrs`` the
    plan's ``pack_radial(Wr, offset)`` [hd + 1, d_w].  K1's block per (edge
    tile, irrep group) (``csrc/dtp_lin.cu``, ``k1::rad_fwd_kernel``) builds
    its group's w from h on the tensor cores before the z walk, from W and
    [Wr; offset] packed by one gather (``k1_tables(fold=True)``,
    ``fold_gather``).  CPU tensors take ``dtp_lin_rad_plain``; CUDA tensors
    launch the kernel (float32 or bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_lin_rad_plain(plan, x, sh, h, Wrs, W_flat, n_edges)
    E = sh.shape[0]
    x, sh, (h, Wrs), W_flat = _check_operands(plan, x, sh, (h, Wrs), W_flat, local=False)
    n_edges = _check_n_edges(n_edges, E, x.device)
    terms, coeffs = plan.device_tables(x.device)
    kt = plan.k1_tables(x.device, fold=True)
    out = torch.empty((E, plan.d_out), dtype=x.dtype, device=x.device)
    if E == 0:
        return out
    packed = fold_gather(plan, W_flat, Wrs, kt.wp_index)
    tile, x_global = _k7f_launch_shape(plan, x, E)
    vec = kt.vec if not x_global or (x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0) else 1
    err = _build.library().dtp_lin_rad_fwd(
        _build.ptr(x), x.stride(0), plan.d_x, _build.ptr(sh), plan.d_sh, None, 0,
        _build.ptr(packed), _build.ptr(out), plan.d_out, _build.ptr(n_edges), E,
        _build.ptr(kt.gk), _build.ptr(kt.groups), kt.groups.shape[0], _build.ptr(kt.runs),
        _build.ptr(terms), _build.ptr(coeffs), kt.fz_max, tile, vec, _build.ptr(h),
        plan.radial_fold, packed.data_ptr() + kt.pk_base * packed.element_size(),
        _build.ptr(kt.rg), kt.span_max, int(x_global), _build.dtype_code(x),
        _build.stream_ptr(),
    )
    _build.check(err, "dtp_lin_rad_fwd")
    dtp_lin_rad_fwd.launches += 1
    return out


def k7_wr_tiles(hd: int, n_loc: int) -> int:
    """The d[Wr; offset] tiles of K7-B's launch 2 and of K7-Wr: 64 rows of
    hd (``K2_FAN_TILE``) by 128 local columns (``K2_COL_TILE``), as
    ``k2::wr_tiles``."""
    return -(-hd // K2_FAN_TILE) * -(-n_loc // K2_COL_TILE)


def dtp_lin_rad_bwd(plan: DTPLinPlan, x: torch.Tensor, sh: torch.Tensor, h: torch.Tensor,
                    Wrs: torch.Tensor, W_flat: torch.Tensor, g: torch.Tensor, n_edges=None):
    """K7-B: (dx [E, d_x], dh [E, hd], d[Wr; offset] [hd + 1, d_w] float32,
    dW_flat [w_numel] float32) for the cotangent ``g`` [E, d_out] of
    ``dtp_lin_rad_fwd`` on the same operands, on K2's two launches with the
    fold (``csrc/dtp_lin_bwd.cu``, k2::rad_dxdw_kernel and
    k2::rad_dW_kernel) and the fixed-order sum of the ranges' partial rows
    (dW, then d[Wr; offset]).  w is built on chip in both launches and never
    reaches device memory; dw goes to a workspace [E, d_w] in x's dtype,
    which launch 2's d[Wr; offset] tiles read.  CPU tensors take
    ``dtp_lin_rad_bwd_plain``; CUDA tensors launch the kernels (float32 or
    bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_lin_rad_bwd_plain(plan, x, sh, h, Wrs, W_flat, g, n_edges)
    E = sh.shape[0]
    x, sh, (h, Wl), W_flat = _check_operands(plan, x, sh, (h, Wrs), W_flat)
    if g.shape != (E, plan.d_out) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"cotangent must be [{E}, {plan.d_out}] in x's dtype and device")
    g = g.contiguous()
    n_edges = _check_n_edges(n_edges, E, x.device)
    dev, hd, n_loc = x.device, plan.radial_fold, Wl.shape[1]
    dx = torch.empty((E, plan.d_x), dtype=x.dtype, device=dev)
    dh = torch.empty((E, hd), dtype=x.dtype, device=dev)
    row = plan.w_numel + (hd + 1) * n_loc  # a partial row: dW, then d[Wr; offset]
    red = torch.zeros((row,), dtype=torch.float32, device=dev)
    if E > 0:
        kr = plan.k7_tables(dev)
        pk = torch.cat([Wl.reshape(-1), Wl.new_zeros(1)])[kr.index]
        dw = torch.empty((E, plan.d_w), dtype=x.dtype, device=dev)  # the dw workspace
        _k2_call("dtp_lin_rad_bwd", plan, g, x, sh, None, k2_packed_W(plan, W_flat), n_edges,
                 dx, dw, red, None, _build.ptr(h), hd, _build.ptr(Wl), n_loc, _build.ptr(pk),
                 _build.ptr(kr.rgk), _build.ptr(dh), row=row,
                 range_tiles=plan.k2_tables(dev).tiles.shape[0] + k7_wr_tiles(hd, n_loc))
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
