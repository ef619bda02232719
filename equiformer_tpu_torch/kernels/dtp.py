"""The depthwise tensor product as two sparse trilinear primitives (K6).

Counterpart of ``equiformer_tpu/kernels/dtp_pallas.py``: the unfused route
of every DTP call site, taken when the fused DTP + linear op is off
(``fused_dtp_lin=False``).  Per edge, over a static term list
``Term(a_off, col_off, b_off, out_off, mul, coeff)`` (``plan_terms``):

    T(a, col, b)[e, o+u] += c * col[e, j] * a[e, i+u] * b[e, p+u]
    R(a, b, d)[e, j]     += c * sum_u a[e, i+u] * b[e, p+u] * d[e, o+u]

for u < mul, with (i, j, p, o) = (a_off, col_off, b_off, out_off).  The DTP
``z = sum c * sh[j] * x[i] * w[p]`` is T(x, sh, w) of the plan's terms.  T is
trilinear, so its gradients are T and R of the same terms with two lane
operands (a, b, out) swapped (``perm_a``, ``perm_b``), and R's are T with its
lane operands permuted (``perm_r_a``, ``perm_r_b``, ``perm_r_d``): the family
is closed under differentiation, and force training's grad-of-grad stays on
the two kernels.  A lane operand given as one row is broadcast over the
edges (``shared``): the internal weight of a shared-weight DTP and the
edge-degree embedding's constant feature; its gradient is summed over the
edges outside the kernels, as JAX's ``_maybe_sum_shared`` does.

On the card T is K6-T (``dtp_t``, ``csrc/dtp_t.cu``), the first-order
backward of the DTP in one launch (dx, dsh, dw) K6-FB (``dtp_fused_bwd``,
``csrc/dtp_fused_bwd.cu``), the backward of ``first_order_dtp``, and R
K6-R (``dtp_r``, ``csrc/dtp_r.cu``): K6-FB's block with dsh alone, since
R(a, b, d) is K6-FB's dsh for x = a, w = b, g = d.  CPU tensors take the plain versions
(``dtp_t_plain``, ``dtp_r_plain``, ``dtp_fused_bwd_plain``): loops over the
same term list.  JAX's lane-packed ``PackedPallasDTP`` computes the same
function as T with 128 // mul edges side by side in the TPU's lanes, a
layout the port does not carry over: its counterpart is K6-T.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.tensor_product import TensorProduct
from . import _build

# Legs whose gradient the running backward pass should not compute although
# the operand requires grad.  An autograd Function learns which of its inputs
# require grad when it is applied, not which of them the engine's current call
# asks for, so the caller who knows says so (``skip_leg_grads``).
_SKIPPED_LEGS: set = set()


@contextlib.contextmanager
def skip_leg_grads(*legs: str):
    """While active, the backward passes of the DTP ops compute no gradient
    for these legs: "out", "x", "sh", "w" or "W" of the fused op
    (``dtp_lin_ho.LEGS``), and on a radial-folded plan "out", "x", "sh", "h",
    "Wr" (the packed [Wr; offset]) or "W" (``dtp_lin_ho.LEGS_RAD``); of the
    T / R family, "W" names the broadcast operands (the shared weight, the
    edge-degree embedding's constant feature: functions of the parameters
    alone) and "sh" T's column.  The force pass of training asks for the
    position gradient only, so it skips "W" and "Wr" (the parameters are
    live and would each get a K5c, K7-LW, K7-Wr or T launch nobody reads),
    but not "h", which depends on the positions through the radial basis;
    the parameter pass skips "sh", which depends on nothing but the
    positions (no K5b or K7-L sh leg, no R).  A leg called with a cotangent
    in h's slot follows the ones-column rule (``dtp_lin_ho._put``).  The engine may run a backward on
    another thread, so this is a module-wide set, not a thread-local."""
    added = set(legs) - _SKIPPED_LEGS
    _SKIPPED_LEGS.update(added)
    try:
        yield
    finally:
        _SKIPPED_LEGS.difference_update(added)


# K6's launch shapes (csrc/dtp_t.cu, csrc/dtp_fused_bwd.cu, csrc/dtp_r.cu)
T_TILE = 32  # edges a K6-T block (kTile)
T_BLOCKS = 1056  # K6-T's blocks to aim for: 8 blocks of 8 warps on each of the H100's 132 SMs
T_ROW_GROUP = 4  # rows a K6-T run lists its items by
FB_SMEM = 40 << 10  # K6-FB's and K6-R's shared memory a block: five blocks an SM
# K6-FB's (edge tile, g staged) layouts, in order: the first whose block
# fits FB_SMEM
FB_LAYOUTS = ((8, True), (4, True), (2, True), (8, False), (4, False), (2, False), (1, False))
R_TILES = (8, 4, 2, 1)  # K6-R's edge tiles, largest first
R_BLOCKS = 528  # K6-R's blocks to aim for: four blocks of 8 warps on each of the 132 SMs


class Term(NamedTuple):
    a_off: int  # lane-tile offset in a
    col_off: int  # column of col
    b_off: int  # lane-tile offset in b
    out_off: int  # lane-tile offset in T's output; in R, in the operand d
    mul: int
    coeff: float


def plan_terms(tp: TensorProduct, fold_rescale: bool, eps: float = 1e-10) -> Tuple[Term, ...]:
    """Nonzero CG terms of a depthwise plan with mul-1 second input, in the
    order of ``_plan_terms``; with ``fold_rescale`` the fan-in rescale of
    external weights is in ``coeff``."""
    in_off = [s.start for s in tp.irreps_in1.slices()]
    sh_off = [s.start for s in tp.irreps_in2.slices()]
    out_off = [s.start for s in tp.irreps_out.slices()]
    terms = []
    for idx, ins in enumerate(tp.instructions):
        if ins.mode != "uvu" or tp.irreps_in2[ins.i_in2].mul != 1:
            raise ValueError("the DTP kernels support depthwise uvu with mul-1 SH")
        mul = tp.irreps_in1[ins.i_in1].mul
        C = tp._cg[idx] * (tp.slice_sqrt_k[ins.i_out] if fold_rescale else 1.0)
        d1, d2, d3 = C.shape
        for i in range(d1):
            for j in range(d2):
                for k in range(d3):
                    c = float(C[i, j, k])
                    if abs(c) < eps:
                        continue
                    terms.append(Term(in_off[ins.i_in1] + i * mul, sh_off[ins.i_in2] + j,
                                      tp._offsets[idx], out_off[ins.i_out] + k * mul, mul, c))
    return tuple(terms)


class TermList:
    """A term list of T / R with the widths of its operands: a [E or 1, d_a],
    col [E, d_col], b [E or 1, d_b] and T's output (R's d) [E, d_out].

    ``TermList.for_plan(tp, fold_rescale)`` is the DTP's own list: a = x,
    b = w, out = z.  Its permutations (``perm_a`` and the others) are built
    once each and shared by the whole family, ``slots`` naming which of the
    plan's lane operands (0 x, 1 w, 2 z) sits in a, b and out; so are the
    device tables of each member."""

    def __init__(self, terms, d_a: int, d_col: int, d_b: int, d_out: int,
                 slots=(0, 1, 2), family=None):
        self.terms = tuple(terms)
        self.d_a, self.d_col, self.d_b, self.d_out = d_a, d_col, d_b, d_out
        self.slots = slots
        self._family = {} if family is None else family
        self._family[slots] = self
        self._tables: Dict[tuple, tuple] = {}

    @classmethod
    def for_plan(cls, tp: TensorProduct, fold_rescale: bool) -> "TermList":
        return cls(plan_terms(tp, fold_rescale), tp.irreps_in1.dim, tp.irreps_in2.dim,
                   tp.weight_numel, tp.irreps_out.dim)

    def permuted(self, order: Tuple[int, int, int]) -> "TermList":
        """This list with its lane operands (a, b, out) replaced by its own
        operands number order[0], order[1], order[2]."""
        slots = tuple(self.slots[i] for i in order)
        tl = self._family.get(slots)
        if tl is None:
            base = self._family[(0, 1, 2)]
            dims = (base.d_a, base.d_b, base.d_out)
            lanes = [(t.a_off, t.b_off, t.out_off) for t in base.terms]
            tl = TermList([Term(ln[slots[0]], t.col_off, ln[slots[1]], ln[slots[2]], t.mul, t.coeff)
                           for t, ln in zip(base.terms, lanes)],
                          dims[slots[0]], base.d_col, dims[slots[1]], dims[slots[2]],
                          slots, self._family)
        return tl

    # ------------------------------------------------------- device tables
    def _segments(self):
        """(term order, segments): the terms sorted by output tile (stably)
        and the segments (output column, width, term range) that cover
        every output column once, those that no term writes with an empty
        range."""
        key = ("segments",)
        if key not in self._tables:
            order = sorted(range(len(self.terms)), key=lambda i: self.terms[i].out_off)
            segs, col, i = [], 0, 0
            while i < len(order):
                t = self.terms[order[i]]
                j = i
                while j < len(order) and self.terms[order[j]].out_off == t.out_off:
                    if self.terms[order[j]].mul != t.mul:
                        raise ValueError("terms of one output tile differ in width")
                    j += 1
                if t.out_off < col:
                    raise ValueError("output tiles overlap")
                if t.out_off > col:
                    segs.append((col, t.out_off - col, i, i))
                segs.append((t.out_off, t.mul, i, j))
                col, i = t.out_off + t.mul, j
            if col > self.d_out:
                raise ValueError("an output tile runs past d_out")
            if col < self.d_out:
                segs.append((col, self.d_out - col, len(order), len(order)))
            self._tables[key] = (order, segs)
        return self._tables[key]

    def vec4(self) -> bool:
        """Whether K6's lanes may own 4 consecutive columns: every lane
        offset, width and row width is a multiple of 4 (the same for every
        member of the family)."""
        key = ("vec4",)
        if key not in self._tables:
            self._tables[key] = all(
                v % 4 == 0 for t in self.terms for v in (t.a_off, t.b_off, t.out_off, t.mul)
            ) and all(d % 4 == 0 for d in (self.d_a, self.d_b, self.d_out))
        return self._tables[key]

    def chunks(self, vec: int):
        """K6's chunks of T's segments for lanes of ``vec`` columns: (chunk
        records [(column, width | lg << 8 | du << 11, term begin, term end)],
        term records [(a_off, col_off, b_off, coeff)] in ``_segments``'
        order, each chunk's cost), by ``cut_segments``."""
        key = ("chunks", vec)
        if key not in self._tables:
            order, segs = self._segments()
            chunks, cost = cut_segments(segs, vec)
            terms = [(t.a_off, t.col_off, t.b_off, t.coeff) for t in (self.terms[i] for i in order)]
            self._tables[key] = chunks, terms, cost
        return self._tables[key]

    def t_runs(self, E: int, vec: int) -> int:
        """K6-T's runs a tile (the grid's second dimension): 1 where the
        edge tiles alone give T_BLOCKS blocks, else doubled up to 16 or
        the chunk count."""
        tiles, n = -(-E // T_TILE), len(self.chunks(vec)[0])
        runs = 1
        while tiles * runs < T_BLOCKS and runs * 2 <= min(n, 16):
            runs *= 2
        return runs

    def t_plan(self, device: torch.device, vec: int, runs: int):
        """K6-T's tables, as csrc/dtp_t.cu reads them: (chunks int32 [n, 4],
        terms int32 [n_t, 4] with the coefficient's float32 bits last,
        items int32 [n_i] (chunk << 8 | first row), run_items int32 [runs
        + 1]).  The chunks are cut into ``runs`` contiguous runs of about
        equal cost; a run's items are listed row group by row group
        (T_ROW_GROUP rows, the run's chunks in order within a group)."""
        key = ("t_plan", device, vec, runs)
        if key not in self._tables:
            chunks, terms, cost = self.chunks(vec)
            total, acc, bounds = sum(cost), 0, [0]
            for k, c in enumerate(cost):
                acc += c
                if len(bounds) < runs and acc * runs >= total * len(bounds):
                    bounds.append(k + 1)
            bounds += [len(chunks)] * (runs + 1 - len(bounds))
            items, run_items = [], [0]
            for lo, hi in zip(bounds, bounds[1:]):
                keyed = []
                for k in range(lo, hi):
                    rpw = 32 >> ((chunks[k][1] >> 8) & 7)
                    keyed += [((r // T_ROW_GROUP, k, r), k << 8 | r) for r in range(0, T_TILE, rpw)]
                items += [it for _, it in sorted(keyed)]
                run_items.append(len(items))
            self._tables[key] = (_i32(chunks, 4, device), _term_records(terms, device),
                                 _i32(items, 0, device), _i32(run_items, 0, device))
        return self._tables[key]

    def fb_tile(self, size: int, shared_x: bool, shared_w: bool, vec: int) -> Tuple[int, bool]:
        """K6-FB's (edge tile, g staged): the first of FB_LAYOUTS (8, 4 or
        2 edges with g, then 8, 4, 2 or 1 with g read through L1 / L2: MD17
        L3) whose x, w, g, sh rows and dsh slots fit FB_SMEM.  Many small
        blocks an SM beat few large ones: at QM9 sep_act the 2-edge tile
        with g took 0.450 ms fp32 against 0.564 for 4 edges and 0.818 for 8
        (kernel_ab's layouts, H100).  ``size``: bytes an element."""
        key = ("fb_tile", size, shared_x, shared_w, vec)
        if key not in self._tables:
            n_slots = self._fb_lists(vec, 1)[4]
            fits = [(tile, gs) for tile, gs in FB_LAYOUTS
                    if _fb_bytes(tile, size, shared_x, shared_w, gs, self.d_a, self.d_b,
                                 self.d_out, self.d_col, n_slots) <= FB_SMEM]
            if not fits:
                raise ValueError("a row of x, w and sh does not fit K6-FB's shared memory")
            self._tables[key] = fits[0]
        return self._tables[key]

    def r_tile(self, E: int, size: int, shared_a: bool, vec: int) -> int:
        """K6-R's edge tile: the largest of R_TILES whose a rows and slots
        fit FB_SMEM and whose grid has R_BLOCKS blocks at E edges, else the
        smallest that fits.  b and d are read through L1 / L2 (a lane reads
        its column of b once an item, d's elements are read by the few
        terms of their output tile): at every site the 8-edge tile without
        them ran within 2% of the fastest layout at QM9, and the 4-edge one
        in bf16 at MD17 L3 (0.092 ms against 0.103 with b staged), where 8
        edges give 368 blocks and ran 0.154 (kernel_ab's layouts, H100).
        ``size``: bytes an element."""
        key = ("r_tile", E, size, shared_a, vec)
        if key not in self._tables:
            n_slots = self._fb_lists(vec, 1)[4]
            fits = [t for t in R_TILES if _fb_bytes(t, size, shared_a, False, False, self.d_a, 0,
                                                    self.d_out, 0, n_slots) <= FB_SMEM]
            if not fits:
                raise ValueError("a row of a and R's slots do not fit K6-R's shared memory")
            self._tables[key] = next((t for t in fits if -(-E // t) >= R_BLOCKS), fits[-1])
        return self._tables[key]

    def _fb_lists(self, vec: int, tile: int):
        """K6-FB's tables as lists: (dx chunks, dx term records, dw chunks,
        dw term records, n_slots, dsh ranges, dsh slots, items in order of
        falling cost)."""
        key = ("fb_lists", vec, tile)
        if key not in self._tables:
            (cx, tx, _), (cw, tw, _) = perm_a(self).chunks(vec), perm_b(self).chunks(vec)
            keyed = []  # (minus the item's terms, item)
            for k, (_, y, tb, te) in enumerate(cx + cw):
                keyed += [(tb - te - 1, k << 8 | r) for r in range(0, tile, 32 >> ((y >> 8) & 7))]
            keyed.sort(key=lambda kv: kv[0])
            by_col = [[] for _ in range(self.d_col)]
            for _, y, tb, te in cw:
                for t in range(tb, te):
                    by_col[tw[t][1]].append((t, (y >> 11) // (32 * vec)))
            n_slots = len(tw) * (1 + max((p for col in by_col for _, p in col), default=0))
            ranges, slots = [], []
            for col in by_col:
                ranges.append((len(slots), len(slots) + len(col)))
                slots += [p * len(tw) + t for t, p in sorted(col)]
            self._tables[key] = (cx, tx, cw, tw, n_slots, ranges, slots,
                                 [it for _, it in keyed])
        return self._tables[key]

    def fb_plan(self, device: torch.device, vec: int, tile: int):
        """K6-FB's tables, as csrc/dtp_fused_bwd.cu reads them: (chunks
        int32 [n_dx + n_dw, 4]: ``perm_a``'s chunks, then ``perm_b``'s; n_dx;
        dx and dw term records int32 [n, 4]; n_dw_terms; n_slots, the dsh
        slots a row (one a dw chunk's term and piece: slot = piece *
        n_dw_terms + term); dsh ranges int32 [d_col, 2] into dsh slots int32
        [n] (each SH column's slots, by term, then piece); items int32
        (chunk << 8 | first row) in order of falling cost, so that the
        warps' shares even out)."""
        key = ("fb", device, vec, tile)
        if key not in self._tables:
            cx, tx, cw, tw, n_slots, ranges, slots, items = self._fb_lists(vec, tile)
            self._tables[key] = (
                _i32(cx + cw, 4, device), len(cx), _term_records(tx, device),
                _term_records(tw, device), len(tw), n_slots, _i32(ranges, 2, device),
                _i32(slots, 0, device), _i32(items, 0, device))
        return self._tables[key]

    def r_plan(self, device: torch.device, vec: int, tile: int):
        """K6-R's tables, as csrc/dtp_r.cu reads them: ``fb_plan``'s dsh
        part alone (chunks int32 [n, 4]: ``perm_b``'s; their term records;
        n_terms; n_slots; the column ranges into the slots; the items of
        those chunks, in fb_plan's order), so that each slot and each
        column's sum are K6-FB's."""
        key = ("r", device, vec, tile)
        if key not in self._tables:
            cx, _, cw, tw, n_slots, ranges, slots, items = self._fb_lists(vec, tile)
            n_dx = len(cx)
            self._tables[key] = (
                _i32(cw, 4, device), _term_records(tw, device), len(tw), n_slots,
                _i32(ranges, 2, device), _i32(slots, 0, device),
                _i32([it - (n_dx << 8) for it in items if it >> 8 >= n_dx], 0, device))
        return self._tables[key]


def cut_segments(segs, vec: int):
    """Segments (output column, width, term begin, term end) cut into K6's
    chunks for lanes of ``vec`` columns: (chunk records [(column, width |
    lg << 8 | du << 11, term begin, term end)], each chunk's cost).  A
    segment is cut into chunks of at most 32 * vec columns (du: the chunk's
    column in its segment); 2^lg lanes cover a chunk's row
    (csrc/dtp_tr.cuh, ``item_lane``)."""
    chunks, cost = [], []
    for o, width, tb, te in segs:
        for du in range(0, width, 32 * vec):
            wd = min(32 * vec, width - du)
            lg = (-(-wd // vec) - 1).bit_length()
            chunks.append((o + du, wd | lg << 8 | du << 11, tb, te))
            cost.append((te - tb + 1) * wd)
    return chunks, cost


def _i32(rows, width, device):
    """int32 rows ([n, width]; width 0: a flat [n]), one zero row if empty."""
    if not rows:
        rows = [(0,) * width] if width else [0]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _term_records(terms, device):
    """K6-T's 16-byte term records [n, 4]: a_off, col_off, b_off and the
    coefficient's float32 bits."""
    if not terms:
        return torch.zeros((1, 4), dtype=torch.int32, device=device)
    rec = torch.tensor([t[:3] for t in terms], dtype=torch.int32)
    bits = torch.tensor([t[3] for t in terms], dtype=torch.float32).view(torch.int32)
    return torch.cat([rec, bits[:, None]], 1).to(device)


def _fb_bytes(tile, size, shared_x, shared_w, stage_g, d_x, d_w, d_g, d_sh, n_slots) -> int:
    """K6-FB's shared memory a block (csrc/dtp_fb.cuh, ``fb_layout``); K6-R's
    with R's a in x's place and d_w = d_sh = 0, g not staged (a rows and
    slots alone)."""
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    rows = lambda shared: 1 if shared else tile  # noqa: E731
    return (a16(rows(shared_x) * d_x * size) + a16(rows(shared_w) * d_w * size)
            + (a16(tile * d_g * size) if stage_g else 0) + a16(tile * d_sh * 4)
            + tile * n_slots * 4)


# The term permutations of JAX's transposes (dtp_pallas.py:185-190, :272-286).
def perm_a(tl: TermList) -> TermList:
    """a <-> out: the a cotangent of T is T(ct, col, b) on these terms."""
    return tl.permuted((2, 1, 0))


def perm_b(tl: TermList) -> TermList:
    """b <-> out: the b cotangent of T is T(a, col, ct) on these terms."""
    return tl.permuted((0, 2, 1))


def perm_r_a(tl: TermList) -> TermList:
    """The a cotangent of R(a, b, d) is T(b, ct, d) on these terms."""
    return tl.permuted((1, 2, 0))


def perm_r_b(tl: TermList) -> TermList:
    """The b cotangent of R(a, b, d) is T(a, ct, d) on these terms (the
    same list as ``perm_b``)."""
    return tl.permuted((0, 2, 1))


def perm_r_d(tl: TermList) -> TermList:
    """The d cotangent of R(a, b, d) is T(a, ct, b) on the terms of R."""
    return tl


# ------------------------------------------------------------ plain versions
PLAIN_CHUNK = 1 << 22  # elements of one gathered [E, terms, mul] block


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _plain_chunks(tl: TermList, E: int, device: torch.device):
    """The term list in blocks of terms of one width ``mul``, at most
    PLAIN_CHUNK elements per edge block: (mul, a index, col, b index, out
    index, coeffs), the lane indices [k, mul] of each term's copies."""
    key = ("plain", device)
    if key not in tl._tables:
        blocks = {}
        for t in tl.terms:
            blocks.setdefault(t.mul, []).append(t)
        tl._tables[key] = [
            (m, [torch.tensor([getattr(t, f) for t in ts], device=device)
                 for f in ("a_off", "col_off", "b_off", "out_off")],
             torch.tensor([t.coeff for t in ts], dtype=torch.float64, device=device))
            for m, ts in blocks.items()]
    for m, (ai, ci, bi, oi), c in tl._tables[key]:
        u = torch.arange(m, device=device)
        k = max(1, PLAIN_CHUNK // max(1, E * m))
        for s in range(0, len(c), k):
            sl = slice(s, s + k)
            yield (m, (ai[sl, None] + u).reshape(-1), ci[sl], (bi[sl, None] + u).reshape(-1),
                   (oi[sl, None] + u).reshape(-1), c[sl])


def dtp_t_plain(tl: TermList, a, col, b) -> torch.Tensor:
    """Plain version of K6-T: [E, d_out] in col's dtype (accumulated in at
    least float32); a and b have E rows or one (broadcast).  Gathers the
    terms' lanes block by block and adds them at their output columns."""
    acc = _acc(col.dtype)
    a, cf, b = a.to(acc), col.to(acc), b.to(acc)
    E = col.shape[0]
    out = cf.new_zeros((E, tl.d_out))
    for m, ai, ci, bi, oi, c in _plain_chunks(tl, E, col.device):
        v = (c.to(acc) * cf[:, ci]).repeat_interleave(m, dim=1) * a[:, ai] * b[:, bi]
        out.index_add_(1, oi, v)
    return out.to(col.dtype)


def dtp_r_plain(tl: TermList, a, b, d) -> torch.Tensor:
    """Plain version of K6-R: [E, d_col] in d's dtype (accumulated in at
    least float32); a and b have E rows or one (broadcast)."""
    acc = _acc(d.dtype)
    a, b, df = a.to(acc), b.to(acc), d.to(acc)
    E = d.shape[0]
    out = df.new_zeros((E, tl.d_col))
    for m, ai, ci, bi, oi, c in _plain_chunks(tl, E, d.device):
        v = (a[:, ai] * b[:, bi] * df[:, oi]).view(E, -1, m).sum(2) * c.to(acc)
        out.index_add_(1, ci, v)
    return out.to(d.dtype)


def dtp_fused_bwd_plain(tl: TermList, x, sh, w, g):
    """Plain version of K6-FB: (dx [E, d_a], dsh [E, d_col], dw [E, d_b])
    for the cotangent ``g`` of T(x, sh, w) on ``tl``; a broadcast x or w
    gets its gradient per edge (the caller sums it)."""
    return (dtp_t_plain(perm_a(tl), g, sh, w), dtp_r_plain(tl, x, w, g),
            dtp_t_plain(perm_b(tl), x, sh, g))


# ----------------------------------------------------------------- wrappers
def _lane_rows(t: torch.Tensor, E: int, width: int, like: torch.Tensor, name: str):
    """(t, row stride) as the kernels read a lane operand: [E, width] rows,
    or one row, or a row ``expand`` (stride 0)."""
    if t.dim() != 2 or t.shape[1] != width or t.shape[0] not in (1, E):
        raise ValueError(f"{name} must be [{E} or 1, {width}], got {tuple(t.shape)}")
    if t.dtype != like.dtype or t.device != like.device:
        raise TypeError("the operands must share a dtype and a device")
    if t.shape[0] == 1 or (t.stride(1) == 1 and t.stride(0) == 0):
        return t[:1].contiguous(), 0
    return t.contiguous(), width


def _edge_rows(t: torch.Tensor, E: int, width: int, like: torch.Tensor, name: str):
    if t.shape != (E, width):
        raise ValueError(f"{name} must be [{E}, {width}], got {tuple(t.shape)}")
    if t.dtype != like.dtype or t.device != like.device:
        raise TypeError("the operands must share a dtype and a device")
    return t.contiguous()


def _vec(tl: TermList, *ts) -> int:
    """4 where K6's lanes may own 4 columns (``TermList.vec4``, every
    operand 16-byte aligned), else 1."""
    return 4 if tl.vec4() and all(t.data_ptr() % 16 == 0 for t in ts) else 1


def dtp_t(tl: TermList, a: torch.Tensor, col: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6-T: T(a, col, b) [E, d_out] in col's dtype; a [E or 1, d_a],
    col [E, d_col], b [E or 1, d_b] (one row is broadcast).  CPU tensors
    take ``dtp_t_plain``; CUDA tensors launch the kernel (float32 or
    bfloat16) or raise."""
    if col.device.type == "cpu":
        return dtp_t_plain(tl, a, col, b)
    E = col.shape[0]
    _build.dtype_code(col)
    col = _edge_rows(col, E, tl.d_col, col, "col")
    a, sa = _lane_rows(a, E, tl.d_a, col, "a")
    b, sb = _lane_rows(b, E, tl.d_b, col, "b")
    out = torch.empty((E, tl.d_out), dtype=col.dtype, device=col.device)
    if E == 0:
        return out
    vec = _vec(tl, a, b, out)
    runs = tl.t_runs(E, vec)
    chunks, terms, items, run_items = tl.t_plan(col.device, vec, runs)
    err = _build.library().dtp_t(
        _build.ptr(a), sa, _build.ptr(col), tl.d_col, _build.ptr(b), sb, _build.ptr(out),
        tl.d_out, E, _build.ptr(chunks), _build.ptr(terms), _build.ptr(items),
        _build.ptr(run_items), runs, vec, _build.dtype_code(col), _build.stream_ptr())
    _build.check(err, "dtp_t")
    dtp_t.launches += 1
    return out


def dtp_r(tl: TermList, a: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
          tile: Optional[int] = None) -> torch.Tensor:
    """K6-R: R(a, b, d) [E, d_col] in d's dtype; a [E or 1, d_a], b [E or 1,
    d_b], d [E, d_out]; K6-FB's dsh in every bit on the same operands.
    ``tile``: the edge tile to launch with instead of ``TermList.r_tile``'s
    (a measurement's choice; the results do not depend on it).  CPU tensors
    take ``dtp_r_plain``; CUDA tensors launch the kernel (float32 or
    bfloat16) or raise."""
    if d.device.type == "cpu":
        return dtp_r_plain(tl, a, b, d)
    E = d.shape[0]
    _build.dtype_code(d)
    d = _edge_rows(d, E, tl.d_out, d, "d")
    a, sa = _lane_rows(a, E, tl.d_a, d, "a")
    b, sb = _lane_rows(b, E, tl.d_b, d, "b")
    out = torch.empty((E, tl.d_col), dtype=d.dtype, device=d.device)
    if E == 0:
        return out
    vec = _vec(tl, a, b, d)
    tile = tile or tl.r_tile(E, d.element_size(), sa == 0, vec)
    chunks, terms, n_terms, n_slots, ranges, slots, items = tl.r_plan(d.device, vec, tile)
    err = _build.library().dtp_r(
        _build.ptr(a), sa, _build.ptr(b), sb, _build.ptr(d), tl.d_out, _build.ptr(out),
        tl.d_col, tl.d_a, tl.d_b, E, tile, _build.ptr(chunks), _build.ptr(terms),
        n_terms, n_slots, _build.ptr(ranges), _build.ptr(slots), _build.ptr(items),
        items.shape[0], vec, _build.dtype_code(d), _build.stream_ptr())
    _build.check(err, "dtp_r")
    dtp_r.launches += 1
    return out


def dtp_fused_bwd(tl: TermList, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                  g: torch.Tensor, layout: Optional[Tuple[int, bool]] = None):
    """K6-FB: (dx [E, d_a], dsh [E, d_col], dw [E, d_b]) for the cotangent
    ``g`` [E, d_out] of T(x, sh, w) on ``tl``, in one launch; a broadcast x
    or w gets its gradient per edge (the caller sums it).  ``layout``: the
    (edge tile, g staged) to launch with instead of ``TermList.fb_tile``'s
    (a measurement's choice; the results do not depend on it).  CPU tensors
    take ``dtp_fused_bwd_plain``; CUDA tensors launch the kernel (float32
    or bfloat16) or raise."""
    if g.device.type == "cpu":
        return dtp_fused_bwd_plain(tl, x, sh, w, g)
    E = g.shape[0]
    _build.dtype_code(g)
    g = _edge_rows(g, E, tl.d_out, g, "g")
    sh = _edge_rows(sh, E, tl.d_col, g, "sh")
    x, sx = _lane_rows(x, E, tl.d_a, g, "x")
    w, sw = _lane_rows(w, E, tl.d_b, g, "w")
    empty = lambda n: torch.empty((E, n), dtype=g.dtype, device=g.device)  # noqa: E731
    dx, dsh, dw = empty(tl.d_a), empty(tl.d_col), empty(tl.d_b)
    if E == 0:
        return dx, dsh, dw
    vec = _vec(tl, x, w, g, dx, dw)
    tile, stage_g = layout or tl.fb_tile(g.element_size(), sx == 0, sw == 0, vec)
    chunks, n_dx, dxt, dwt, n_dwt, n_slots, ranges, slots, items = tl.fb_plan(
        g.device, vec, tile)
    err = _build.library().dtp_fused_bwd(
        _build.ptr(x), sx, _build.ptr(sh), tl.d_col, _build.ptr(w), sw, _build.ptr(g), tl.d_out,
        _build.ptr(dx), tl.d_a, _build.ptr(dsh), _build.ptr(dw), tl.d_b, E, tile, int(stage_g),
        _build.ptr(chunks), n_dx, _build.ptr(dxt), _build.ptr(dwt), n_dwt, n_slots,
        _build.ptr(ranges), _build.ptr(slots), _build.ptr(items), items.shape[0], vec,
        _build.dtype_code(g), _build.stream_ptr())
    _build.check(err, "dtp_fused_bwd")
    dtp_fused_bwd.launches += 1
    return dx, dsh, dw


dtp_t.launches = 0
dtp_r.launches = 0
dtp_fused_bwd.launches = 0


# ----------------------------------------------------------- autograd family
def _sum_shared(t: torch.Tensor, shared: bool) -> torch.Tensor:
    return t.sum(0, keepdim=True) if shared else t


def _skip(shared: bool) -> bool:
    """A broadcast operand is a function of the parameters alone: its
    gradient is skipped where the caller skips the "W" leg."""
    return shared and "W" in _SKIPPED_LEGS


class _T(torch.autograd.Function):
    """T as an autograd op; its backward is T (a, b) and R (col), called
    through ``apply`` so that ``create_graph=True`` records them."""

    @staticmethod
    def forward(ctx, tl, shared_a, shared_b, a, col, b):
        ctx.tl, ctx.shared = tl, (shared_a, shared_b)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, col, b)
        return dtp_t(tl, a, col, b)

    @staticmethod
    def backward(ctx, ct):
        if ct is None:
            return (None,) * 6
        tl, (sa, sb) = ctx.tl, ctx.shared
        a, col, b = ctx.saved_tensors
        need_a, need_col, need_b = ctx.needs_input_grad[3:]
        ga = gcol = gb = None
        if need_a and not _skip(sa):
            ga = _sum_shared(t_apply(perm_a(tl), ct, col, b, False, sb), sa)
        if need_col and "sh" not in _SKIPPED_LEGS:
            gcol = r_apply(tl, a, b, ct, sa, sb)
        if need_b and not _skip(sb):
            gb = _sum_shared(t_apply(perm_b(tl), a, col, ct, sa, False), sb)
        return None, None, None, ga, gcol, gb


class _R(torch.autograd.Function):
    """R as an autograd op; its backward is three T, called through
    ``apply``."""

    @staticmethod
    def forward(ctx, tl, shared_a, shared_b, a, b, d):
        ctx.tl, ctx.shared = tl, (shared_a, shared_b)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, b, d)
        return dtp_r(tl, a, b, d)

    @staticmethod
    def backward(ctx, ct):
        if ct is None:
            return (None,) * 6
        tl, (sa, sb) = ctx.tl, ctx.shared
        a, b, d = ctx.saved_tensors
        need_a, need_b, need_d = ctx.needs_input_grad[3:]
        ga = gb = gd = None
        if need_a and not _skip(sa):
            ga = _sum_shared(t_apply(perm_r_a(tl), b, ct, d, sb, False), sa)
        if need_b and not _skip(sb):
            gb = _sum_shared(t_apply(perm_r_b(tl), a, ct, d, sa, False), sb)
        if need_d:
            gd = t_apply(perm_r_d(tl), a, ct, b, sa, sb)
        return None, None, None, ga, gb, gd


def t_apply(tl: TermList, a, col, b, shared_a: bool = False, shared_b: bool = False):
    """T(a, col, b), differentiable to any order; a shared operand is one
    row [1, d] broadcast over the edges (its gradient is summed to one
    row)."""
    return _T.apply(tl, shared_a, shared_b, a, col, b)


def r_apply(tl: TermList, a, b, d, shared_a: bool = False, shared_b: bool = False):
    """R(a, b, d), differentiable to any order (shared operands as in
    ``t_apply``)."""
    return _R.apply(tl, shared_a, shared_b, a, b, d)


class _FirstOrder(torch.autograd.Function):
    """T forward, the whole backward in one K6-FB launch (first order only,
    as JAX's ``make_first_order_dtp``)."""

    @staticmethod
    def forward(ctx, tl, shared_x, shared_w, x, sh, w):
        ctx.tl, ctx.shared = tl, (shared_x, shared_w)
        ctx.save_for_backward(x, sh, w)
        return dtp_t(tl, x, sh, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, sh, w = ctx.saved_tensors
        (sx, sw), need = ctx.shared, ctx.needs_input_grad[3:]
        dx, dsh, dw = dtp_fused_bwd(ctx.tl, x, sh, w, g)
        return (None, None, None, _sum_shared(dx, sx) if need[0] else None,
                dsh if need[1] else None, _sum_shared(dw, sw) if need[2] else None)


def first_order_dtp(tl: TermList, x, sh, w, shared_x: bool = False, shared_w: bool = False):
    """T(x, sh, w) whose backward is one K6-FB launch (dx, dsh and dw
    together; dsh is computed even when nobody reads it, as in JAX); not
    differentiable twice."""
    return _FirstOrder.apply(tl, shared_x, shared_w, x, sh, w)
