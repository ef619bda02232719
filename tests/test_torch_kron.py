"""The kron-basis fused DTP + linear op (K8) of the port against the JAX package.

The kron route (``kron_g``, JAX's ``EQUIFORMER_TPU_KRON_G=1``) computes the
fused op of ``dtp_lin`` as Kop = sh * x * w times G, the CG coefficients
folded into the packed W.  The port lays G out without JAX's 16-row padding,
so the two packages compare through the heads' weights, never through G.
Here, on the CPU:

* the port's ``KronMeta`` layout, and its kernel tables walked the way
  K8-F's kernel (``csrc/dtp_lin.cu``, K1's product on a 64-edge tile) and
  K2's launches (K8-B) walk them against the plain versions, also at the
  flagship's plans;
* the port's op against JAX's ``make_fused_dtp_lin_kron`` in interpret mode
  (fp32, 1e-5 of max |JAX|: the two sum in another order);
* the plain kron op against ``dtp_lin`` at the QM9 flagship's three plans
  (fp64, 1e-12);
* a reduced ``kron_g=True`` QM9 model against the JAX model (its einsum
  route: Pallas is TPU-only on the CPU), forward and three ``make_qm9_steps``
  training steps, fp64, 1e-9;
* the switch rules.

The CUDA kernels are held to the plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps, depthwise_tp as j_dtp  # noqa: E402
from equiformer_tpu.data import qm9_like_dataset  # noqa: E402
from equiformer_tpu.graph.batching import collate_dense as j_collate  # noqa: E402
from equiformer_tpu.kernels.dtp_lin_kron import make_fused_dtp_lin_kron  # noqa: E402
from equiformer_tpu.kernels.dtp_lin_pallas import DTPLinPlan as JPlan  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.train import engine as jeng, optim as jopt, state as jstate  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
import equiformer_tpu_torch.nn as tnn  # noqa: E402
from equiformer_tpu_torch.core import Irreps, depthwise_tp  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate_dense as t_collate  # noqa: E402
from equiformer_tpu_torch.kernels.dtp_lin_kron import KRON_COLS, KRON_TILE  # noqa: E402
from equiformer_tpu_torch.kernels import (  # noqa: E402
    DTPLinPlan,
    KronMeta,
    dtp_lin,
    dtp_lin_ho,
    dtp_lin_kron,
    dtp_lin_kron_bwd_plain,
    dtp_lin_kron_plain,
    kron_meta,
)
from equiformer_tpu_torch.kernels.dtp_lin import (  # noqa: E402
    K2_COL_TILE,
    K2_EDGES,
    K2_FAN_TILE,
    k2_ranges,
)
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.nn.tp_modules import KRON_OVERRIDES_FOLD  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax, torch_name  # noqa: E402
from tests.test_torch_kernels import _emulate_k1, _unpack_k1, _unpack_k2  # noqa: E402

IRR = "8x0e+4x1e+2x2e"
SH = "1x0e+1x1e+1x2e"
LIN_OUT = "14x0e+4x1e+2x2e"
ALPHA_OUT = "6x0e"
# the port's reduced plans: (heads, shared weights, row-broadcast x)
PLANS = {
    "two-head": ([LIN_OUT, ALPHA_OUT], False, False),
    "shared-w": ([LIN_OUT], True, False),
    "broadcast-x": ([LIN_OUT], False, True),
    "dead-w-cols": (["5x0e+3x1e"], False, False),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _head_ws(tp_out, heads, rng):
    """numpy head weights [fan, mul_out] per head and output block (None
    where no TP output block has the irrep)."""
    out = []
    for h in heads:
        ws = []
        for mul_out, ir_out in Irreps(h):
            fan = sum(m for m, ir in tp_out if ir == ir_out)
            ws.append(rng.normal(size=(fan, mul_out)) / np.sqrt(max(fan, 1)) if fan else None)
        out.append(ws)
    return out


# ------------------------------------------------------------------ layout
def test_kron_meta_layout():
    """Every (group, component) has a contiguous row range, the ranges tile
    each group's G, every plan term appears exactly once, and build_G gives
    each group G of shape [sum of its ranges, cols] with a triple's rows its
    coefficient times the packed W's fan rows."""
    tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    plan = DTPLinPlan(tp, [LIN_OUT, ALPHA_OUT])
    meta = KronMeta(plan)
    n_q = 0
    for gi, g in enumerate(plan.groups):
        acc = 0
        for k in range(g.ir.dim):
            rs, re = meta.k_ranges[(gi, k)]
            assert rs == acc and re - rs == sum(q.mul for q in meta.qcols[(gi, k)])
            n_q += len(meta.qcols[(gi, k)])
            acc = re
        assert meta.g_rows[gi] == acc
    assert n_q == len(plan.terms)
    assert sorted((q.a_off, q.col_off, q.b_off, gk) for gk, qs in meta.qcols.items()
                  for q in qs) == sorted((t.a_off, t.col_off, t.b_off, (gi, k))
                                         for t, (gi, k, _) in plan.terms)
    W = torch.randn(plan.w_numel, dtype=torch.float64)
    G = meta.build_G(W)
    assert G.shape == (meta.numel,) and meta.numel == sum(
        r * g.cols for r, g in zip(meta.g_rows, plan.groups))
    for gi, g in enumerate(plan.groups):
        Gg = G[meta.g_off[gi] : meta.g_off[gi] + meta.g_rows[gi] * g.cols].view(-1, g.cols)
        assert Gg.shape == (meta.g_rows[gi], g.cols)
        Wg = plan.group_weight(W, gi)
        r = 0
        for k in range(g.ir.dim):
            for q in meta.qcols[(gi, k)]:
                assert torch.equal(Gg[r : r + q.mul], q.coeff * Wg[q.fc : q.fc + q.mul])
                r += q.mul
    with pytest.raises(ValueError):
        KronMeta(DTPLinPlan(tp, [LIN_OUT], radial_fold=8))


def _operands(plan, E, dt=torch.float64, seed=0, broadcast=False):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    w = None if plan.shared_weights else rnd(E, plan.d_w)
    return x, rnd(E, plan.d_sh), w, rnd(plan.w_numel), rnd(E, plan.d_out)


def _emulate_kron64(meta, x, sh, w, G, n_edges, ks=32):
    """K8-F (csrc/dtp_lin.cu k1::kron_fwd_kernel) in torch
    over ``meta.k1_tables``: a block per (64-edge tile, column chunk of
    KRON_COLS of a (g, k), in order): the (g, k)'s row table built from its
    runs (x, sh and w column, coefficient), then per slice of ``ks`` Kop rows
    Kop (zero past n_k and the real edges) times the chunk's columns of G
    unpacked from the packing by the fragment layout, added into the
    block's accumulator, written once.  Returns (out, how often each element
    was written)."""
    kt = meta.k1_tables(torch.device("cpu"))
    gk, runs, terms = kt.gk.tolist(), kt.runs.tolist(), kt.terms.tolist()
    coeffs = kt.coeffs.tolist()
    Gp = torch.cat([G, G.new_zeros(1)])[kt.gp_index]
    E, plan = sh.shape[0], meta.plan
    out = torch.full((E, plan.d_out), float("nan"), dtype=x.dtype)
    writes = torch.zeros((E, plan.d_out), dtype=torch.int64)
    chunks = [(q, j0) for q, r in enumerate(gk) for j0 in range(0, r[1], KRON_COLS)]
    assert len(chunks) == kt.n_chunks
    for e0 in range(0, E, KRON_TILE):
        n_rows, n_live = min(KRON_TILE, E - e0), max(0, min(KRON_TILE, E - e0, n_edges - e0))
        live = slice(e0, e0 + n_live)
        for q, j0 in chunks:
            f16, cols, out_col, gp_off, rb, re, n_nt, n_k = gk[q]
            ncol = min(KRON_COLS, cols - j0)
            acc = torch.zeros(n_rows, ncol, dtype=x.dtype)
            if n_live:
                rows = [None] * n_k
                for fc, mul, b, t0, _ in runs[rb:re]:
                    for u in range(mul):
                        rows[fc + u] = (terms[t0][0] + u, terms[t0][1], b + u, coeffs[t0])
                Gq = _unpack_k1(Gp[gp_off : gp_off + f16 * 8 * n_nt], n_k, cols)
                for r0 in range(0, n_k, ks):
                    kop = torch.zeros(n_rows, ks, dtype=x.dtype)
                    for r in range(r0, min(n_k, r0 + ks)):
                        xi, col, wi, c = rows[r]
                        v = c * sh[live, col] * x[live, xi]
                        kop[:n_live, r - r0] = v if w is None else v * w[live, wi]
                    g = torch.zeros(ks, ncol, dtype=x.dtype)
                    g[: min(ks, f16 - r0)] = Gq[r0 : r0 + ks, j0 : j0 + ncol]
                    acc += kop @ g
            out[e0 : e0 + n_rows, out_col + j0 : out_col + j0 + ncol] = acc
            writes[e0 : e0 + n_rows, out_col + j0 : out_col + j0 + ncol] += 1
    return out, writes


def _packed_GT(meta, G, row):
    """The G^T [round8(n_k), round16(cols)] of one gk row of
    ``meta.bwd_tables`` from the packed ``cat([G, 0])[gp_index]``,
    unpacked by the mma fragment layout (``_unpack_k2``): rows are Kop rows,
    columns G's."""
    kt = meta.bwd_tables(torch.device("cpu"))
    n_k, cols, gp_off, cp = row[0], row[1], row[6], row[7]
    Gp = torch.cat([G, G.new_zeros(1)])[kt.gp_index]
    return _unpack_k2(Gp[gp_off : gp_off + -(-n_k // 8) * 8 * cp], n_k, cols)


def _walk_bwd(meta, x, sh, w, G, g, n, sm_count=3, tile=16):
    """K8-B's two launches (K2's, csrc/dtp_lin_bwd.cu) over
    ``meta.bwd_tables`` in torch.  Launch 1, per 16-edge tile: per (g, k)
    the cotangent slice padded to the K step, dkop through the packed G^T
    (unpacked by the fragment layout), the triples' transposes into dx and
    the group's dw, flushed through dwmap at its last component; tiles past
    n zero.  Launch 2: per edge range (``k2_ranges``, whole steps of
    K2_EDGES, stopped at n) and dG tile, Kop's rows of the tile rebuilt per
    step from the triples that reach them, Kop^T g into the tile's
    accumulator, written once to the range's partial row; the rows summed in
    order.  Returns (dx, dw, dG, how often each partial element was
    written)."""
    kt = meta.bwd_tables(torch.device("cpu"))
    plan, E = meta.plan, x.shape[0]
    gk, terms = kt.gk.tolist(), kt.terms.tolist()
    dwmap = kt.dwmap.tolist()
    assert bool((kt.coeffs == 1).all())
    dx = torch.zeros((E, plan.d_x), dtype=x.dtype)
    dw = None if w is None else torch.zeros((E, plan.d_w), dtype=x.dtype)
    GT = [_packed_GT(meta, G, row) for row in gk]
    for e0 in range(0, E, tile):
        n_live = max(0, min(tile, n - e0, E - e0))
        rows = slice(e0, e0 + n_live)
        if n_live == 0:
            continue  # the wrapper's zeros stand for launch 1's
        s_dx = torch.zeros(n_live, plan.d_x, dtype=x.dtype)
        for q, (n_k, cols, oc, _, tb, te, _, cp, sb, sn, first, last) in enumerate(gk):
            assert cp % 16 == 0 and cp <= kt.cp_max and -(-n_k // 8) * 8 <= kt.fd_max
            if first:
                s_dw = torch.zeros(n_live, max(kt.span_max, 1), dtype=x.dtype)
                s_w = None if w is None else w[rows][:, dwmap[sb : sb + sn]]
            s_g = torch.zeros(n_live, cp, dtype=x.dtype)
            s_g[:, :cols] = g[rows, oc : oc + cols]
            dkop = s_g @ GT[q].T  # [n_live, round8(n_k)]
            width = 0
            for a, col, _, fc, mul, bl in terms[tb:te]:
                assert fc == width
                width += mul
                d = sh[rows, col : col + 1] * dkop[:, fc : fc + mul]
                if s_w is None:
                    s_dx[:, a : a + mul] += d
                else:
                    s_dx[:, a : a + mul] += d * s_w[:, bl : bl + mul]
                    s_dw[:, bl : bl + mul] += d * x[rows, a : a + mul]
            assert width == n_k
            if last and w is not None:
                dw[rows, dwmap[sb : sb + sn]] = s_dw[:, :sn]
        dx[rows] = s_dx
    n_ranges, range_len = k2_ranges(E, kt.tiles.shape[0], sm_count)
    part = torch.zeros((n_ranges, meta.numel), dtype=x.dtype)
    writes = torch.zeros((n_ranges, meta.numel), dtype=torch.int64)
    for ri in range(n_ranges):
        r_end = min(E, ri * range_len + range_len, n)
        for q0, n_comp, f0, fm, j0, fn in kt.tiles.tolist():
            assert n_comp == 1 and fm <= K2_FAN_TILE and fn <= K2_COL_TILE
            n_k, cols, oc, g_off, tb, te = gk[q0][:6]
            acc = torch.zeros(K2_FAN_TILE, K2_COL_TILE, dtype=x.dtype)
            for e0 in range(ri * range_len, r_end, K2_EDGES):
                live = slice(e0, min(r_end, e0 + K2_EDGES))
                kop = torch.zeros(K2_EDGES, K2_FAN_TILE, dtype=x.dtype)
                m = live.stop - live.start
                for a, col, b, fc, mul, _ in terms[tb:te]:
                    lo, hi = max(fc, f0), min(fc + mul, f0 + fm)
                    if lo >= hi:
                        continue
                    u0, u1 = lo - fc, hi - fc
                    v = sh[live, col : col + 1] * x[live, a + u0 : a + u1]
                    if w is not None:
                        v = v * w[live, b + u0 : b + u1]
                    kop[:m, lo - f0 : hi - f0] = v
                gs = torch.zeros(K2_EDGES, K2_COL_TILE, dtype=x.dtype)
                gs[:m, :fn] = g[live, oc + j0 : oc + j0 + fn]
                acc += kop.T @ gs
            idx = (g_off + (f0 + torch.arange(fm))[:, None] * cols + j0
                   + torch.arange(fn)).reshape(-1)
            part[ri, idx] = acc[:fm, :fn].reshape(-1)
            writes[ri, idx] += 1
    dG = part[0].clone()
    for row in part[1:]:
        dG += row
    return dx, dw, dG, writes


@pytest.mark.parametrize("case", list(PLANS))
def test_kernel_tables_drive_the_plain_math(case):
    """Walking K8-F's tables (``k1_tables``, K1's layout) the way K1's block
    in csrc/dtp_lin.cu walks K1's (16- and 32-edge tiles) and the way K8-F's
    kernel does (``_emulate_kron64``), each output element written once, and
    K8-B's the way K2's two launches in csrc/dtp_lin_bwd.cu do, gives the
    plain versions (fp64), rows past n_edges zero, each dG element written
    once per edge range."""
    heads, shared, broadcast = PLANS[case]
    plan = DTPLinPlan(depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR)), heads,
                      shared_weights=shared)
    meta = kron_meta(plan)
    E, n = 70, 53
    x, sh, w, W, g = _operands(plan, E, broadcast=broadcast)
    G = meta.build_G(W)
    nt = torch.tensor(n, dtype=torch.int32)
    want = dtp_lin_kron_plain(meta, x, sh, w, G, nt)
    for tile in (16, 32):
        got, writes = _emulate_k1(plan, x, sh, w, G, n, tile, kron=meta)
        assert bool((writes == 1).all())
        assert _rel(got, want) < 1e-13 and float(got[n:].abs().max()) == 0.0
    got, writes = _emulate_kron64(meta, x, sh, w, G, n)
    assert bool((writes == 1).all())
    assert _rel(got, want) < 1e-13 and float(got[n:].abs().max()) == 0.0
    assert float(want[n:].abs().max()) == 0.0
    *got, writes = _walk_bwd(meta, x, sh, w, G, g, n)
    assert bool((writes == 1).all())
    for a, b in zip(got, dtp_lin_kron_bwd_plain(meta, x, sh, w, G, g, nt)):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a, b) < 1e-13
    assert float(got[0][n:].abs().max()) == 0.0


@pytest.mark.parametrize("case", list(PLANS) + ["flagship-sep_act", "flagship-sep_value"])
def test_kron_packed_GT_holds_each_element_once(case):
    """K8-B's G^T packing (``gp_index``, B-fragment order): unpacked by the
    mma fragment layout itself, each (g, k)'s slots hold G's block
    transposed, every pad slot (Kop rows past n_k, columns past cols) is
    zero, and every element of G is packed exactly once."""
    if case.startswith("flagship"):
        plan = _flagship_sites()[case.split("-")[1]][0]
    else:
        heads, shared, _ = PLANS[case]
        plan = DTPLinPlan(depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR)), heads,
                          shared_weights=shared)
    meta = kron_meta(plan)
    kt = meta.bwd_tables(torch.device("cpu"))
    G = torch.arange(1, meta.numel + 1, dtype=torch.float64)
    used = torch.zeros(meta.numel + 1, dtype=torch.int64)
    used.index_add_(0, kt.gp_index, torch.ones_like(kt.gp_index))
    assert bool((used[:-1] == 1).all())
    gp_end = 0
    for row, (_, _, _, n_k, cols, _, g_off) in zip(kt.gk.tolist(), meta.blocks()):
        assert row[:2] == [n_k, cols] and row[3] == g_off and row[6] == gp_end
        got = _packed_GT(meta, G, row)
        want = torch.zeros_like(got)
        want[:n_k, :cols] = G[g_off : g_off + n_k * cols].view(n_k, cols)
        assert torch.equal(got, want)
        gp_end += got.numel()
    assert gp_end == kt.gp_index.numel()


@pytest.mark.parametrize("case", list(PLANS) + ["flagship-sep_act", "flagship-sep_value"])
def test_kron_packed_G_holds_each_element_once(case):
    """K8-F's G packing (``k1_tables().gp_index``, B-fragment order, K1's
    head-product layout): unpacked by the mma fragment layout itself, each
    (g, k)'s slots hold G's block [n_k, cols], every pad slot (Kop rows past
    n_k, columns past cols) is zero, and every element of G is packed
    exactly once; the gk rows name each block's size, its offset in the
    packing and a run per triple."""
    if case.startswith("flagship"):
        plan = _flagship_sites()[case.split("-")[1]][0]
    else:
        heads, shared, _ = PLANS[case]
        plan = DTPLinPlan(depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR)), heads,
                          shared_weights=shared)
    meta = kron_meta(plan)
    kt = meta.k1_tables(torch.device("cpu"))
    G = torch.arange(1, meta.numel + 1, dtype=torch.float64)
    used = torch.zeros(meta.numel + 1, dtype=torch.int64)
    used.index_add_(0, kt.gp_index, torch.ones_like(kt.gp_index))
    assert bool((used[:-1] == 1).all())
    Gp = torch.cat([G, G.new_zeros(1)])[kt.gp_index]
    gp_end = 0
    for row, (gi, k, _, n_k, cols, out_col, g_off) in zip(kt.gk.tolist(), meta.blocks()):
        f16, c, oc, gp_off, rb, re, n_nt, fan = row
        assert (c, oc, fan, n_nt, gp_off) == (cols, out_col, n_k, -(-cols // 8), gp_end)
        assert f16 == -(-n_k // 16) * 16 and re - rb == len(meta.qcols[(gi, k)])
        got = _unpack_k1(Gp[gp_off : gp_off + f16 * 8 * n_nt], n_k, cols)
        want = torch.zeros_like(got)
        want[:n_k, :cols] = G[g_off : g_off + n_k * cols].view(n_k, cols)
        assert torch.equal(got, want)
        gp_end += got.numel()
    assert gp_end == kt.gp_index.numel() and kt.fz_max == max(r[0] for r in kt.gk.tolist())


# ------------------------------------------------- against JAX's kron op
J_IRR, J_SH = "4x0e+2x1e", "1x0e+1x1e"
J_CASES = {"single": (["4x0e+2x1e"], False), "two-head": (["4x0e+2x1e", "3x0e"], False),
           "shared-w": (["4x0e+2x1e"], True)}


@pytest.mark.parametrize("case", list(J_CASES))
def test_kron_op_matches_jax_interpret(case):
    """The port's ``dtp_lin_kron`` against JAX's ``make_fused_dtp_lin_kron``
    (interpret mode) in fp32 on the same inputs, with n_edges below E and a
    cotangent zero past it: the heads' outputs and the gradients of x, w (or
    the shared w) and every head weight, on the rows below n_edges, within
    1e-5 of the largest JAX value."""
    heads, shared = J_CASES[case]
    E, n = 64, 40
    rng = np.random.default_rng(7)
    jtp = j_dtp(JIrreps(J_IRR), JIrreps(J_SH), JIrreps(J_IRR))
    jplan = JPlan(jtp, [JIrreps(h) for h in heads], fold_rescale=not shared,
                  shared_weights=shared, needs_dsh=False)
    plan = DTPLinPlan(depthwise_tp(Irreps(J_IRR), Irreps(J_SH), Irreps(J_IRR)), heads,
                      shared_weights=shared)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    x, sh = f32(rng.normal(size=(E, plan.d_x))), f32(rng.normal(size=(E, plan.d_sh)))
    w = f32(rng.normal(size=(plan.d_w,) if shared else (E, plan.d_w)))
    hws = [[f32(a) for a in ws] for ws in _head_ws(plan.tp.irreps_out, heads, rng)]
    live = (np.arange(E) < n)[:, None]
    cots = [f32(rng.normal(size=(E, Irreps(h).dim)) * live) for h in heads]

    fused = make_fused_dtp_lin_kron(jplan, tile=64, interpret=True)

    def jf(x, w, hws):
        return jplan.split_output(fused(x, jnp.asarray(sh), w, jplan.pack_weights(hws),
                                       n_edges=n))

    jout, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w), [[jnp.asarray(a) for a in ws]
                                                            for ws in hws])
    jdx, jdw, jdh = vjp([jnp.asarray(c) for c in cots])

    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    th = [[_t(a).requires_grad_() for a in ws] for ws in hws]
    out = plan.split_output(dtp_lin_kron(plan, tx, _t(sh), tw, plan.pack_weights(th),
                                         torch.tensor(n, dtype=torch.int32)))
    for o, jo in zip(out, jout):
        assert _rel(o.detach().numpy()[:n], np.asarray(jo)[:n]) < 1e-5
        assert float(o.detach()[n:].abs().max()) == 0.0
    leaves = [tx, tw] + [a for ws in th for a in ws]
    grads = torch.autograd.grad(sum((o * _t(c)).sum() for o, c in zip(out, cots)), leaves)
    assert _rel(grads[0].numpy()[:n], np.asarray(jdx)[:n]) < 1e-5
    assert _rel(grads[1].numpy() if shared else grads[1].numpy()[:n],
                np.asarray(jdw) if shared else np.asarray(jdw)[:n]) < 1e-5
    for got, want in zip(grads[2:], [a for ws in jdh for a in ws]):
        assert _rel(got.numpy(), want) < 1e-5


# ------------------------------------- the flagship's plans against dtp_lin
def _flagship_sites():
    """The QM9 flagship's three fused DTP plans (block 0's sep_act with its
    two heads, sep_value with shared weights, the edge degree): name ->
    (plan, row-broadcast x)."""
    irr, sh = "128x0e+64x1e+32x2e", "1x0e+1x1e+1x2e"
    sep_act = tnn.SeparableFCTP(irr, sh, irr, fc_neurons=(128, 64, 64), use_activation=True,
                                extra_head_irreps=("128x0e",), higher_order_grads=False,
                                kron_g=True)
    sep_value = tnn.SeparableFCTP(irr, sh, irr, internal_weights=True, higher_order_grads=False,
                                  kron_g=True)
    edge = tnn.EdgeDegreeEmbedding(irr, sh, (128, 64, 64), 15.0, higher_order_grads=False,
                                   kron_g=True)
    return {"sep_act": (sep_act.plan, False), "sep_value": (sep_value.plan, False),
            "edge_deg": (edge.plan, True)}


def test_flagship_kron_layout_sizes():
    """The kron layout of the flagship's plans: G rows per group 480 / 2528 /
    3840, 137 CG triples, G 453,632 elements at sep_act and 346,112 at
    sep_value and the edge degree, the widest (g, k) range 896 rows."""
    sites = _flagship_sites()
    for name, (plan, _) in sites.items():
        meta = kron_meta(plan)
        assert meta.g_rows == [480, 2528, 3840] and len(plan.terms) == 137
        assert meta.numel == (453632 if name == "sep_act" else 346112)
        assert max(re - rs for rs, re in meta.k_ranges.values()) == 896


@pytest.mark.parametrize("site", ["sep_act", "sep_value", "edge_deg"])
def test_plain_kron_matches_dtp_lin_at_flagship_plans(site):
    """``dtp_lin_kron`` (plain versions) against ``dtp_lin`` (plain versions)
    at the flagship's plans on 16 edges in fp64, n_edges 13: the output and
    the gradients of x (the broadcast feature at the edge degree), w (per
    edge, or the shared w) and the packed W, within 1e-12."""
    plan, broadcast = _flagship_sites()[site]
    E, n = 16, torch.tensor(13, dtype=torch.int32)
    g = torch.Generator().manual_seed(11)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    x = rnd(1, plan.d_x) if broadcast else rnd(E, plan.d_x)
    sh = rnd(E, plan.d_sh)
    w = rnd(plan.d_w) if plan.shared_weights else rnd(E, plan.d_w)
    W, cot = rnd(plan.w_numel), rnd(E, plan.d_out)
    res = []
    for op in (dtp_lin, dtp_lin_kron):
        leaves = [t.clone().requires_grad_() for t in (x, w, W)]
        xe = leaves[0].expand(E, plan.d_x) if broadcast else leaves[0]
        out = op(plan, xe, sh, leaves[1], leaves[2], n)
        res.append([out.detach()] + list(torch.autograd.grad((out * cot).sum(), leaves)))
    for a, b in zip(*res):
        assert _rel(b.numpy(), a.numpy()) < 1e-12


@pytest.mark.parametrize("site", ["sep_act", "sep_value", "edge_deg"])
def test_kron_k1_tables_drive_the_plain_math_at_flagship_plans(site):
    """K8-F's tables (``k1_tables``) at the QM9 flagship's three plans (896
    Kop rows at the widest (g, k); the edge degree's row-broadcast x,
    sep_value's shared weights folded into G), walked in torch as K1's block
    reads K1's tables (16-edge tile) and as K8-F's kernel walks them (64-edge
    tile, 128-column chunks, 32-row Kop slices): ``dtp_lin_kron_plain``
    within 1e-12 in fp64 on 20 edges of which 13 are real, each output
    element written once, rows past n_edges zero; the tables take 4-wide
    runs, and sep_act's 352-column 0e block three chunks."""
    plan, broadcast = _flagship_sites()[site]
    meta = kron_meta(plan)
    E, n = 20, 13
    x, sh, w, W, _ = _operands(plan, E, seed=14, broadcast=broadcast)
    G = meta.build_G(W)
    want = dtp_lin_kron_plain(meta, x, sh, w, G, torch.tensor(n, dtype=torch.int32))
    for got, writes in (_emulate_k1(plan, x, sh, w, G, n, 16, kron=meta),
                        _emulate_kron64(meta, x, sh, w, G, n)):
        assert bool((writes == 1).all())
        assert _rel(got, want) < 1e-12 and float(got[n:].abs().max()) == 0.0
    kt = meta.k1_tables(torch.device("cpu"))
    assert kt.vec == 4 and kt.n_chunks == len(meta.k_ranges) + 2 * (site == "sep_act")


# ------------------------------------------------- the model against JAX
QM9_REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
    fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
    num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=512, nodes_per_graph=30,
)
LR, WARMUP, TOTAL, WD, EMA, MEAN, STD = 2e-2, 2, 6, 5e-3, 0.5, 0.3, 1.7
TOL = 1e-9


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    return {torch_name(tuple(k.key for k in path)): np.asarray(a) for path, a in flat}


def _flip(name, a):
    """flax Dense kernels are [in, out], torch Linear weights [out, in]."""
    return a.T if name.endswith(".weight") and np.ndim(a) == 2 else a


def _qm9_batch(data, npdt):
    jb = j_collate(data, 30)
    return jb.__class__(**{**jb.__dict__, "pos": np.asarray(jb.pos, npdt),
                           "y": np.asarray(jb.y, npdt)})


def test_reduced_qm9_kron_matches_jax_forward_and_three_steps():
    """A reduced flagship with ``kron_g=True`` (K8-F / K8-B plain versions at
    all five fused sites) on one JAX tree: the forward against JAX's
    model, then three training steps against ``make_qm9_steps`` (loss, MAE,
    gradient norm per step, then every parameter), fp64, 1e-9 of the largest
    JAX value."""
    data = qm9_like_dataset(4, seed=0)
    jcfg = {k: JIrreps(v) if k.startswith("irreps") else v for k, v in QM9_REDUCED.items()}
    jm = JModel(**jcfg, nonlinear_message=True, higher_order_grads=False, alpha_drop=0.0)
    tree = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, deterministic=True))(
        _qm9_batch(data, np.float32))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    jb = _qm9_batch(data, np.float64)
    tm = TModel(**QM9_REDUCED, higher_order_grads=False, alpha_drop=0.0, kron_g=True).double()
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    assert tm.block_0.ga.sep_act.fused_op is dtp_lin_kron
    tb = t_collate(data, 30).to(dtype=torch.float64)
    want = jax.jit(lambda p, b: jm.apply(p, b, deterministic=True))(tree, jb)
    assert _rel(tm.eval()(tb).detach().numpy(), want) < TOL

    opt = jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD)
    j_step = jax.jit(jeng.make_qm9_steps(jm, opt, task_mean=MEAN, task_std=STD,
                                         ema_decay=EMA)[0])
    jst = jstate.TrainState.create(tree, opt)
    topt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD)
    tst = pt.TrainState.create(tm.train(), topt)
    t_step, _ = pt.make_qm9_steps(tm, topt, task_mean=MEAN, task_std=STD, ema_decay=EMA)
    for i in range(3):
        jst, jm_ = j_step(jst, jb, jax.random.PRNGKey(i))
        tst, tm_ = t_step(tst, tb, None)
        for k in ("loss", "mae", "grad_norm"):
            assert _rel(float(tm_[k]), float(jm_[k])) < TOL, (i, k)
    want = _leaves(jst.params)
    scale = max(np.abs(v).max() for v in want.values())
    for name, p in tst.params.items():
        assert np.abs(_flip(name, p.detach().numpy()) - want[name]).max() < TOL * scale, name


def test_reduced_units_call_the_kron_op(monkeypatch):
    """Per reduced QM9 step (2 blocks, 5 fused sites): 5 K8-F and 5 K8-B
    wrapper calls and no K1 / K2 / K7; the eval forward 5 K8-F."""
    import importlib

    kk = importlib.import_module("equiformer_tpu_torch.kernels.dtp_lin_kron")
    kd = importlib.import_module("equiformer_tpu_torch.kernels.dtp_lin")
    names = {kk: ("dtp_lin_kron_fwd", "dtp_lin_kron_bwd"),
             kd: ("dtp_lin_fwd", "dtp_lin_bwd", "dtp_lin_rad_fwd", "dtp_lin_rad_bwd")}
    calls = {n: 0 for ns in names.values() for n in ns}
    for mod, ns in names.items():
        for name in ns:
            def counting(*a, _f=getattr(mod, name), _n=name, **k):
                calls[_n] += 1
                return _f(*a, **k)
            monkeypatch.setattr(mod, name, counting)
    tm = TModel(**QM9_REDUCED, higher_order_grads=False, alpha_drop=0.0, kron_g=True)
    batch = t_collate(qm9_like_dataset(4, seed=0), 30)
    pt.evaluate(tm.eval(), batch)
    assert calls == {**dict.fromkeys(calls, 0), "dtp_lin_kron_fwd": 5}
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL))
    step, _ = pt.make_qm9_steps(tm.train(), opt)
    step(pt.TrainState.create(tm, opt), batch, None)
    assert calls == {**dict.fromkeys(calls, 0), "dtp_lin_kron_fwd": 10, "dtp_lin_kron_bwd": 5}


# ------------------------------------------------------------ switch rules
def test_kron_overrides_the_radial_fold_with_a_warning():
    """``kron_g`` with ``radial_fold`` builds the kron route at every
    per-edge-weight site, unfolded, with JAX's warning; the parameters are
    the same as without either switch."""
    with pytest.warns(UserWarning, match="kron_g overrides radial_fold") as rec:
        tm = TModel(**QM9_REDUCED, higher_order_grads=False, kron_g=True, radial_fold=True)
    assert sum(KRON_OVERRIDES_FOLD in str(r.message) for r in rec) == 3  # 2 sep_act, edge degree
    sites = [tm.edge_deg_embed] + [getattr(tm, f"block_{i}").ga.sep_act for i in range(2)]
    assert all(s.fused_op is dtp_lin_kron and s.plan.radial_fold is None for s in sites)
    ref = TModel(**QM9_REDUCED, higher_order_grads=False)
    assert [(n, p.shape) for n, p in tm.named_parameters()] == \
        [(n, p.shape) for n, p in ref.named_parameters()]


def test_kron_is_ignored_off_the_fused_first_order_route():
    """With ``higher_order_grads`` (force models) the fused op stays
    ``dtp_lin_ho``; with ``fused_dtp_lin=False`` there is none; neither
    warns about the fold."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ho = tnn.SeparableFCTP(IRR, SH, IRR, fc_neurons=(16, 8), kron_g=True, radial_fold=True,
                               higher_order_grads=True)
        unf = tnn.SeparableFCTP(IRR, SH, IRR, fc_neurons=(16, 8), kron_g=True,
                                fused_dtp_lin=False, higher_order_grads=False)
    assert ho.fused_op is dtp_lin_ho and unf.fused_op is None
    edge = tnn.EdgeDegreeEmbedding(IRR, SH, (16, 8), 3.0, kron_g=True)
    assert edge.fused_op is dtp_lin_ho


def test_kron_op_is_first_order_and_takes_no_sh_gradient():
    """A second derivative through the kron op raises, as does an ``sh``
    that needs a gradient."""
    plan = DTPLinPlan(depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR)), [LIN_OUT])
    x, sh, w, W, cot = _operands(plan, 10)
    x.requires_grad_()
    out = dtp_lin_kron(plan, x, sh, w, W)
    (dx,) = torch.autograd.grad((out * cot).sum(), [x], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dx.square().sum(), [x])
    with pytest.raises(ValueError, match="no gradient for sh"):
        dtp_lin_kron(plan, x, sh.requires_grad_(), w, W)
