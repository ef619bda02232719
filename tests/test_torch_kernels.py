"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those against the TPU kernels run in Pallas interpret mode (fp32) and
against the JAX einsum composition (fp64), and their gradients against
``jax.vjp`` of the same.  The TPU DTP kernel zeroes whole
edge tiles past ``n_edges``, the port zeroes rows, so only real edges are
compared.  Tolerances: fp32 within 1e-5 relative (float32 sums in another
order), fp64 within 1e-12 relative.  The CUDA kernels themselves are held
to these plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps, depthwise_tp as j_dtp  # noqa: E402
from equiformer_tpu.kernels.attn_csr_pallas import csr_attention_combine  # noqa: E402
from equiformer_tpu.kernels.dtp_lin_pallas import (  # noqa: E402
    DTPLinPlan as JPlan,
    make_fused_dtp_lin,
)
from equiformer_tpu.kernels.dtp_pallas import _plan_terms  # noqa: E402
from equiformer_tpu.kernels.segment_csr_pallas import csr_segment_sum as j_csr  # noqa: E402
from equiformer_tpu_torch.core import Irreps, depthwise_tp  # noqa: E402
from equiformer_tpu_torch.kernels import (  # noqa: E402
    DTPLinPlan,
    attn_combine,
    attn_combine_fwd,
    csr_segment_sum,
    dtp_lin,
    dtp_lin_bwd_plain,
    dtp_lin_fwd,
    dtp_lin_plain,
    reset_launch_counts,
)
from equiformer_tpu_torch.kernels.dtp_lin import plan_terms  # noqa: E402

IRR = "8x0e+4x1e+2x2e"
SH = "1x0e+1x1e+1x2e"
LIN_OUT = "14x0e+4x1e+2x2e"
ALPHA_OUT = "6x0e"
E, N_REAL = 256, 200
CASES = {
    "per-edge": ([LIN_OUT], False),
    "two-head": ([LIN_OUT, ALPHA_OUT], False),
    "shared-w": ([LIN_OUT], True),
}


def _rel(a, b, rows=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if rows is not None:
        a, b = a[:rows], b[:rows]
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _dtp_case(case, npdt, seed=0, E=E):
    heads, shared = CASES[case]
    rng = np.random.default_rng(seed)
    ttp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    x = rng.normal(size=(E, ttp.irreps_in1.dim)).astype(npdt)
    sh = rng.normal(size=(E, 9)).astype(npdt)
    w = rng.normal(size=(ttp.weight_numel,) if shared else (E, ttp.weight_numel)).astype(npdt)
    head_ws = []
    for h in heads:
        ws = []
        for mul_out, ir_out in Irreps(h):
            fan = sum(m for m, ir in ttp.irreps_out if ir == ir_out)
            ws.append(rng.normal(size=(fan, mul_out)).astype(npdt) if fan else None)
        head_ws.append(ws)
    return heads, shared, x, sh, w, head_ws


def _port(heads, shared, x, sh, w, head_ws, n_edges):
    tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    plan = DTPLinPlan(tp, heads, shared_weights=shared)
    W = plan.pack_weights([[None if a is None else torch.from_numpy(a) for a in ws]
                           for ws in head_ws])
    out = dtp_lin(plan, torch.from_numpy(x), torch.from_numpy(sh), torch.from_numpy(w), W,
                  None if n_edges is None else torch.tensor(n_edges, dtype=torch.int32))
    return plan, [o.numpy() for o in plan.split_output(out)], out.numpy()


def _jax_composed(heads, shared, x, sh, w, head_ws):
    """lin_h(tp.apply(x, sh, w)) for each head, with the JAX einsum TP."""
    tp = j_dtp(JIrreps(IRR), JIrreps(SH), JIrreps(IRR))
    z = tp.apply(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w), scale_weights=not shared)
    slices = tp.irreps_out.slices()
    outs = []
    for h, ws in zip(heads, head_ws):
        pieces = []
        for oi, (mul_out, ir_out) in enumerate(JIrreps(h)):
            blocks = [z[:, slices[i]].reshape(E, ir.dim, m)
                      for i, (m, ir) in enumerate(tp.irreps_out) if ir == ir_out]
            o = jnp.einsum("eiu,uw->eiw", jnp.concatenate(blocks, axis=-1), ws[oi])
            pieces.append(o.reshape(E, -1))
        outs.append(np.asarray(jnp.concatenate(pieces, axis=-1)))
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_dtp_lin_plain_matches_pallas_interpret(case):
    heads, shared, x, sh, w, head_ws = _dtp_case(case, np.float32)
    _, port_heads, out = _port(heads, shared, x, sh, w, head_ws, N_REAL)
    jplan = JPlan(j_dtp(JIrreps(IRR), JIrreps(SH), JIrreps(IRR)), [JIrreps(h) for h in heads],
                  fold_rescale=not shared, shared_weights=shared)
    fused = make_fused_dtp_lin(jplan, tile=128, interpret=True)
    Ws = jplan.pack_weights([[None if a is None else jnp.asarray(a) for a in ws]
                             for ws in head_ws])
    j_out = fused(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w), Ws, n_edges=N_REAL)
    for ph, jh in zip(port_heads, jplan.split_output(j_out)):
        assert ph.shape == jh.shape
        assert _rel(ph, jh, rows=N_REAL) < 1e-5
    assert np.all(out[N_REAL:] == 0.0)  # rows past n_edges are zero


@pytest.mark.parametrize("case", list(CASES))
def test_dtp_lin_plain_matches_composition_fp64(case):
    heads, shared, x, sh, w, head_ws = _dtp_case(case, np.float64, seed=1)
    _, port_heads, _ = _port(heads, shared, x, sh, w, head_ws, None)
    for ph, jh in zip(port_heads, _jax_composed(heads, shared, x, sh, w, head_ws)):
        assert _rel(ph, jh) < 1e-12


@pytest.mark.parametrize("fold", [True, False])
def test_dtp_plan_terms_bit_equal(fold):
    jtp = j_dtp(JIrreps(IRR), JIrreps(SH), JIrreps(IRR))
    ttp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    jt = [(t.a_off, t.col_off, t.b_off, t.out_off, t.mul, t.coeff) for t in _plan_terms(jtp, fold)]
    assert jt == [tuple(t) for t in plan_terms(ttp, fold)]


def test_dtp_plan_flagship_layout():
    """Flagship sep_act call site: fans 224/384/352, two heads, z 3136 wide."""
    emb = Irreps("128x0e+64x1e+32x2e")
    tp = depthwise_tp(emb, Irreps(SH), emb)
    act = DTPLinPlan(tp, ["224x0e+64x1e+32x2e", "128x0e"])
    assert [g.fan for g in act.groups] == [224, 384, 352]
    assert [g.cols for g in act.groups] == [352, 64, 32]
    assert act.d_out == 704
    assert sum(g.ir.dim * g.fan for g in act.groups) == 3136
    value = DTPLinPlan(tp, [str(emb)], shared_weights=True)
    assert value.d_out == 480 and value.d_w == 960


def _csr_inputs(npdt, C, seed=3, Eh=300, N=40):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, N, size=Eh)).astype(np.int32)
    dst[-20:] = N - 1  # padded tail, as the radius graph builds it
    mask = np.ones(Eh, bool)
    mask[-20:] = False
    mask[rng.random(Eh) < 0.1] = False
    val = rng.normal(size=(Eh, C)).astype(npdt)
    return val, dst, mask, N


def test_csr_segment_sum_plain_matches_pallas_interpret():
    val, dst, mask, N = _csr_inputs(np.float32, 130)
    j = np.asarray(j_csr(jnp.asarray(val), jnp.asarray(dst), N, mask=jnp.asarray(mask),
                         interpret=True))
    t = csr_segment_sum(torch.from_numpy(val), torch.from_numpy(dst).long(), N,
                        torch.from_numpy(mask)).numpy()
    assert _rel(t, j) < 1e-5


@pytest.mark.parametrize("dropout", [False, True])
def test_attn_combine_plain_matches_pallas_interpret(dropout):
    H, D = 4, 40  # H*D >= 128: the fused path
    val, dst, mask, N = _csr_inputs(np.float32, H * D, seed=4)
    rng = np.random.default_rng(5)
    scores = (2.0 * rng.normal(size=(len(dst), H))).astype(np.float32)
    dm = ((rng.random((len(dst), H)) < 0.8) / 0.8).astype(np.float32) if dropout else None
    value = val.reshape(-1, H, D)
    j = np.asarray(csr_attention_combine(
        jnp.asarray(scores), jnp.asarray(value), jnp.asarray(dst), N, mask=jnp.asarray(mask),
        dropmul=None if dm is None else jnp.asarray(dm), interpret=True))
    t = attn_combine(torch.from_numpy(scores), torch.from_numpy(value),
                     torch.from_numpy(dst).long(), N, torch.from_numpy(mask),
                     None if dm is None else torch.from_numpy(dm)).numpy()
    assert t.shape == (N, H, D)
    assert _rel(t, j) < 1e-5


def test_cpu_tensors_leave_launch_counts_at_zero():
    reset_launch_counts()
    heads, shared, x, sh, w, head_ws = _dtp_case("two-head", np.float32)
    _port(heads, shared, x, sh, w, head_ws, N_REAL)
    val, dst, mask, N = _csr_inputs(np.float32, 160)
    csr_segment_sum(torch.from_numpy(val), torch.from_numpy(dst).long(), N)
    attn_combine(torch.from_numpy(val[:, :4]), torch.from_numpy(val.reshape(-1, 4, 40)),
                 torch.from_numpy(dst).long(), N)
    assert (dtp_lin_fwd.launches, csr_segment_sum.launches, attn_combine.launches) == (0, 0, 0)


# ---------------------------------------------------------------- gradients
# The port's backward on the CPU (dtp_lin_bwd_plain inside the autograd op,
# the K3 gather, the K4 torch-op backward) against jax.vjp of the Pallas
# kernels in interpret mode.  The TPU DTP kernel's backward also runs on
# padded rows inside its last edge tile, so the cotangent is zero past
# N_REAL (as the model's masks make it) and dx / dw compare on real rows.
# fp32 within 1e-5 relative: float32 sums in another order.  Two TPU edge
# tiles (fp32 runs tile 64) keep the interpret-mode backward short.
E_GRAD, N_REAL_GRAD = 128, 100


def _port_grads(case, x, sh, w, head_ws, g, n_edges):
    heads, shared = CASES[case]
    tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    plan = DTPLinPlan(tp, heads, shared_weights=shared)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tws = [[None if a is None else torch.from_numpy(a).requires_grad_() for a in ws]
           for ws in head_ws]
    out = dtp_lin(plan, tx, torch.from_numpy(sh), tw, plan.pack_weights(tws),
                  torch.tensor(n_edges, dtype=torch.int32))
    out.backward(torch.from_numpy(g))
    return tx.grad.numpy(), tw.grad.numpy(), [[None if a is None else a.grad.numpy()
                                               for a in ws] for ws in tws]


@pytest.mark.parametrize("case", list(CASES))
def test_dtp_lin_grads_match_pallas_interpret(case):
    import jax

    heads, shared, x, sh, w, head_ws = _dtp_case(case, np.float32, seed=2, E=E_GRAD)
    jplan = JPlan(j_dtp(JIrreps(IRR), JIrreps(SH), JIrreps(IRR)), [JIrreps(h) for h in heads],
                  fold_rescale=not shared, shared_weights=shared)
    fused = make_fused_dtp_lin(jplan, tile=128, interpret=True)
    idx = [[i for i, a in enumerate(ws) if a is not None] for ws in head_ws]

    def f(x, w, hw):
        full = [[None] * len(ws) for ws in head_ws]
        for h, ii in enumerate(idx):
            for i, a in zip(ii, hw[h]):
                full[h][i] = a
        return fused(x, jnp.asarray(sh), w, jplan.pack_weights(full), n_edges=N_REAL_GRAD)

    hw = [[jnp.asarray(head_ws[h][i]) for i in ii] for h, ii in enumerate(idx)]
    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), hw)
    g = np.random.default_rng(3).normal(size=out.shape).astype(np.float32)
    g[N_REAL_GRAD:] = 0.0
    jdx, jdw, jdhw = vjp(jnp.asarray(g))
    tdx, tdw, tdhw = _port_grads(case, x, sh, w, head_ws, g, N_REAL_GRAD)
    assert _rel(tdx, jdx, rows=N_REAL_GRAD) < 1e-5
    assert _rel(tdw, jdw, rows=None if shared else N_REAL_GRAD) < 1e-5
    for h, ii in enumerate(idx):
        for i, jd in zip(ii, jdhw[h]):
            assert _rel(tdhw[h][i], jd) < 1e-5
    assert np.all(tdx[N_REAL_GRAD:] == 0.0)


BWD_CASES = {**{c: CASES[c] + (False,) for c in CASES},
             "broadcast-x": ([LIN_OUT], False, True), "dead-w-cols": (["5x0e+3x1e"], False, False)}


def _bwd_inputs(case, dtype, E=70, seed=4):
    heads, shared, broadcast = BWD_CASES[case]
    tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    plan = DTPLinPlan(tp, heads, shared_weights=shared)
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    w = None if shared else rnd(E, plan.d_w)
    return plan, x, rnd(E, plan.d_sh), w, rnd(plan.w_numel), rnd(E, plan.d_out)


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_dtp_lin_bwd_plain_matches_autograd_fp64(case):
    """The written-out backward equals torch autograd of dtp_lin_plain (the
    folded-weight form for the shared case) to 1e-12 relative."""
    plan, x, sh, w, W, g = _bwd_inputs(case, torch.float64)
    n = torch.tensor(61, dtype=torch.int32)
    ins = [t.clone().requires_grad_() for t in (x, W) + (() if w is None else (w,))]
    out = dtp_lin_plain(plan, ins[0], sh, None if w is None else ins[2], ins[1], n)
    ref = torch.autograd.grad(out, ins, g)
    dx, dw, dW = dtp_lin_bwd_plain(plan, x, sh, w, W, g, n)
    assert dW.dtype == torch.float64
    for got, want in zip((dx, dW, dw), ref):
        assert _rel(got.numpy(), want.numpy()) < 1e-12
    assert float(dx[61:].abs().max()) == 0.0


def _emulate_bwd_kernel(plan, x, sh, w, W_flat, g, n_edges, tile=16):
    """csrc/dtp_lin_bwd.cu's loop over ``plan.bwd_tables``, in torch, one
    edge tile at a time with the rows vectorized: the staged cotangent, the
    z recompute, the dW partial, dz through the packed W^T, the term
    transposes and the per-group dw flush through ``dwmap``."""
    gk, terms, coeffs, dwmap, wt_index, span_max, _ = plan.bwd_tables(torch.device("cpu"))
    gk, terms, coeffs, dwmap = gk.tolist(), terms.tolist(), coeffs.tolist(), dwmap.tolist()
    WT = torch.cat([W_flat, W_flat.new_zeros(1)])[wt_index]
    E = x.shape[0]
    dx = torch.zeros(E, plan.d_x, dtype=x.dtype)
    dw = None if w is None else torch.zeros(E, plan.d_w, dtype=x.dtype)
    dW = torch.zeros(plan.w_numel, dtype=x.dtype)
    for e0 in range(0, min(E, n_edges), tile):
        n_rows, n_live = min(tile, E - e0), min(tile, n_edges - e0)
        rows = slice(e0, e0 + n_live)
        dxs = torch.zeros(n_live, plan.d_x, dtype=x.dtype)
        dws = torch.zeros(n_live, max(span_max, 1), dtype=x.dtype)
        for fs, cols, out_col, w_off, tb, te, wt_off, cp, sb, sn, first, last in gk:
            if first:
                dws.zero_()
            gt = torch.zeros(n_live, cp, dtype=x.dtype)
            gt[:, :cols] = g[rows, out_col : out_col + cols]
            z = torch.zeros(n_live, fs, dtype=x.dtype)
            for (a, col, b, fc, mul, _), c in zip(terms[tb:te], coeffs[tb:te]):
                v = c * sh[rows, col : col + 1] * x[rows, a : a + mul]
                z[:, fc : fc + mul] += v if w is None else v * w[rows, b : b + mul]
            dW[w_off : w_off + fs * cols] += (z.T @ gt[:, :cols]).reshape(-1)
            dz = gt @ WT[wt_off : wt_off + cp * fs].reshape(cp, fs)
            for (a, col, b, fc, mul, bl), c in zip(terms[tb:te], coeffs[tb:te]):
                d = c * sh[rows, col : col + 1] * dz[:, fc : fc + mul]
                if w is None:
                    dxs[:, a : a + mul] += d
                else:
                    dxs[:, a : a + mul] += d * w[rows, b : b + mul]
                    dws[:, bl : bl + mul] += d * x[rows, a : a + mul]
            if w is not None and last:
                dw[rows, dwmap[sb : sb + sn]] = dws[:, :sn]
        dx[rows] = dxs
        assert n_rows >= n_live
    return dx, dw, dW


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_dtp_lin_bwd_tables_drive_the_plain_math(case):
    """The CUDA backward cannot run here; its tables can.  Walking them the
    way the kernel does gives dtp_lin_bwd_plain's gradients (fp64 inputs,
    the tables' fp32 CG coefficients: 1e-6 relative)."""
    plan, x, sh, w, W, g = _bwd_inputs(case, torch.float64, seed=5)
    want = dtp_lin_bwd_plain(plan, x, sh, w, W, g, torch.tensor(53, dtype=torch.int32))
    got = _emulate_bwd_kernel(plan, x, sh, w, W, g, 53)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a.numpy(), b.numpy()) < 1e-6


def test_dtp_lin_refuses_a_gradient_for_sh():
    plan, x, sh, w, W, _ = _bwd_inputs("per-edge", torch.float32)
    with pytest.raises(ValueError):
        dtp_lin(plan, x, sh.requires_grad_(), w, W)


def test_csr_segment_sum_grad_matches_pallas_interpret():
    import jax

    val, dst, mask, N = _csr_inputs(np.float32, 130)
    gout = np.random.default_rng(6).normal(size=(N, 130)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_csr(v, jnp.asarray(dst), N, mask=jnp.asarray(mask),
                                     interpret=True), jnp.asarray(val))
    tv = torch.from_numpy(val).requires_grad_()
    csr_segment_sum(tv, torch.from_numpy(dst).long(), N, torch.from_numpy(mask)).backward(
        torch.from_numpy(gout))
    assert _rel(tv.grad.numpy(), vjp(jnp.asarray(gout))[0]) < 1e-6
    assert np.all(tv.grad.numpy()[~mask] == 0.0)


@pytest.mark.parametrize("dropout", [False, True])
def test_attn_combine_grads_match_pallas_interpret(dropout):
    import jax

    H, D = 4, 40
    val, dst, mask, N = _csr_inputs(np.float32, H * D, seed=7)
    rng = np.random.default_rng(8)
    scores = (2.0 * rng.normal(size=(len(dst), H))).astype(np.float32)
    dm = ((rng.random((len(dst), H)) < 0.8) / 0.8).astype(np.float32) if dropout else None
    value = val.reshape(-1, H, D)
    gout = rng.normal(size=(N, H, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda s, v: csr_attention_combine(
        s, v, jnp.asarray(dst), N, mask=jnp.asarray(mask),
        dropmul=None if dm is None else jnp.asarray(dm), interpret=True),
        jnp.asarray(scores), jnp.asarray(value))
    jds, jdv = vjp(jnp.asarray(gout))
    ts = torch.from_numpy(scores).requires_grad_()
    tv = torch.from_numpy(value).requires_grad_()
    attn_combine(ts, tv, torch.from_numpy(dst).long(), N, torch.from_numpy(mask),
                 None if dm is None else torch.from_numpy(dm)).backward(torch.from_numpy(gout))
    assert _rel(ts.grad.numpy(), jds) < 1e-5
    assert _rel(tv.grad.numpy(), jdv) < 1e-5
    assert np.all(ts.grad.numpy()[~mask] == 0.0)


def test_attn_den_plain_is_the_softmax_denominator():
    H, D = 4, 40
    val, dst, mask, N = _csr_inputs(np.float32, H * D, seed=9)
    scores = torch.from_numpy(val[:, :H].copy())
    masked = torch.where(torch.from_numpy(mask)[:, None], scores, torch.full_like(scores, -1e30))
    out, den = attn_combine_fwd(masked, torch.from_numpy(val.reshape(-1, H, D)),
                                torch.from_numpy(dst).long(), N, torch.from_numpy(mask))
    m = scores[torch.from_numpy(mask)].amax(0)
    ex = torch.where(torch.from_numpy(mask)[:, None], torch.exp(scores - m), torch.zeros(()))
    want = torch.zeros(N, H).index_add_(0, torch.from_numpy(dst).long(), ex).clamp_min(1e-16)
    assert den.dtype == torch.float32 and out.shape == (N, H, D)
    assert _rel(den.numpy(), want.numpy()) < 1e-6


# ------------------------------------------------------- force backward (K5a)
# dtp_lin_bwd3_plain (dx, dsh and dw from the cotangent of the fused output)
# against autograd of dtp_lin_plain and against jax.vjp of the higher-order
# Pallas op in interpret mode, whose transpose binds _bwd3_kernel when two
# or more edge operands carry tangents.
BWD3_CASES = {**BWD_CASES, "l3": ([LIN_OUT + "+2x3e"], False, False)}
E_BWD3, N_REAL_BWD3 = 64, 50


def _bwd3_inputs(case, dtype, E=70, seed=4):
    heads, shared, broadcast = BWD3_CASES[case]
    irr, sh_irr = (IRR + "+2x3e", SH + "+1x3e") if case == "l3" else (IRR, SH)
    plan = DTPLinPlan(depthwise_tp(Irreps(irr), Irreps(sh_irr), Irreps(irr)), heads,
                      shared_weights=shared)
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    w = None if shared else rnd(E, plan.d_w)
    return plan, x, rnd(E, plan.d_sh), w, rnd(plan.w_numel), rnd(E, plan.d_out)


@pytest.mark.parametrize("case", list(BWD3_CASES))
def test_dtp_lin_bwd3_plain_matches_autograd_fp64(case):
    """dx, dsh and dw of the written-out force backward equal torch autograd
    of dtp_lin_plain (the folded-weight form for the shared case) to 1e-12
    relative; rows past n_edges get zeros."""
    from equiformer_tpu_torch.kernels import dtp_lin_bwd3_plain

    plan, x, sh, w, W, g = _bwd3_inputs(case, torch.float64)
    n = torch.tensor(61, dtype=torch.int32)
    ins = [t.clone().requires_grad_() for t in (x, sh) + (() if w is None else (w,))]
    out = dtp_lin_plain(plan, ins[0], ins[1], None if w is None else ins[2], W, n)
    ref = torch.autograd.grad(out, ins, g)
    dx, dsh, dw = dtp_lin_bwd3_plain(plan, x, sh, w, W, g, n)
    assert (dw is None) == (w is None)
    for got, want in zip((dx, dsh, dw), ref):
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), want.numpy()) < 1e-12
    assert float(dx[61:].abs().max()) == 0.0 and float(dsh[61:].abs().max()) == 0.0


@pytest.mark.parametrize("case", [pytest.param("two-head", marks=pytest.mark.slow), "shared-w"])
def test_dtp_lin_bwd3_plain_matches_pallas_interpret_vjp(case):
    """jax.vjp of make_fused_dtp_lin_ho in interpret mode (its _bwd3_kernel
    for the grouped x / sh / w tangents) against the port's op on the CPU,
    dx / dsh / dw within 1e-5 relative in fp32 on the real rows.  One TPU
    edge tile (64 in fp32); interpret mode still takes ~20 s for three
    tangents, so the per-edge case is in the slow tier."""
    import jax
    from equiformer_tpu.kernels.dtp_lin_ho import make_fused_dtp_lin_ho
    from equiformer_tpu_torch.kernels import dtp_lin_ho

    heads, shared, x, sh, w, head_ws = _dtp_case(case, np.float32, seed=6, E=E_BWD3)
    jplan = JPlan(j_dtp(JIrreps(IRR), JIrreps(SH), JIrreps(IRR)), [JIrreps(h) for h in heads],
                  fold_rescale=not shared, shared_weights=shared, needs_dsh=True)
    fused = make_fused_dtp_lin_ho(jplan, tile=128, interpret=True)
    Ws = jplan.pack_weights([[None if a is None else jnp.asarray(a) for a in ws]
                             for ws in head_ws])
    if shared:  # the shared w is a constant: tangents on x and sh only
        out, vjp = jax.vjp(lambda x, s: fused(x, s, jnp.asarray(w), Ws, n_edges=N_REAL_BWD3),
                           jnp.asarray(x), jnp.asarray(sh))
    else:
        out, vjp = jax.vjp(lambda x, s, w: fused(x, s, w, Ws, n_edges=N_REAL_BWD3),
                           jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w))
    g = np.random.default_rng(7).normal(size=out.shape).astype(np.float32)
    g[N_REAL_BWD3:] = 0.0
    jgrads = vjp(jnp.asarray(g))

    tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    plan = DTPLinPlan(tp, heads, shared_weights=shared)
    W = plan.pack_weights([[None if a is None else torch.from_numpy(a) for a in ws]
                           for ws in head_ws])
    ins = [torch.from_numpy(a).requires_grad_() for a in ((x, sh) if shared else (x, sh, w))]
    tw = torch.from_numpy(w) if shared else ins[2]
    dtp_lin_ho(plan, ins[0], ins[1], tw, W, torch.tensor(N_REAL_BWD3, dtype=torch.int32)) \
        .backward(torch.from_numpy(g))
    for t, j in zip(ins, jgrads):
        assert _rel(t.grad.numpy(), j, rows=N_REAL_BWD3) < 1e-5


def _emulate_bwd3_kernel(plan, x, sh, w, W_flat, g, n_edges, tile=16, warps=8):
    """csrc/dtp_lin_bwd3.cu's loop over ``bwd3_tables``, in torch, one edge
    tile at a time: the staged cotangent, dz through the packed W^T, then
    per row (warp) the terms in table order, with the running dsh sum added
    to the row at each SH column change, and the per-group dw flush."""
    from equiformer_tpu_torch.kernels.dtp_lin_ho import bwd3_tables

    gk, terms, coeffs, dwmap, wt_index, span_max, _ = bwd3_tables(plan, torch.device("cpu"))
    gk, terms, coeffs, dwmap = gk.tolist(), terms.tolist(), coeffs.tolist(), dwmap.tolist()
    WT = torch.cat([W_flat, W_flat.new_zeros(1)])[wt_index]
    E = x.shape[0]
    dx = torch.zeros(E, plan.d_x, dtype=x.dtype)
    dsh = torch.zeros(E, plan.d_sh, dtype=x.dtype)
    dw = None if w is None else torch.zeros(E, plan.d_w, dtype=x.dtype)
    for e0 in range(0, min(E, n_edges), tile):
        n_live = min(tile, n_edges - e0)
        dxs = torch.zeros(n_live, plan.d_x, dtype=x.dtype)
        dshs = torch.zeros(n_live, plan.d_sh, dtype=x.dtype)
        dws = torch.zeros(n_live, max(span_max, 1), dtype=x.dtype)
        for fs, cols, out_col, _, tb, te, wt_off, cp, sb, sn, first, last in gk:
            if first:
                dws.zero_()
            gt = torch.zeros(n_live, cp, dtype=x.dtype)
            gt[:, :cols] = g[e0 : e0 + n_live, out_col : out_col + cols]
            dz = gt @ WT[wt_off : wt_off + cp * fs].reshape(cp, fs)
            for r0 in range(warps):
                for r in range(r0, n_live, warps):
                    e, run, cur = e0 + r, 0.0, -1
                    for (a, col, b, fc, mul, bl), c in zip(terms[tb:te], coeffs[tb:te]):
                        if col != cur:
                            if cur >= 0:
                                dshs[r, cur] += run
                            run, cur = 0.0, col
                        d = dz[r, fc : fc + mul]
                        xv = x[e, a : a + mul]
                        wv = 1.0 if w is None else w[e, b : b + mul]
                        dxs[r, a : a + mul] += c * sh[e, col] * wv * d
                        if w is not None:
                            dws[r, bl : bl + mul] += c * sh[e, col] * xv * d
                        run = run + float(torch.sum(c * xv * wv * d))
                    if cur >= 0:
                        dshs[r, cur] += run
            if w is not None and last:
                dw[e0 : e0 + n_live, dwmap[sb : sb + sn]] = dws[:, :sn]
        dx[e0 : e0 + n_live] = dxs
        dsh[e0 : e0 + n_live] = dshs
    return dx, dsh, dw


@pytest.mark.parametrize("case", ["two-head", "shared-w", "broadcast-x", "dead-w-cols", "l3"])
def test_dtp_lin_bwd3_tables_drive_the_plain_math(case):
    """The CUDA force backward cannot run here; its tables can.  Walking
    them the way the kernel does gives dtp_lin_bwd3_plain's dx, dsh and dw
    (fp64 inputs, the tables' fp32 CG coefficients: 1e-6 relative)."""
    from equiformer_tpu_torch.kernels import dtp_lin_bwd3_plain

    plan, x, sh, w, W, g = _bwd3_inputs(case, torch.float64, E=40, seed=5)
    want = dtp_lin_bwd3_plain(plan, x, sh, w, W, g, torch.tensor(37, dtype=torch.int32))
    got = _emulate_bwd3_kernel(plan, x, sh, w, W, g, 37)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a.numpy(), b.numpy()) < 1e-6


# --------------------------------- single legs (K5b, K5c) and the grad-of-grad
# The fused op is multilinear in its legs (out, x, sh, w, W).  Each leg's
# plain version is the VJP of the JAX composition (tp.apply + the heads'
# linears, fp64) with respect to that leg; the autograd family of
# dtp_lin_ho is held to jax.grad of a scalar of (out, dx, dsh, dw).
# case -> n_edges: one head with every row real, two heads and the shared
# (folded) weights with an n_edges that cuts rows off
LEG_CASES = {"per-edge": 256, "two-head-cut": 200, "shared-w-cut": 200}
LEG_TOL = 1e-9


def _jax_heads(heads, shared, n_real):
    """The JAX composition as a function of jnp operands: per-head outputs
    with the rows at or past ``n_real`` zeroed, as the port's op gives them."""
    tp = j_dtp(JIrreps(IRR), JIrreps(SH), JIrreps(IRR))
    slices = tp.irreps_out.slices()
    rows = (jnp.arange(E) < n_real)[:, None]

    def f(x, sh, w, head_ws):
        z = tp.apply(x, sh, w, scale_weights=not shared)
        outs = []
        for h, ws in zip(heads, head_ws):
            pieces = []
            for oi, (mul_out, ir_out) in enumerate(JIrreps(h)):
                blocks = [z[:, slices[i]].reshape(E, ir.dim, m)
                          for i, (m, ir) in enumerate(tp.irreps_out) if ir == ir_out]
                o = jnp.einsum("eiu,uw->eiw", jnp.concatenate(blocks, axis=-1), ws[oi])
                pieces.append(o.reshape(E, -1))
            outs.append(jnp.where(rows, jnp.concatenate(pieces, axis=-1), 0.0))
        return outs

    return f


def _leg_case(case, seed):
    """fp64 operands of one case in both packages, and cotangents for every
    leg: (heads, shared, n_real, numpy operands, torch plan, torch leaves)."""
    name = case.removesuffix("-cut")
    heads, shared, x, sh, w, head_ws = _dtp_case(name, np.float64, seed=seed)
    plan = DTPLinPlan(depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR)), heads,
                      shared_weights=shared)
    rng = np.random.default_rng(seed + 100)
    cots = {"heads": [rng.normal(size=(E, Irreps(h).dim)) for h in heads],
            "x": rng.normal(size=x.shape), "sh": rng.normal(size=sh.shape),
            "w": rng.normal(size=w.shape)}
    return heads, shared, LEG_CASES[case], (x, sh, w, head_ws), plan, cots


def _torch_leaves(x, sh, w, head_ws):
    leaf = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    return leaf(x), leaf(sh), leaf(w), [[None if a is None else leaf(a) for a in ws]
                                        for ws in head_ws]


def _flat_cot(plan, head_cots):
    """The heads' cotangents in the fused flat output's layout."""
    probe = torch.zeros(E, plan.d_out, dtype=torch.float64, requires_grad=True)
    return torch.autograd.grad(plan.split_output(probe), probe,
                               [torch.from_numpy(c) for c in head_cots])[0]


@pytest.mark.parametrize("case", list(LEG_CASES))
def test_dtp_lin_leg_plains_match_jax_vjps(case):
    """F_x, F_sh, F_w (dtp_lin_leg_plain, each without its own operand) and
    F_W (dtp_lin_legW_plain, carried from the packed layout back to the
    heads' weights) against jax.vjp of the JAX composition with respect to
    that leg, fp64, within 1e-9 of the largest value; one and two heads,
    per-edge and shared (folded) weights, and an n_edges that cuts rows off."""
    import jax
    from equiformer_tpu_torch.kernels import dtp_lin_leg_plain, dtp_lin_legW_plain
    from equiformer_tpu_torch.kernels.dtp_lin import fold_shared_weights

    heads, shared, n_real, (x, sh, w, head_ws), plan, cots = _leg_case(case, seed=11)
    jws = [[None if a is None else jnp.asarray(a) for a in ws] for ws in head_ws]
    _, vjp = jax.vjp(_jax_heads(heads, shared, n_real), jnp.asarray(x), jnp.asarray(sh),
                     jnp.asarray(w), jws)
    jdx, jdsh, jdw, jdws = vjp([jnp.asarray(c) for c in cots["heads"]])

    tx, tsh, tw, tws = _torch_leaves(x, sh, w, head_ws)
    W = plan.pack_weights(tws)
    fw, fW = fold_shared_weights(plan, tw, W)  # (None, folded W) when shared
    g = _flat_cot(plan, cots["heads"])
    n = torch.tensor(n_real, dtype=torch.int32)
    with torch.no_grad():
        dx = dtp_lin_leg_plain(plan, "x", g, None, tsh, fw, fW, n)
        dsh = dtp_lin_leg_plain(plan, "sh", g, tx, None, fw, fW, n)
        dW = dtp_lin_legW_plain(plan, g, tx, tsh, fw, n)
    assert dW.dtype == torch.float64 and dW.shape == (plan.w_numel,)
    assert _rel(dx.numpy(), jdx) < LEG_TOL and _rel(dsh.numpy(), jdsh) < LEG_TOL
    assert float(dx[n_real:].abs().sum()) == 0.0 and float(dsh[n_real:].abs().sum()) == 0.0
    leaves = [t for ws in tws for t in ws if t is not None]
    if shared:  # the fold carries the folded dW back to the heads' weights and the shared w
        got = torch.autograd.grad(fW, leaves + [tw], dW)
        assert _rel(got[-1].numpy(), jdw) < LEG_TOL
        with pytest.raises(ValueError):
            dtp_lin_leg_plain(plan, "w", g, tx, tsh, None, fW, n)
    else:
        got = torch.autograd.grad(W, leaves, dW)
        with torch.no_grad():
            dw = dtp_lin_leg_plain(plan, "w", g, tx, tsh, None, W, n)
        assert _rel(dw.numpy(), jdw) < LEG_TOL
    want = [a for ws in jdws for a in ws if a is not None]
    assert len(want) == len(leaves)
    for t, j in zip(got, want):
        assert _rel(t.numpy(), j) < LEG_TOL


@pytest.mark.parametrize("case", list(LEG_CASES))
def test_dtp_lin_ho_grad_of_grad_matches_jax(case):
    """A scalar of (out, dx, dsh, dw), the gradients taken with
    create_graph=True as a force pass takes them, differentiated with respect
    to x, sh, w and every head weight (the shared w through the fold),
    against jax.grad of the same scalar of the JAX composition: fp64, 1e-9."""
    import jax
    from equiformer_tpu_torch.kernels import dtp_lin_ho

    heads, shared, n_real, (x, sh, w, head_ws), plan, cots = _leg_case(case, seed=12)
    f = _jax_heads(heads, shared, n_real)
    jc = {k: ([jnp.asarray(c) for c in v] if k == "heads" else jnp.asarray(v))
          for k, v in cots.items()}

    def j_scalar(x, sh, w, hws):
        def first(x, sh, w):
            return sum(jnp.vdot(o, c) for o, c in zip(f(x, sh, w, hws), jc["heads"]))

        val, (dx, dsh, dw) = jax.value_and_grad(first, (0, 1, 2))(x, sh, w)
        return val + jnp.vdot(dx, jc["x"]) + jnp.vdot(dsh, jc["sh"]) + jnp.vdot(dw, jc["w"])

    jws = [[None if a is None else jnp.asarray(a) for a in ws] for ws in head_ws]
    jval, jgrads = jax.value_and_grad(j_scalar, (0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w), jws)

    tx, tsh, tw, tws = _torch_leaves(x, sh, w, head_ws)
    out = dtp_lin_ho(plan, tx, tsh, tw, plan.pack_weights(tws),
                     torch.tensor(n_real, dtype=torch.int32))
    first = sum((o * torch.from_numpy(c)).sum()
                for o, c in zip(plan.split_output(out), cots["heads"]))
    dx, dsh, dw = torch.autograd.grad(first, (tx, tsh, tw), create_graph=True)
    val = first + sum((d * torch.from_numpy(cots[k])).sum()
                      for d, k in ((dx, "x"), (dsh, "sh"), (dw, "w")))
    leaves = [t for ws in tws for t in ws if t is not None]
    grads = torch.autograd.grad(val, [tx, tsh, tw] + leaves)
    assert abs(float(val) - float(jval)) < LEG_TOL * abs(float(jval))
    want = list(jgrads[:3]) + [a for ws in jgrads[3] for a in ws if a is not None]
    assert len(want) == len(grads)
    for t, j in zip(grads, want):
        assert _rel(t.numpy(), j) < LEG_TOL


@pytest.mark.parametrize("case", ["two-head", "shared-w", "broadcast-x"])
def test_dtp_lin_ho_gradgradcheck(case):
    """torch.autograd's own numeric check of the family's first and second
    derivatives at a tiny size (fp64; 2x0e+1x1e features, SH to l=1, 3 edges,
    2 of them real)."""
    from equiformer_tpu_torch.kernels import dtp_lin_ho

    irr = Irreps("2x0e+1x1e")
    heads = ["3x0e+1x1e", "2x0e"] if case == "two-head" else ["3x0e+1x1e"]
    shared = case == "shared-w"
    plan = DTPLinPlan(depthwise_tp(irr, Irreps("1x0e+1x1e"), irr), heads, shared_weights=shared)
    E, n = 3, torch.tensor(2, dtype=torch.int32)
    g = torch.Generator().manual_seed(8)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).requires_grad_()  # noqa: E731
    # the row-broadcast x of the edge-degree site; the shared [d_w] vector,
    # folded inside dtp_lin_ho
    x = rnd(1, plan.d_x) if case == "broadcast-x" else rnd(E, plan.d_x)
    ins = [x, rnd(E, plan.d_sh), rnd(plan.d_w) if shared else rnd(E, plan.d_w),
           rnd(plan.w_numel)]
    f = lambda x, sh, w, W: dtp_lin_ho(plan, x.expand(E, plan.d_x), sh, w, W, n)  # noqa: E731
    assert torch.autograd.gradcheck(f, ins)
    assert torch.autograd.gradgradcheck(f, ins)


def test_dtp_lin_ho_backward_runs_only_the_legs_asked_for(monkeypatch):
    """needs_input_grad and skip_leg_grads decide which leg kernels a
    backward calls: two or more edge legs take one K5a, a single one its
    K5b leg, the head weights K5c unless the pass skips them; an output of
    K5a that nobody used arrives as None and costs no leg."""
    import importlib

    ho = importlib.import_module("equiformer_tpu_torch.kernels.dtp_lin_ho")
    calls = []
    for name in ("dtp_lin_bwd3", "dtp_lin_leg", "dtp_lin_legW", "dtp_lin_fwd"):
        def counting(*a, _f=getattr(ho, name), _n=name, **k):
            calls.append(_n + (":" + a[1] if _n == "dtp_lin_leg" else ""))
            return _f(*a, **k)
        monkeypatch.setattr(ho, name, counting)

    plan, x, sh, w, W, g = _bwd3_inputs("per-edge", torch.float64, E=8)
    leaf = lambda t: t.clone().requires_grad_()  # noqa: E731
    x, sh, w, W, g = leaf(x), leaf(sh), leaf(w), leaf(W), leaf(g)

    def backward_calls(fn):
        del calls[:]
        fn()
        return sorted(calls)

    out = ho.dtp_lin_ho(plan, x.detach(), sh, w.detach(), W.detach())
    assert backward_calls(lambda: torch.autograd.grad(out, sh, g)) == ["dtp_lin_leg:sh"]
    out = ho.dtp_lin_ho(plan, x, sh, w, W)
    assert backward_calls(lambda: torch.autograd.grad(out, (x, sh, w, W), g)) \
        == ["dtp_lin_bwd3", "dtp_lin_legW"]
    out = ho.dtp_lin_ho(plan, x, sh, w, W)
    del calls[:]
    with ho.skip_leg_grads("W"):
        dsh, dw = torch.autograd.grad(out, (sh, w), g, create_graph=True)
    assert calls == ["dtp_lin_bwd3"]
    # dx was computed but never used: its cotangent is None in the second
    # pass, which walks the K5a node (for dsh: out, x, w, W legs; for dw:
    # out, x, W) and then the forward node (x and w by one K5a, W); "sh" is
    # skipped in both
    with ho.skip_leg_grads("sh"):
        got = backward_calls(lambda: torch.autograd.grad(
            out.sum() + dsh.sum() + dw.sum(), (g, x, w, W)))
    assert got == sorted(["dtp_lin_fwd"] * 2 + ["dtp_lin_leg:x"] * 2 + ["dtp_lin_leg:w"]
                         + ["dtp_lin_legW"] * 2 + ["dtp_lin_bwd3", "dtp_lin_legW"])
    assert not ho._SKIPPED_LEGS


def _emulate_leg_kernel(plan, leg, x, sh, w, W_flat, g, n_edges, tile=16, warps=8):
    """csrc/dtp_lin_leg.cu's loop over ``bwd3_tables`` for one leg, in torch,
    one edge tile at a time: the staged slice of g, dz through the packed
    W^T, then per row (warp) the terms in table order.  The leg's own operand
    is never read (the caller passes None for it); the sh leg adds its
    running sum to the row at each SH column change; the w leg flushes a
    group's columns through ``dwmap`` at its last component."""
    from equiformer_tpu_torch.kernels.dtp_lin_ho import bwd3_tables

    gk, terms, coeffs, dwmap, wt_index, span_max, _ = bwd3_tables(plan, torch.device("cpu"))
    gk, terms, coeffs, dwmap = gk.tolist(), terms.tolist(), coeffs.tolist(), dwmap.tolist()
    WT = torch.cat([W_flat, W_flat.new_zeros(1)])[wt_index]
    E = g.shape[0]
    width = {"x": plan.d_x, "sh": plan.d_sh, "w": plan.d_w}[leg]
    out = torch.zeros(E, width, dtype=g.dtype)
    for e0 in range(0, min(E, n_edges), tile):
        n_live = min(tile, n_edges - e0)
        acc = torch.zeros(n_live, max(span_max, 1) if leg == "w" else width, dtype=g.dtype)
        for fs, cols, out_col, _, tb, te, wt_off, cp, sb, sn, first, last in gk:
            if leg == "w" and first:
                acc.zero_()
            gt = torch.zeros(n_live, cp, dtype=g.dtype)
            gt[:, :cols] = g[e0 : e0 + n_live, out_col : out_col + cols]
            dz = gt @ WT[wt_off : wt_off + cp * fs].reshape(cp, fs)
            for r0 in range(warps):
                for r in range(r0, n_live, warps):
                    e, run, cur = e0 + r, 0.0, -1
                    for (a, col, b, fc, mul, bl), c in zip(terms[tb:te], coeffs[tb:te]):
                        d = dz[r, fc : fc + mul]
                        if leg == "sh":
                            if col != cur:
                                if cur >= 0:
                                    acc[r, cur] += run
                                run, cur = 0.0, col
                            wv = 1.0 if w is None else w[e, b : b + mul]
                            run = run + float(torch.sum(c * x[e, a : a + mul] * wv * d))
                        elif leg == "x":
                            wv = 1.0 if w is None else w[e, b : b + mul]
                            acc[r, a : a + mul] += c * sh[e, col] * wv * d
                        else:
                            acc[r, bl : bl + mul] += c * sh[e, col] * x[e, a : a + mul] * d
                    if leg == "sh" and cur >= 0:
                        acc[r, cur] += run
            if leg == "w" and last:
                out[e0 : e0 + n_live, dwmap[sb : sb + sn]] = acc[:, :sn]
        if leg != "w":
            out[e0 : e0 + n_live] = acc
    return out


def _emulate_legW_kernel(plan, x, sh, w, g, n_edges, n_parts, tile=16):
    """csrc/dtp_lin_legW.cu's loop over ``plan.bwd_tables``, in torch: block
    b walks the tiles b, b + n_parts, ..., skips those past n_edges, stages
    the slice of g, recomputes z from the term table and adds z^T g into its
    own partial row; the rows are then summed in block order."""
    gk, terms, coeffs, *_ = plan.bwd_tables(torch.device("cpu"))
    gk, terms, coeffs = gk.tolist(), terms.tolist(), coeffs.tolist()
    E = g.shape[0]
    n_tiles = -(-E // tile)
    part = torch.zeros(n_parts, plan.w_numel, dtype=g.dtype)
    for blk in range(n_parts):
        for t in range(blk, n_tiles, n_parts):
            e0 = t * tile
            n_live = max(0, min(tile, E - e0, n_edges - e0))
            if n_live == 0:
                continue
            rows = slice(e0, e0 + n_live)
            for fs, cols, out_col, w_off, tb, te, *_ in gk:
                z = torch.zeros(n_live, fs, dtype=g.dtype)
                for (a, col, b, fc, mul, _), c in zip(terms[tb:te], coeffs[tb:te]):
                    v = c * sh[rows, col : col + 1] * x[rows, a : a + mul]
                    z[:, fc : fc + mul] += v if w is None else v * w[rows, b : b + mul]
                part[blk, w_off : w_off + fs * cols] += \
                    (z.T @ g[rows, out_col : out_col + cols]).reshape(-1)
    dW = torch.zeros(plan.w_numel, dtype=g.dtype)
    for blk in range(n_parts):
        dW += part[blk]
    return dW


@pytest.mark.parametrize("case", ["two-head", "shared-w", "broadcast-x", "dead-w-cols", "l3"])
def test_dtp_lin_leg_tables_drive_the_plain_math(case):
    """The CUDA leg kernels cannot run here; their tables can.  Walking them
    the way csrc/dtp_lin_leg.cu (each edge leg, without its own operand) and
    csrc/dtp_lin_legW.cu (with fewer blocks than tiles, so a block walks
    several) do gives the plain versions' results (fp64 inputs, the tables'
    fp32 CG coefficients: 1e-6 relative)."""
    from equiformer_tpu_torch.kernels import dtp_lin_leg_plain, dtp_lin_legW_plain

    plan, x, sh, w, W, g = _bwd3_inputs(case, torch.float64, E=40, seed=6)
    n = torch.tensor(37, dtype=torch.int32)
    for leg in ("x", "sh") + (() if w is None else ("w",)):
        ops = {"x": x, "sh": sh, "w": w, leg: None}
        want = dtp_lin_leg_plain(plan, leg, g, ops["x"], ops["sh"], ops["w"], W, n)
        got = _emulate_leg_kernel(plan, leg, ops["x"], ops["sh"], ops["w"], W, g, 37)
        assert got.shape == want.shape
        assert _rel(got.numpy(), want.numpy()) < 1e-6, leg
    want = dtp_lin_legW_plain(plan, g, x, sh, w, n)
    got = _emulate_legW_kernel(plan, x, sh, w, g, 37, n_parts=2)
    assert _rel(got.numpy(), want.numpy()) < 1e-6


def test_dtp_lin_ho_on_the_cpu_launches_no_kernel():
    """CPU tensors take the plain versions at every order: no launch count
    moves through a forward, a force-style backward and its grad-of-grad."""
    from equiformer_tpu_torch.kernels import dtp_lin_ho, launch_counts

    plan, x, sh, w, W, g = _bwd3_inputs("per-edge", torch.float32)
    sh, W = sh.requires_grad_(), W.requires_grad_()
    reset_launch_counts()
    (dsh,) = torch.autograd.grad(dtp_lin_ho(plan, x, sh, w, W), sh, g, create_graph=True)
    (dW,) = torch.autograd.grad(dsh.square().sum(), W)
    assert dsh.shape == sh.shape and dW.shape == W.shape
    assert set(launch_counts().values()) == {0}
