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
