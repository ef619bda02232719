"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those against the TPU kernels run in Pallas interpret mode (fp32) and
against the JAX einsum composition (fp64).  The TPU DTP kernel zeroes whole
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
    csr_segment_sum,
    dtp_lin,
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


def _dtp_case(case, npdt, seed=0):
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
    assert (dtp_lin.launches, csr_segment_sum.launches, attn_combine.launches) == (0, 0, 0)
