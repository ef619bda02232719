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

import functools

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
    attn_combine_plain,
    attn_den_plain,
    csr_segment_sum,
    dtp_lin,
    dtp_lin_bwd_plain,
    dtp_lin_fwd,
    dtp_lin_plain,
    reset_launch_counts,
    segment_sum_plain,
)
from equiformer_tpu_torch.kernels.attn_csr import NEG, _shift  # noqa: E402
from equiformer_tpu_torch.kernels.dtp_lin import (  # noqa: E402
    K1_MIN_WAVES,
    K1_TILES,
    K1_TWO_BLOCKS_SMEM,
    K2_COL_TILE,
    K2_EDGES,
    K2_FAN_TILE,
    fold_gather,
    k1_smem_bytes,
    k7_wr_tiles,
    k1_tile,
    k2_ranges,
    plan_terms,
)

IRR = "8x0e+4x1e+2x2e"
SH = "1x0e+1x1e+1x2e"
LIN_OUT = "14x0e+4x1e+2x2e"
ALPHA_OUT = "6x0e"
L2_EMB = "128x0e+64x1e+32x2e"  # the QM9 flagship's node irreps
L3_EMB, L3_SH = "128x0e+64x1e+64x2e+32x3e", "1x0e+1x1e+1x2e+1x3e"  # MD17 L3's
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


def _csr_md17_case(case):
    """K3's inputs at the MD17 path's shapes (E = 2944 dst-sorted edges, N =
    168 nodes, C = 864 columns: the node width every K3 call of the force
    path sums) and at its edge cases, as the radius graph lays them out:
    live edges first, the padding edges masked on the last node."""
    rng = np.random.default_rng(7)
    E, N, C = {"E=0": (0, 5, 128), "N=1": (40, 1, 136)}.get(case, (2944, 168, 864))
    dst = np.sort(rng.integers(0, max(N - 1, 1), size=E)).astype(np.int32)
    mask = np.ones(E, bool)
    if case == "empty-segments":
        dst = np.where(dst % 5 == 2, dst - 1, dst)  # nodes 2, 7, 12, ... get no edge
    if case == "all-masked-segment":
        mask[dst == 40] = False
    if E:
        dst[-150:] = N - 1  # the padding tail
        mask[-150:] = False
    val = rng.normal(size=(E, C)).astype(np.float32)
    return val, dst, mask, N


@pytest.mark.parametrize("case", ["md17", "empty-segments", "all-masked-segment", "E=0", "N=1"])
def test_csr_segment_sum_plain_matches_pallas_interpret_at_md17_shapes(case):
    """K3's plain contract (the CPU path of ``csr_segment_sum``) against JAX's
    ``csr_segment_sum`` in interpret mode at the MD17 shapes and their edge
    cases: empty segments and an all-masked one sum to zero, the padding
    edges on the last node add nothing, E = 0 gives zeros (the Pallas call
    takes no empty operand: its definition, a sum over no edges, is the
    reference there), N = 1 one row.  fp32, 1e-5 of max |value|."""
    val, dst, mask, N = _csr_md17_case(case)
    t = csr_segment_sum(torch.from_numpy(val), torch.from_numpy(dst).long(), N,
                        torch.from_numpy(mask)).numpy()
    assert t.shape == (N, val.shape[1])
    if case == "E=0":
        assert not t.any()
        return
    j = np.asarray(j_csr(jnp.asarray(val), jnp.asarray(dst), N, mask=jnp.asarray(mask),
                         interpret=True))
    assert _rel(t, j) < 1e-5
    if case == "empty-segments":
        assert not t[2::5].any()
    if case == "all-masked-segment":
        assert not t[40].any()
    if N > 1:
        assert not t[N - 1].any()


def _emulate_csr_walk(dst, mask, N, run_sum, width, warps=16):
    """csrc/csr_walk.cuh's block walk in torch (fp64, all columns at once):
    per block of ``nodes_per_block`` nodes, the edge range by search, cut
    into ``warps`` equal slices; per slice its node runs, whole nodes
    written, the pieces of nodes cut by slice boundaries kept and added, in
    slice order, by the slice where the node starts; the zero rows of nodes
    without edges.  ``run_sum(edges)`` gives the [width] sums of one run's
    live edges.  Returns (each node's sums, how often each row was
    written)."""
    from equiformer_tpu_torch.kernels.segment_csr import nodes_per_block

    E, dl = dst.shape[0], dst.tolist()
    live = torch.ones(E, dtype=torch.bool) if mask is None else mask
    out = torch.full((N, width), float("nan"), dtype=torch.float64)
    writes = [0] * N

    def put(m, row):
        out[m] = row
        writes[m] += 1

    npb = nodes_per_block(N, E)
    for n0 in range(0, N, npb):
        n1 = min(N, n0 + npb)
        lo, hi = int(np.searchsorted(dl, n0)), int(np.searchsorted(dl, n1))
        if lo == hi:
            for m in range(n0, n1):
                put(m, 0.0)
            continue
        length = -(-(hi - lo) // warps)
        meta, part = [], []
        for w in range(warps):
            sb = min(hi, lo + w * length)
            se = min(hi, sb + length)
            if sb >= se:
                meta.append((-1, -1, False, False))
                part.append([None, None])
                continue
            first, last = dl[sb], dl[se - 1]
            prev = dl[sb - 1] if sb > lo else n0 - 1
            cb, ca = prev == first, se < hi and dl[se] == last
            slots = [None, None]
            for m in range(prev + 1, first):
                put(m, 0.0)
            e = sb
            while e < se:
                node = dl[e]
                re = e
                while re < se and dl[re] == node:
                    re += 1
                rows = torch.arange(e, re)
                ssum = run_sum(rows[live[rows]])
                if node == first and cb:
                    slots[0] = ssum
                elif re == se and ca:
                    slots[1] = ssum
                else:
                    put(node, ssum)
                if re < se:
                    for m in range(node + 1, dl[re]):
                        put(m, 0.0)
                e = re
            if se == hi:
                for m in range(last + 1, n1):
                    put(m, 0.0)
            meta.append((first, last, cb, ca))
            part.append(slots)
        for w, (first, last, cb, ca) in enumerate(meta):
            if ca and not (cb and first == last):
                ssum = part[w][1].clone()
                for w2 in range(w + 1, warps):
                    ssum += part[w2][0]
                    if not (meta[w2][3] and meta[w2][1] == last):
                        break
                put(last, ssum)
    return out, writes


def _emulate_k3(val, dst, mask, N, warps=16):
    """csrc/segment_csr.cu: the shared walk summing val's live rows."""
    return _emulate_csr_walk(dst, mask, N, lambda e: val[e].sum(0), val.shape[1], warps)


@pytest.mark.parametrize("case", ["qm9-padded", "md17-gather", "few-edges", "one-long", "E=0"])
def test_csr_block_walk_sums_each_node_once(case):
    """K3's block and slice walk, emulated: every output row is written
    exactly once (whole by its slice, or by the slice where a node cut by
    slice boundaries starts) and the rows equal the plain sum in fp64, with
    a 3464-edge padding node, empty nodes and masked edges."""
    rng = np.random.default_rng(8)
    E, N, n_real = {"qm9-padded": (4000, 420, 3500), "md17-gather": (2944, 168, 2800),
                    "few-edges": (30, 200, 30), "one-long": (3464, 3, 3000),
                    "E=0": (0, 7, 0)}[case]
    dst = np.sort(rng.integers(0, max(N - 1, 1), size=n_real))
    dst = np.concatenate([dst[dst % 9 != 4], np.full(E, N - 1)])[:E]  # nodes without edges
    dst = torch.from_numpy(np.sort(dst)).long()
    mask = None if case == "md17-gather" else torch.from_numpy(rng.random(E) > 0.1)
    val = torch.from_numpy(rng.normal(size=(E, 6)))
    got, writes = _emulate_k3(val, dst, mask, N)
    assert writes == [1] * N
    want = segment_sum_plain(val, dst, N, mask)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def _emulate_k4(scores, value, dropmul, dst, mask, N):
    """csrc/attn_csr.cu in torch (fp64): the shared walk over the live
    edges (masked ones skipped by the mask), each run's numerators ex * drop
    * v and denominator ex per head, ex = exp(s - m) with the wrapper's
    global shift; then out = num / max(den, 1e-16).  Returns (out, den, how
    often each row was written)."""
    E, H, D = value.shape
    ex = torch.exp(scores - _shift(scores))
    p = ex if dropmul is None else ex * dropmul

    def run_sum(e):
        return torch.cat([(p[e][:, :, None] * value[e]).sum(0).reshape(-1), ex[e].sum(0)])

    sums, writes = _emulate_csr_walk(dst, mask, N, run_sum, H * D + H)
    den = torch.clamp(sums[:, H * D:], min=1e-16)
    return sums[:, : H * D].reshape(N, H, D) / den[:, :, None], den, writes


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("case", ["qm9-padded", "all-masked-node", "no-mask", "few-edges", "E=0"])
def test_attn_block_walk_combines_each_node_once(case, dropout):
    """K4's walk, emulated: masked edges skipped by the mask, long segments
    (the 3464-edge masked padding node) split over warp slices, every row of
    out and den written once, equal to ``attn_combine_plain`` and
    ``attn_den_plain`` in fp64; an all-masked node and nodes without edges
    get out = 0 and den = 1e-16."""
    rng = np.random.default_rng(9)
    E, N, n_real = {"qm9-padded": (4000, 420, 536), "all-masked-node": (600, 40, 600),
                    "no-mask": (4000, 420, 536), "few-edges": (30, 200, 30),
                    "E=0": (0, 7, 0)}[case]
    dst = np.sort(rng.integers(0, max(N - 1, 1), size=n_real))
    dst = np.concatenate([dst[dst % 9 != 4], np.full(E, N - 1)])[:E]  # nodes without edges
    dst = torch.from_numpy(np.sort(dst)).long()
    mask = torch.from_numpy(rng.random(E) > 0.1) & (dst < N - 1)  # the padding node: masked
    if case == "all-masked-node":
        mask &= dst != 20
    H, D = 4, 6
    scores = torch.from_numpy(2.0 * rng.normal(size=(E, H)))
    value = torch.from_numpy(rng.normal(size=(E, H, D)))
    drop = torch.from_numpy((rng.random((E, H)) < 0.8) / 0.8) if dropout else None
    if case == "no-mask":
        mask = None
    masked = scores if mask is None else torch.where(mask[:, None], scores,
                                                     torch.full_like(scores, NEG))
    out, den, writes = _emulate_k4(masked, value, drop, dst, mask, N)
    assert writes == [1] * N
    # without edges the plain softmax has no max to take: every node is empty
    want = (torch.zeros_like(out) if E == 0
            else attn_combine_plain(scores, value, dst, N, mask, drop))
    assert torch.allclose(out, want, rtol=1e-12, atol=1e-12)
    assert torch.allclose(den, attn_den_plain(masked, dst, N), rtol=1e-12, atol=1e-30)
    if case == "all-masked-node":
        assert float(out[20].abs().max()) == 0.0 and bool((den[20] == 1e-16).all())


@pytest.mark.parametrize("N, E, npb", [
    (3840, 36352, 28),  # QM9: ~9.5 edges a node
    (168, 2944, 15),  # MD17: ~17.5
    (1, 40, 1),
    (5, 0, 5),  # no edges: one block
    (100, 10, 100),
])
def test_csr_nodes_per_block(N, E, npb):
    """K3's block covers about 256 edges at the batch's mean degree, at
    least one node and at most all of them."""
    from equiformer_tpu_torch.kernels.segment_csr import nodes_per_block

    assert nodes_per_block(N, E) == npb


@pytest.mark.parametrize("C, itemsize, ptrs, vec", [
    (480, 4, (0, 256), 4),
    (864, 2, (1024, 4096), 8),
    (161, 4, (0, 0), 1),  # a tail of C: rows not 16-byte aligned
    (480, 4, (4, 0), 1),  # an unaligned val
    (480, 2, (0, 8), 1),  # an unaligned out
    (132, 2, (0, 0), 1),  # 264-byte rows
    (136, 2, (0, 0), 8),
])
def test_csr_vector_width(C, itemsize, ptrs, vec):
    """K3 loads 16 bytes a lane only where every row starts on a 16-byte
    boundary; otherwise one scalar column a lane."""
    from equiformer_tpu_torch.kernels.segment_csr import vector_width

    assert vector_width(C, itemsize, *ptrs) == vec


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


def _unpack_k2(packed, fan_stride, cols):
    """W_g [fan8, cols16] from one group's values in mma fragment order, by
    the fragment layout itself (lane (g, q) holds W_g[8 nt + g, 16 ks + 2q
    + (0, 1, 8, 9)]), not by ``k2_pack_index``."""
    n_nt, n_ks = -(-fan_stride // 8), -(-cols // 16)
    nt, ks, lane, v = torch.meshgrid(torch.arange(n_nt), torch.arange(n_ks), torch.arange(32),
                                     torch.arange(4), indexing="ij")
    out = packed.new_zeros(8 * n_nt, 16 * n_ks)
    out[8 * nt + lane // 4, 16 * ks + 2 * (lane % 4) + torch.tensor([0, 1, 8, 9])[v]] = \
        packed.reshape(n_nt, n_ks, 32, 4)
    return out


def _group_rows(gk, n_split, s):
    """The gk rows of the irrep groups of split ``s`` of ``n_split``
    (csrc/dtp_lin_bwd.cu, k2::group_rows): groups [s n / n_split, (s + 1) n
    / n_split) of the plan's n, a group's rows consecutive, its first
    flagged."""
    bounds = [q for q, r in enumerate(gk) if r[10]] + [len(gk)]
    n = len(bounds) - 1
    return range(bounds[s * n // n_split], bounds[(s + 1) * n // n_split])


def _butterfly_sum(v):
    """What lane 0 holds after a fixed xor butterfly over the last dim
    (``s += __shfl_xor_sync(s, o)`` for o = width / 2, ..., 1)."""
    o = v.shape[-1] // 2
    while o:
        v = v + v[..., torch.arange(v.shape[-1]) ^ o]
        o //= 2
    return v[..., 0]


def _k2_dsh_slots(terms, coeffs, x, w, dz, n_live):
    """The dsh slots [n_live, terms] of one (group, component) as the dsh
    legs' term pass on K2's launch 1 writes them (csrc/dtp_lin_bwd.cu), a
    slot a term and row: a mul that is a multiple of 32 a row a warp (lane l
    sums its u = l, l + 32, ... in order, then ``_butterfly_sum`` over the
    32 lanes), a power of two below 32 on K2's threads row * mul + u (a
    butterfly over the row's mul lanes), any other mul one thread a row in
    order.  ``x`` and ``w`` are the tile's rows (w None: 1), ``dz`` [rows,
    fan]."""
    slots = torch.zeros(n_live, len(terms), dtype=dz.dtype)
    for t, ((a, col, b, fc, mul, bl), c) in enumerate(zip(terms, coeffs)):
        wv = 1.0 if w is None else w[:, bl : bl + mul]
        vals = c * x[:n_live, a : a + mul] * wv * dz[:n_live, fc : fc + mul]
        if mul % 32 == 0:
            lanes = torch.zeros(n_live, 32, dtype=dz.dtype)
            for k in range(mul // 32):
                lanes = lanes + vals[:, 32 * k : 32 * (k + 1)]
            slots[:, t] = _butterfly_sum(lanes)
        elif mul & (mul - 1) == 0:
            slots[:, t] = _butterfly_sum(vals)
        else:
            s = torch.zeros(n_live, dtype=dz.dtype)
            for u in range(mul):
                s = s + vals[:, u]
            slots[:, t] = s
    return slots


def _k7_packs(plan, Wrs):
    """The radial fold's operands as K7-B reads them: Wl = [Wr; offset] in
    the tables' local column order [hd + 1, n_loc], and per gk row that
    starts a group the group's two packings of ``plan.k7_tables`` unpacked
    by the fragment layout (``_unpack_k2``), each as Wr_g [hd, span]: the w
    build's B (K = hd, N = span) and dh's (K = span, N = hd)."""
    cpu = torch.device("cpu")
    hd = plan.radial_fold
    Wl = Wrs[:, plan.radial_cols(cpu)]
    kr = plan.k7_tables(cpu)
    pk = torch.cat([Wl.reshape(-1), Wl.new_zeros(1)])[kr.index]
    packs = {}
    for q, row in enumerate(plan.k2_tables(cpu).gk.tolist()):
        if row[10]:
            sn, (ob, od) = row[9], kr.rgk[q].tolist()
            nb = -(-sn // 8) * 8 * -(-hd // 16) * 16
            nd = -(-hd // 8) * 8 * -(-sn // 16) * 16
            packs[q] = (_unpack_k2(pk[ob : ob + nb], sn, hd)[:sn, :hd].T,
                        _unpack_k2(pk[od : od + nd], hd, sn)[:hd, :sn])
    return Wl, packs


def _emulate_k2_launch1(plan, x, sh, w, W_flat, g, n_edges, tile=16, leg=None, n_split=1,
                        need=("x", "sh", "w"), fold=None):
    """csrc/dtp_lin_bwd.cu's launch 1 (k2::dxdw_kernel) over
    ``plan.k2_tables``, in torch: per 16-edge tile the staged x / w span /
    G (padded to the K step), dz through the packed W (unpacked by the
    fragment layout), the term transposes and the per-group dw flush through
    ``dwmap``; tiles past ``n_edges`` write zeros.  ``leg`` "x", "w" or
    "sh": one edge leg as K5b runs it on the same code (k2::edge_leg_kernel,
    k2::sh_leg_kernel), dx alone without reading x, dw alone without reading
    w, or dsh alone without reading sh (pass None); "bwd3": K5a
    (k2::bwd3_kernel), the outputs named in ``need``.  Each tile's block is
    cut by irrep group into ``n_split``: the dw of the splits lands in
    disjoint columns, their fp32 dx and dsh partials are summed in split
    order.  dsh in the kernel's order: each term's slots per row
    (``_k2_dsh_slots``), then per (row, column) the column's slots in term
    order, per (group, component).  ``fold``: K7-B's launch 1
    (k2::rad_dxdw_kernel) on (h, [Wr; offset]) with ``w`` None: per tile
    the group's w built at its first component from the w packing, rounded
    to h's dtype (the offset from [Wr; offset]'s last row); at its last dw
    flushed through ``dwmap`` to the workspace (rows past ``n_edges`` left
    unwritten, NaN here) and dh += dw Wr_g^T from the dh packing, the span's
    K steps in two halves added in turn.  ``fold`` with "bwd3": K7-B3
    (k2::rad_bwd3_kernel), K5a with w built so and, with "h" in ``need``,
    dw kept in the tile (never written) and added into dh so, dh's split
    partials summed in split order as dx's.  Returns (dx, dw), the leg's
    output, K5a's (dx, dsh, dw) or K7-B3's (dx, dsh, dh) with None for what
    ``need`` leaves out, or K7-B's (dx, dw, dh)."""
    _, terms, coeffs, dwmap, _, span_max, _ = plan.bwd_tables(torch.device("cpu"))
    kt = plan.k2_tables(torch.device("cpu"))
    terms, coeffs, dwmap = terms.tolist(), coeffs.tolist(), dwmap.tolist()
    gk = kt.gk.tolist()
    Wp = torch.cat([W_flat, W_flat.new_zeros(1)])[kt.wp_index]
    E = g.shape[0]
    b3_fold = leg == "bwd3" and fold is not None  # K7-B3: dw on chip, dh for "h"
    if leg == "bwd3":
        want_dx, want_dsh = "x" in need, "sh" in need
        want_dw = "h" in need if b3_fold else "w" in need and w is not None
    else:
        want_dx, want_dsh = leg in (None, "x"), leg == "sh"
        want_dw = leg == "w" or (leg is None and (w is not None or fold is not None))
    nan = lambda d: torch.full((E, d), float("nan"), dtype=g.dtype)  # noqa: E731
    dh = None
    if fold is not None:
        h, hd = fold[0], plan.radial_fold
        Wl, packs = _k7_packs(plan, fold[1])
        dh = nan(hd) if want_dw else None
    dx = nan(plan.d_x) if want_dx else None
    dsh = nan(plan.d_sh) if want_dsh else None
    dw = nan(plan.d_w) if want_dw and not b3_fold else None
    if want_dw and plan.dw_has_dead_cols and fold is None:
        dw.zero_()  # the wrapper's zeros: dead columns are never written
    for e0 in range(0, E, tile):
        n_rows, n_live = min(tile, E - e0), max(0, min(tile, E - e0, n_edges - e0))
        rows = slice(e0, e0 + n_live)
        if n_live == 0:
            for out in (dx, dsh) + ((dh,) if fold is not None else (dw,)):
                if out is not None:
                    out[e0 : e0 + n_rows] = 0.0
            continue
        parts, parts_sh, parts_dh = [], [], []
        for s in range(n_split):
            s_dx = torch.zeros(tile, plan.d_x, dtype=g.dtype)
            s_dsh = torch.zeros(tile, plan.d_sh, dtype=g.dtype)
            if fold is not None:
                s_dh = torch.zeros(tile, hd, dtype=g.dtype)
            for q in _group_rows(gk, n_split, s):
                fs, cols, out_col, w_off, tb, te, wp_off, cp, sb, sn, first, last = gk[q]
                if first:
                    s_dw = torch.zeros(tile, max(span_max, 1), dtype=g.dtype)
                    s_w = None if w is None else w[rows][:, dwmap[sb : sb + sn]]
                    if fold is not None:
                        pw, pd = packs[q]
                        s_w = (h[rows] @ pw + Wl[hd, sb : sb + sn]).to(h.dtype)
                s_g = torch.zeros(tile, cp, dtype=g.dtype)
                s_g[:n_live, :cols] = g[rows, out_col : out_col + cols]
                n_packed = -(-fs // 8) * 8 * cp
                dz = s_g @ _unpack_k2(Wp[wp_off : wp_off + n_packed], fs, cols).T
                for (a, col, b, fc, mul, bl), c in zip(terms[tb:te], coeffs[tb:te]):
                    dzt = dz[:n_live, fc : fc + mul]
                    wv = 1.0 if s_w is None else s_w[:, bl : bl + mul]
                    if want_dx or want_dw:
                        d = c * sh[rows, col : col + 1] * dzt
                        if want_dx:
                            s_dx[:n_live, a : a + mul] += d * wv
                        if want_dw:
                            s_dw[:n_live, bl : bl + mul] += d * x[rows, a : a + mul]
                if want_dsh:  # the slots, then per (row, column) its terms' slots in order
                    slots = _k2_dsh_slots(terms[tb:te], coeffs[tb:te], x[rows], s_w, dz,
                                          n_live)
                    for col in range(plan.d_sh):
                        for j, t in enumerate(terms[tb:te]):
                            if t[1] == col:
                                s_dsh[:n_live, col] += slots[:, j]
                if want_dw and last:
                    if not b3_fold:
                        dw[e0 : e0 + n_rows, dwmap[sb : sb + sn]] = s_dw[:n_rows, :sn]
                    if fold is not None:  # the span's K steps in two halves, added in turn
                        cut = min(sn, 16 * (-(-sn // 16) // 2))
                        s_dh += s_dw[:, :cut] @ pd[:, :cut].T
                        s_dh += s_dw[:, cut:sn] @ pd[:, cut:].T
            parts.append(s_dx)
            parts_sh.append(s_dsh)
            if fold is not None:
                parts_dh.append(s_dh)
        for out, ps in ((dx, parts), (dsh, parts_sh), (dh, parts_dh)):
            if out is not None:
                acc = ps[0]
                for part in ps[1:]:
                    acc = acc + part
                out[e0 : e0 + n_rows] = acc[:n_rows]
    if b3_fold:
        return dx, dsh, dh
    if fold is not None:
        return dx, dw, dh
    if leg == "bwd3":
        return dx, dsh, dw
    return {"x": dx, "w": dw, "sh": dsh}[leg] if leg else (dx, dw)


def _k7_wr_partials(plan, h, dw, n_edges, ones, range_len, step=K2_EDGES):
    """The d[Wr; offset] tiles of csrc/dtp_lin_bwd.cu (k2::dWr_body: K7-B's
    launch 2 and K7-Wr's k2::Wr_leg_kernel) in torch: tile (64 rows of hd,
    128 local columns) and edge range of ``range_len`` (whole steps of
    ``step`` edges, K2_EDGES in the kernel), stopped at ``n_edges``; per
    step h's slice and dw's (read through ``dwmap`` from the workspace [E,
    d_w]) staged with zero rows past the real edges, their product added to
    the accumulator, and on the tiles of hd's first rows the offset row,
    ``ones`` x dw's column sums in edge order.  Each range writes its
    partial row once.  Returns (the partial rows [n_ranges, (hd + 1) n_loc],
    how often each element was written)."""
    dwmap = plan.bwd_tables(torch.device("cpu"))[3].tolist()
    hd, n_loc, E = plan.radial_fold, len(plan.radial_cols(torch.device("cpu"))), h.shape[0]
    n_ranges, n_ct = -(-E // range_len), -(-n_loc // K2_COL_TILE)
    part = torch.zeros(n_ranges, (hd + 1) * n_loc, dtype=h.dtype)
    writes = torch.zeros(n_ranges, (hd + 1) * n_loc, dtype=torch.int64)
    for ri in range(n_ranges):
        rb = ri * range_len
        re = min(E, rb + range_len, n_edges)
        pr, wr = part[ri].view(hd + 1, n_loc), writes[ri].view(hd + 1, n_loc)
        for t in range(k7_wr_tiles(hd, n_loc)):
            j0, c0 = (t // n_ct) * K2_FAN_TILE, (t % n_ct) * K2_COL_TILE
            fm, fn = min(K2_FAN_TILE, hd - j0), min(K2_COL_TILE, n_loc - c0)
            acc = torch.zeros(K2_FAN_TILE, K2_COL_TILE, dtype=h.dtype)
            dsum = torch.zeros(K2_COL_TILE, dtype=h.dtype)
            for e0 in range(rb, re, step):
                n = min(step, re - e0)
                hs = torch.zeros(step, K2_FAN_TILE, dtype=h.dtype)
                hs[:n, :fm] = h[e0 : e0 + n, j0 : j0 + fm]
                ds = torch.zeros(step, K2_COL_TILE, dtype=h.dtype)
                ds[:n, :fn] = dw[e0 : e0 + n][:, dwmap[c0 : c0 + fn]]
                acc += hs.T @ ds
                for r in range(n):
                    dsum += ds[r]
            pr[j0 : j0 + fm, c0 : c0 + fn] = acc[:fm, :fn]
            wr[j0 : j0 + fm, c0 : c0 + fn] += 1
            if j0 == 0:
                pr[hd, c0 : c0 + fn] = float(ones) * dsum[:fn]
                wr[hd, c0 : c0 + fn] += 1
    return part, writes


def _sum_rows(part):
    """eqt::sum_partial_rows: the rows added in row order."""
    out = part[0].clone()
    for row in part[1:]:
        out += row
    return out


def _k7_dWrs(plan, red):
    """d[Wr; offset] [hd + 1, d_w] from its local-order rows (the wrappers'
    scatter through ``radial_cols``; dead columns 0)."""
    hd, cols = plan.radial_fold, plan.radial_cols(torch.device("cpu"))
    out = red.new_zeros(hd + 1, plan.d_w)
    out[:, cols] = red.view(hd + 1, len(cols))
    return out


def _emulate_k2_launch2(plan, x, sh, w, g, n_edges, sm_count=3, fold=None):
    """csrc/dtp_lin_bwd.cu's launch 2 (k2::dW_kernel) over
    ``plan.k2_tables`` and ``k2_ranges``, in torch: block (tile, range)
    recomputes z's fan slice per step of K2_EDGES and component from the terms
    that reach it, adds z^T G into its accumulator and writes its partial
    once, to its range's row.  ``fold`` (h, [Wr; offset], launch 1's dw
    workspace), with ``w`` None: K7-B's launch 2 (k2::rad_dW_kernel), each
    step's w fan slice rebuilt from h through the w packing and rounded to
    h's dtype (zero past the group's span), and the d[Wr; offset] tiles
    (``_k7_wr_partials``) in the same grid and rows, after dW; with the
    workspace None, K7-LW (k2::rad_W_leg_kernel): the w-rebuilding dW tiles
    alone.  Returns (the partial rows, how often each element was
    written)."""
    _, terms, coeffs, _, _, _, _ = plan.bwd_tables(torch.device("cpu"))
    kt = plan.k2_tables(torch.device("cpu"))
    terms, coeffs, gk = terms.tolist(), coeffs.tolist(), kt.gk.tolist()
    E = x.shape[0]
    n_tiles, width = kt.tiles.shape[0], plan.w_numel
    wr_tiles = fold is not None and fold[2] is not None  # K7-B: the d[Wr; offset] tiles too
    if fold is not None:
        h, hd = fold[0], plan.radial_fold
        Wl, packs = _k7_packs(plan, fold[1])
    if wr_tiles:
        n_tiles += k7_wr_tiles(hd, Wl.shape[1])
        width += (hd + 1) * Wl.shape[1]
    n_ranges, range_len = k2_ranges(E, n_tiles, sm_count)
    part = torch.zeros(n_ranges, width, dtype=x.dtype)
    writes = torch.zeros(n_ranges, width, dtype=torch.int64)
    if wr_tiles:
        part[:, plan.w_numel :], writes[:, plan.w_numel :] = _k7_wr_partials(
            plan, h, fold[2], n_edges, True, range_len)
    for ri in range(n_ranges):
        rb = ri * range_len
        re = min(E, rb + range_len, n_edges)
        for q0, n_comp, f0, fm, j0, fn in kt.tiles.tolist():
            cols, w_off = gk[q0][1], gk[q0][3]
            acc = torch.zeros(K2_FAN_TILE, K2_COL_TILE, dtype=x.dtype)
            for e0 in range(rb, re, K2_EDGES):
                live = slice(e0, min(re, e0 + K2_EDGES))
                if fold is not None:  # w's fan slice of this step
                    sb, sn = gk[q0][8], gk[q0][9]
                    m = max(0, min(fm, sn - f0))
                    ws = torch.zeros(K2_EDGES, K2_FAN_TILE, dtype=x.dtype)
                    ws[: live.stop - e0, :m] = (h[live] @ packs[q0][0][:, f0 : f0 + m]
                                                + Wl[hd, sb + f0 : sb + f0 + m]).to(h.dtype)
                for k in range(n_comp):
                    out_col, tb, te = gk[q0 + k][2], gk[q0 + k][4], gk[q0 + k][5]
                    z = torch.zeros(K2_EDGES, K2_FAN_TILE, dtype=x.dtype)
                    n = live.stop - live.start
                    for (a, col, b, fc, mul, _), c in zip(terms[tb:te], coeffs[tb:te]):
                        lo, hi = max(fc, f0), min(fc + mul, f0 + fm)
                        if lo >= hi:
                            continue
                        u = slice(lo - fc, hi - fc)
                        v = c * sh[live, col : col + 1] * x[live, a + u.start : a + u.stop]
                        if fold is not None:
                            v = v * ws[: live.stop - e0, lo - f0 : hi - f0]
                        elif w is not None:
                            v = v * w[live, b + u.start : b + u.stop]
                        z[:n, lo - f0 : hi - f0] += v
                    gs = torch.zeros(K2_EDGES, K2_COL_TILE, dtype=x.dtype)
                    gs[:n, :fn] = g[live, out_col + j0 : out_col + j0 + fn]
                    acc += z.T @ gs
            f = torch.arange(fm)[:, None]
            j = torch.arange(fn)[None, :]
            idx = (w_off + (f0 + f) * cols + j0 + j).reshape(-1)
            part[ri, idx] = acc[:fm, :fn].reshape(-1)
            writes[ri, idx] += 1
    return part, writes


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_dtp_lin_bwd_tables_drive_the_plain_math(case):
    """The CUDA backward cannot run here; its tables can.  Walking them the
    way its two launches do (dx / dw per 16-edge tile through the packed W;
    dW per tile and edge range, the ranges' partial rows summed in order)
    gives dtp_lin_bwd_plain's gradients (fp64 inputs, the tables' fp32 CG
    coefficients: 1e-6 relative)."""
    plan, x, sh, w, W, g = _bwd_inputs(case, torch.float64, seed=5)
    want = dtp_lin_bwd_plain(plan, x, sh, w, W, g, torch.tensor(53, dtype=torch.int32))
    dx, dw = _emulate_k2_launch1(plan, x, sh, w, W, g, 53)
    part, _ = _emulate_k2_launch2(plan, x, sh, w, g, 53)
    dW = part[0].clone()
    for row in part[1:]:
        dW += row
    for a, b in zip((dx, dw, dW), want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a.numpy(), b.numpy()) < 1e-6


@pytest.mark.parametrize("sm_count", [1, 3, 40])
@pytest.mark.parametrize("case", ["two-head", "shared-w", "broadcast-x", "md17-sep_act",
                                  "md17-sep_value", "md17-edge_deg"])
def test_k2_dW_tiles_cover_each_element_once_per_range(case, sm_count):
    """K2's dW decomposition, which K5c shares: every element of W_flat is
    written exactly once in each edge range's partial row (so the scratch
    needs no zeroing), ranges are whole steps of K2_EDGES covering all rows,
    and the rows summed in range order give the plain dW (fp64 inputs, the
    tables' fp32 CG coefficients: 1e-6 relative; rows past n_edges add
    nothing); at small widths and at MD17 exp_l3's three sites."""
    if case.startswith("md17"):
        plan, x, sh, w, W, g = _md17_inputs(case, 150, seed=6)
    else:
        plan, x, sh, w, W, g = _bwd_inputs(case, torch.float64, E=150, seed=6)
    kt = plan.k2_tables(torch.device("cpu"))
    n_ranges, range_len = k2_ranges(150, kt.tiles.shape[0], sm_count)
    assert range_len % K2_EDGES == 0 and (n_ranges - 1) * range_len < 150 <= n_ranges * range_len
    part, writes = _emulate_k2_launch2(plan, x, sh, w, g, 131, sm_count)
    assert bool((writes == 1).all())
    dW = part[0] + sum(part[1:]) if n_ranges > 1 else part[0]
    want = dtp_lin_bwd_plain(plan, x, sh, w, W, g, torch.tensor(131, dtype=torch.int32))[2]
    assert _rel(dW.numpy(), want.numpy()) < 1e-6


@pytest.mark.parametrize("site", ["sep_act", "sep_value", "edge_deg", "small", "dead-w-cols"])
def test_k2_packed_W_unpacks_to_each_group(site):
    """K2's packing of W for the dz product (``k2_pack_index``, fragment
    order) unpacks, by the mma fragment layout, to each group's W_g with
    zero pad rows and columns; every element of W_flat is used once."""
    emb = Irreps("128x0e+64x1e+32x2e")
    if site in ("small", "dead-w-cols"):
        tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
        plan = DTPLinPlan(tp, [LIN_OUT] if site == "small" else ["5x0e+3x1e"])
    else:  # the QM9 flagship's sites (the edge degree's x is a broadcast row)
        tp = depthwise_tp(emb, Irreps(SH), emb)
        heads = {"sep_act": ["224x0e+64x1e+32x2e", "128x0e"]}.get(site, [str(emb)])
        plan = DTPLinPlan(tp, heads, shared_weights=site == "sep_value")
    W = torch.arange(1, plan.w_numel + 1, dtype=torch.float64)
    kt = plan.k2_tables(torch.device("cpu"))
    Wp = torch.cat([W, W.new_zeros(1)])[kt.wp_index]
    gk = kt.gk.tolist()
    used = torch.zeros(plan.w_numel + 1, dtype=torch.int64)
    used.index_add_(0, kt.wp_index, torch.ones_like(kt.wp_index))
    assert bool((used[:-1] <= 1).all())
    row = 0
    for gi, grp in enumerate(plan.groups):
        wp_off, cp = gk[row][6], gk[row][7]
        assert cp % 16 == 0 and cp - 16 < grp.cols <= cp
        n_packed = -(-grp.fan_stride // 8) * 8 * cp
        got = _unpack_k2(Wp[wp_off : wp_off + n_packed], grp.fan_stride, grp.cols)
        want = torch.zeros_like(got)
        want[: grp.fan, : grp.cols] = plan.group_weight(W, gi)[: grp.fan]
        assert torch.equal(got, want)
        assert bool((used[grp.w_off : grp.w_off + grp.fan * grp.cols] == 1).all())
        row += grp.ir.dim
    assert kt.wp_index.numel() == sum(-(-g.fan_stride // 8) * 8 * -(-g.cols // 16) * 16
                                      for g in plan.groups)


# the fused DTP's sites at full width, and a small one: (node irreps, SH,
# heads, shared weights)
K1_SITES = {
    "qm9-sep_act": (L2_EMB, SH, ["224x0e+64x1e+32x2e", "128x0e"], False),
    "qm9-sep_value": (L2_EMB, SH, [L2_EMB], True),
    "qm9-edge_deg": (L2_EMB, SH, [L2_EMB], False),
    "md17-sep_act": (L3_EMB, L3_SH, ["288x0e+64x1e+64x2e+32x3e", "128x0e"], False),
    "small": (IRR, SH, [LIN_OUT, ALPHA_OUT], False),
}


def _k1_plan(site):
    irr, sh, heads, shared = K1_SITES[site]
    return DTPLinPlan(depthwise_tp(Irreps(irr), Irreps(sh), Irreps(irr)), heads,
                      shared_weights=shared)


def _unpack_k1(packed, fan, cols):
    """W_g [fan16, cols8] from one group's values in B-fragment order, by
    the fragment layout itself (lane (g, q) holds W_g[16 ks + 2q + (0, 1, 8,
    9), 8 nt + g]), not by ``k1_pack_index``."""
    n_nt, n_ks = -(-cols // 8), -(-fan // 16)
    packed = packed.reshape(n_nt, n_ks, 32, 4)
    out = packed.new_zeros(16 * n_ks, 8 * n_nt)
    for lane in range(32):
        gq, q = divmod(lane, 4)
        for v, df in enumerate((0, 1, 8, 9)):
            for nt in range(n_nt):
                out[16 * np.arange(n_ks) + 2 * q + df, 8 * nt + gq] = packed[nt, :, lane, v]
    return out


@pytest.mark.parametrize("site", list(K1_SITES))
def test_k1_packed_W_unpacks_to_each_group(site):
    """K1's packing of W for the head product (``k1_pack_index``, B-fragment
    order) unpacks, by the fragment layout, to each group's W_g with zero
    pad rows and columns; every element of W_flat is used once."""
    plan = _k1_plan(site)
    W = torch.arange(1, plan.w_numel + 1, dtype=torch.float64)
    kt = plan.k1_tables(torch.device("cpu"))
    Wp = torch.cat([W, W.new_zeros(1)])[kt.wp_index]
    gk = kt.gk.tolist()
    used = torch.zeros(plan.w_numel + 1, dtype=torch.int64)
    used.index_add_(0, kt.wp_index, torch.ones_like(kt.wp_index))
    assert bool((used[:-1] <= 1).all())
    for gi, (grp, (row, n_comp)) in enumerate(zip(plan.groups, kt.groups.tolist())):
        assert n_comp == grp.ir.dim
        f16, cols, _, wp_off, _, _, n_nt, fan = gk[row]
        assert (fan, cols, n_nt) == (grp.fan, grp.cols, -(-grp.cols // 8))
        assert f16 % 16 == 0 and f16 - 16 < fan <= f16 <= kt.fz_max
        got = _unpack_k1(Wp[wp_off : wp_off + f16 * 8 * n_nt], fan, cols)
        want = torch.zeros_like(got)
        want[:fan, :cols] = plan.group_weight(W, gi)[:fan]
        assert torch.equal(got, want)
        assert bool((used[grp.w_off : grp.w_off + grp.fan * grp.cols] == 1).all())
    assert kt.wp_index.numel() == sum(-(-g.fan // 16) * 16 * -(-g.cols // 8) * 8
                                      for g in plan.groups)


def _k1_fragment_product(Wp, z, cols, kind):
    """out = z W_g as K1's warps compute it, in fp64: per m-tile of 16 rows,
    K step of 16 fan columns and column n-tile, each lane's A registers
    loaded from z and its B registers from the packed W as the kernel loads
    them, placed into the tiles by the PTX fragment layouts (``bf16``:
    m16n8k16; ``tf32``: two m16n8k8 halves), multiplied, and each lane's C
    registers stored where the kernel stores them."""
    T, f16 = z.shape
    n_ks, n_nt = f16 // 16, -(-cols // 8)
    P = Wp.reshape(n_nt, n_ks, 32, 4)
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    out = np.zeros((T, 8 * n_nt))
    for m in range(T // 16):
        zr = z[16 * m : 16 * m + 16]
        c = np.zeros((n_nt, 32, 4))
        for ks in range(n_ks):
            c0 = 16 * ks + 2 * q
            if kind == "bf16":  # a[0..3]: pairs at (g, c0), (g + 8, c0), (g, c0 + 8), (g + 8, c0 + 8)
                A = np.zeros((16, 16))
                B = np.zeros((n_nt, 16, 8))
                for dr, dc, reg in ((0, 0, 0), (8, 0, 1), (0, 8, 2), (8, 8, 3)):
                    # PTX: a0 = A[g][2q, 2q+1], a1 = A[g+8][..], a2 = A[g][2q+8, 2q+9], a3 = A[g+8][..]
                    A[g + dr, 2 * q + dc] = zr[g + dr, c0 + dc]
                    A[g + dr, 2 * q + dc + 1] = zr[g + dr, c0 + dc + 1]
                for v, dk in enumerate((0, 1, 8, 9)):  # b0 = B[2q, 2q+1][g], b1 = B[2q+8, 2q+9][g]
                    B[:, 2 * q + dk, g] = P[:, ks, lane, v]
                C = A @ B
            else:  # half s: a = (g, c0 + 8s), (g + 8, c0 + 8s), (g, c0 + 8s + 1), (g + 8, ..)
                C = 0.0
                for s in (0, 1):
                    A = np.zeros((16, 8))
                    B = np.zeros((n_nt, 8, 8))
                    # PTX m16n8k8 tf32: a0 = A[g][q], a1 = A[g+8][q], a2 = A[g][q+4],
                    # a3 = A[g+8][q+4]; b0 = B[q][g], b1 = B[q+4][g]
                    A[g, q], A[g + 8, q] = zr[g, c0 + 8 * s], zr[g + 8, c0 + 8 * s]
                    A[g, q + 4], A[g + 8, q + 4] = zr[g, c0 + 8 * s + 1], zr[g + 8, c0 + 8 * s + 1]
                    B[:, q, g], B[:, q + 4, g] = P[:, ks, lane, 2 * s], P[:, ks, lane, 2 * s + 1]
                    C = C + A @ B
            # c0 = C[g][2q], c1 = C[g][2q+1], c2 = C[g+8][2q], c3 = C[g+8][2q+1]
            for reg, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
                c[:, lane, reg] += C[:, g + dr, 2 * q + dc]
        for nt in range(n_nt):
            for reg, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
                out[16 * m + g + dr, 8 * nt + 2 * q + dc] = c[nt, lane, reg]
    return out[:, :cols]


@pytest.mark.parametrize("kind", ["bf16", "tf32"])
@pytest.mark.parametrize("site", list(K1_SITES))
def test_k1_fragment_product_equals_z_W(site, kind):
    """A numpy emulation of K1's product in fragment order (K steps over the
    fan, n-tiles over the columns, both m-tiles of a 32-edge tile) equals z
    W_g in fp64 for every group."""
    plan = _k1_plan(site)
    rng = np.random.default_rng(10)
    W = torch.from_numpy(rng.normal(size=plan.w_numel))
    kt = plan.k1_tables(torch.device("cpu"))
    Wp = torch.cat([W, W.new_zeros(1)])[kt.wp_index].numpy()
    gk = kt.gk.tolist()
    for gi, (grp, (row, _)) in enumerate(zip(plan.groups, kt.groups.tolist())):
        f16, cols, _, wp_off, _, _, n_nt, fan = gk[row]
        z = np.zeros((32, f16))
        z[:, :fan] = rng.normal(size=(32, fan))  # the pad columns are zero, as in the kernel
        got = _k1_fragment_product(Wp[wp_off : wp_off + f16 * 8 * n_nt], z, cols, kind)
        want = z[:, :fan] @ plan.group_weight(W, gi)[:fan].numpy()
        assert np.allclose(got, want, rtol=1e-12, atol=1e-12)


def _emulate_k1(plan, x, sh, w, W_flat, n_edges, tile=32, fold=None, kron=None):
    """csrc/dtp_lin.cu's K1 in torch (fp64) from ``k1_tables``: per (edge
    tile, group) and component, z written run by run (each fan column once,
    rows past n_edges zero, the pad columns zero), then z times W_g unpacked
    from the packed W.  ``fold`` (h, [Wr; offset]): K7-F on
    ``k1_tables(fold=True)``, ``w`` None: W and [Wr; offset] packed by the
    wrapper's one gather (``fold_gather``), and per block its group's w
    built from h, the group's Wr unpacked by the fragment layout and its
    offsets, rounded to h's dtype; the runs read w at their column of that
    tile.  ``kron`` (the plan's KronMeta, ``W_flat`` its flat G): K1's block
    on K8-F's tables, ``kron.k1_tables`` in K1's layout, each (g, k) a group
    of one component whose z is its Kop, G packed by its ``gp_index``.
    Returns (out, how often each element was written)."""
    cpu = torch.device("cpu")
    if kron is not None:
        kt = kron.k1_tables(cpu)
        terms, coeffs, index = kt.terms, kt.coeffs, kt.gp_index
    else:
        kt = plan.k1_tables(cpu, fold=fold is not None)
        (terms, coeffs), index = plan.device_tables(cpu), kt.wp_index
    gk, runs, tt, cc = kt.gk.tolist(), kt.runs.tolist(), terms.tolist(), coeffs.tolist()
    if fold is None:
        Wp = torch.cat([W_flat, W_flat.new_zeros(1)])[index]
    else:
        h, hd = fold[0], plan.radial_fold
        Wp = fold_gather(plan, W_flat, fold[1], kt.wp_index)
        pk = Wp[kt.pk_base :]
    E = sh.shape[0]
    out = torch.full((E, plan.d_out), float("nan"), dtype=torch.float64)
    writes = torch.zeros((E, plan.d_out), dtype=torch.int64)
    groups = [(q, 1) for q in range(len(gk))] if kron is not None else kt.groups.tolist()
    for gi, (q0, n_comp) in enumerate(groups):
        if fold is not None:
            ob, oo, span = kt.rg[gi].tolist()
            n_b = -(-span // 8) * 8 * -(-hd // 16) * 16
            Wr_g = _unpack_k2(pk[ob : ob + n_b], span, hd)[:span, :hd].T
        for e0 in range(0, E, tile):
            n_rows = min(tile, E - e0)
            n_live = max(0, min(n_rows, n_edges - e0))
            live = slice(e0, e0 + n_live)
            if fold is not None:
                w_tile = (h[live] @ Wr_g + pk[oo : oo + span]).to(h.dtype)
            for k in range(n_comp):
                f16, cols, out_col, wp_off, rb, re, n_nt, fan = gk[q0 + k]
                z = torch.zeros((n_rows, f16), dtype=torch.float64)
                seen = torch.zeros(f16, dtype=torch.int64)
                for fc, mul, b, t0, t1 in runs[rb:re]:
                    acc = torch.zeros((n_live, mul), dtype=torch.float64)
                    for t in range(t0, t1):
                        a, col = tt[t][:2]
                        acc += cc[t] * sh[live, col : col + 1] * x[live, a : a + mul]
                    if fold is not None:
                        acc *= w_tile[:, b : b + mul]
                    elif w is not None:
                        acc *= w[live, b : b + mul]
                    z[:n_live, fc : fc + mul] = acc
                    seen[fc : fc + mul] += 1
                assert bool((seen[:fan] == 1).all()) and bool((seen[fan:] == 0).all())
                Wg = _unpack_k1(Wp[wp_off : wp_off + f16 * 8 * n_nt], fan, cols)
                out[e0 : e0 + n_rows, out_col : out_col + cols] = (z @ Wg)[:, :cols]
                writes[e0 : e0 + n_rows, out_col : out_col + cols] += 1
    return out, writes


@pytest.mark.parametrize("tile", [32, 16])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_k1_tables_drive_the_plain_math(case, tile):
    """K1 walked from its tables (``k1_tables``: runs of terms per fan
    block, the packed W) as the kernel walks them gives ``dtp_lin_plain``
    (fp64 inputs, the tables' fp32 CG coefficients: 1e-6 relative), every
    output element written once, rows past n_edges zero, with a partial last
    tile."""
    plan, x, sh, w, W, _ = _bwd_inputs(case, torch.float64, E=75, seed=7)
    got, writes = _emulate_k1(plan, x, sh, w, W, 61, tile)
    assert bool((writes == 1).all())
    want = dtp_lin_plain(plan, x, sh, w, W, torch.tensor(61, dtype=torch.int32))
    assert _rel(got.numpy(), want.numpy()) < 1e-6
    assert float(got[61:].abs().max()) == 0.0


@pytest.mark.parametrize("site, itemsize, E, tile", [
    ("qm9-sep_act", 4, 36352, 32), ("qm9-sep_act", 2, 36352, 16), ("md17-sep_act", 4, 2944, 16),
    ("md17-sep_act", 4, 36352, 16), ("md17-sep_act", 2, 2944, 16), ("qm9-sep_act", 4, 1013, 16),
])
def test_k1_tile_fits_two_blocks_and_fills_the_card(site, itemsize, E, tile):
    """K1's edge tile: 32 in fp32 where two blocks share an SM's shared
    memory and the grid fills the card's two blocks an SM ``K1_MIN_WAVES``
    times (132 SMs), else 16 (MD17 L3's 864-wide x tile in fp32, its 2944
    edges, bf16)."""
    plan = _k1_plan(site)
    assert k1_tile(plan, itemsize, True, E, 132) == tile
    assert k1_smem_bytes(plan, tile, itemsize, True) <= K1_TWO_BLOCKS_SMEM
    big = K1_TILES[0]
    assert (tile == big) == (itemsize == 4
                             and k1_smem_bytes(plan, big, itemsize, True) <= K1_TWO_BLOCKS_SMEM
                             and -(-E // big) * len(plan.groups) >= K1_MIN_WAVES * 2 * 132)


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


@pytest.mark.parametrize("case", ["two-head", "shared-w", "broadcast-x", "dead-w-cols", "l3"])
def test_dtp_lin_bwd3_tables_drive_the_plain_math(case):
    """The CUDA force backward cannot run here; its tables can.  Walking
    them the way K5a does on K2's launch 1 (k2::bwd3_kernel: every subset
    of its outputs, each tile whole and cut by irrep group) gives
    dtp_lin_bwd3_plain's dx, dsh and dw (fp64 inputs, the tables' fp32 CG
    coefficients: 1e-6 relative)."""
    from equiformer_tpu_torch.kernels import dtp_lin_bwd3_plain

    plan, x, sh, w, W, g = _bwd3_inputs(case, torch.float64, E=40, seed=5)
    want = dtp_lin_bwd3_plain(plan, x, sh, w, W, g, torch.tensor(37, dtype=torch.int32))
    for need in (("x", "sh", "w"), ("x", "sh"), ("sh", "w"), ("x", "w")):
        for n_split in (1, len(plan.groups)):
            got = _emulate_k2_launch1(plan, x, sh, w, W, g, 37, leg="bwd3", n_split=n_split,
                                      need=need)
            for leg, a, b in zip(("x", "sh", "w"), got, want):
                assert (a is None) == (b is None or leg not in need), (need, leg)
                if a is not None:
                    assert _rel(a.numpy(), b.numpy()) < 1e-6, (need, n_split, leg)
                    assert float(a[37:].abs().max()) == 0.0


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


def _k2_dW(plan, x, sh, w, g, n_edges, sm_count=3):
    """K5c (and K2's dW) as csrc/dtp_lin_bwd.cu's launch 2 computes it: the
    ranges' partial rows summed in range order."""
    return _sum_rows(_emulate_k2_launch2(plan, x, sh, w, g, n_edges, sm_count)[0])


def _emulate_k7b(plan, x, sh, h, Wrs, W_flat, g, n_edges, sm_count=3):
    """K7-B as its two launches and the row sum compute it (fold emulations
    of ``_emulate_k2_launch1`` and ``_emulate_k2_launch2``): (dx, dh, d[Wr;
    offset] [hd + 1, d_w], dW_flat), with how often launch 2 wrote each
    partial element."""
    dx, dw, dh = _emulate_k2_launch1(plan, x, sh, None, W_flat, g, n_edges, fold=(h, Wrs))
    part, writes = _emulate_k2_launch2(plan, x, sh, None, g, n_edges, sm_count,
                                       fold=(h, Wrs, dw))
    red = _sum_rows(part)
    return (dx, dh, _k7_dWrs(plan, red[plan.w_numel :]), red[: plan.w_numel]), writes


def _emulate_k7lw(plan, g, x, sh, h, Wrs, n_edges, sm_count=3):
    """K7-LW as it runs: K7-B's launch 2 without the d[Wr; offset] tiles
    (``_emulate_k2_launch2`` with no dw workspace) and the row sum: dW_flat,
    with how often each partial element was written."""
    part, writes = _emulate_k2_launch2(plan, x, sh, None, g, n_edges, sm_count,
                                       fold=(h, Wrs, None))
    return _sum_rows(part), writes


def _emulate_k7wr(plan, g, x, sh, h, W_flat, n_edges, ones=True, sm_count=3):
    """K7-Wr as it runs: K5b's w leg on K2's launch 1 cut by irrep group
    into the dw workspace, the d[Wr; offset] tiles over ``k2_ranges`` of
    their own count, the row sum: d[Wr; offset] [hd + 1, d_w]."""
    dw = _emulate_k2_launch1(plan, x, sh, None, W_flat, g, n_edges, leg="w",
                             n_split=len(plan.groups))
    n_loc = len(plan.radial_cols(torch.device("cpu")))
    _, range_len = k2_ranges(g.shape[0], k7_wr_tiles(plan.radial_fold, n_loc), sm_count)
    part, _ = _k7_wr_partials(plan, h, dw, n_edges, ones, range_len)
    return _k7_dWrs(plan, _sum_rows(part))


@pytest.mark.parametrize("case", ["two-head", "shared-w", "broadcast-x", "dead-w-cols", "l3"])
def test_dtp_lin_leg_tables_drive_the_plain_math(case):
    """The CUDA leg kernels cannot run here; their tables can.  Walking them
    the way K5b's x, w and sh legs run on K2's launch 1 (each without its own
    operand, each tile whole and cut by irrep group) and K5c on K2's launch
    2 (with fewer blocks than ranges' steps) gives the plain versions'
    results (fp64 inputs, the tables' fp32 CG coefficients: 1e-6
    relative)."""
    from equiformer_tpu_torch.kernels import dtp_lin_leg_plain, dtp_lin_legW_plain

    plan, x, sh, w, W, g = _bwd3_inputs(case, torch.float64, E=40, seed=6)
    n = torch.tensor(37, dtype=torch.int32)
    for leg in ("x",) + (() if w is None else ("w",)):
        ops = {"x": x, "sh": sh, "w": w, leg: None}
        want = dtp_lin_leg_plain(plan, leg, g, ops["x"], ops["sh"], ops["w"], W, n)
        for n_split in (1, len(plan.groups)):
            got = _emulate_k2_launch1(plan, ops["x"], ops["sh"], ops["w"], W, g, 37, leg=leg,
                                      n_split=n_split)
            assert got.shape == want.shape
            assert _rel(got.numpy(), want.numpy()) < 1e-6, (leg, n_split)
    want = dtp_lin_leg_plain(plan, "sh", g, x, None, w, W, n)
    for n_split in (1, len(plan.groups)):
        got = _emulate_k2_launch1(plan, x, None, w, W, g, 37, leg="sh", n_split=n_split)
        assert got.shape == want.shape and _rel(got.numpy(), want.numpy()) < 1e-6, n_split
    want = dtp_lin_legW_plain(plan, g, x, sh, w, n)
    assert _rel(_k2_dW(plan, x, sh, w, g, 37).numpy(), want.numpy()) < 1e-6


# MD17 exp_l3's three fused sites at full width: block 0's sep_act (two heads,
# per-edge w), sep_value (shared w folded into W) and the edge-degree
# embedding (a row-broadcast x): (heads, shared weights, broadcast x)
MD17_SITES = {
    "md17-sep_act": (["288x0e+64x1e+64x2e+32x3e", "128x0e"], False, False),
    "md17-sep_value": ([L3_EMB], True, False),
    "md17-edge_deg": ([L3_EMB], False, True),
}


@functools.lru_cache(maxsize=None)
def _md17_plan(site):
    heads, shared, _ = MD17_SITES[site]
    return DTPLinPlan(depthwise_tp(Irreps(L3_EMB), Irreps(L3_SH), Irreps(L3_EMB)), heads,
                      shared_weights=shared)


def _md17_inputs(site, E, seed):
    """fp64 operands of one MD17 site from a numpy seed: (plan, x (a
    row-broadcast view at the edge degree), sh, w or None, W, cotangent)."""
    plan, broadcast = _md17_plan(site), MD17_SITES[site][2]
    rng = np.random.default_rng(seed)
    rnd = lambda *s: torch.from_numpy(rng.normal(size=s))  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    w = None if plan.shared_weights else rnd(E, plan.d_w)
    return plan, x, rnd(E, plan.d_sh), w, rnd(plan.w_numel), rnd(E, plan.d_out)


@pytest.mark.parametrize("split", ["tile", "groups"])
@pytest.mark.parametrize("site,leg", [(s, leg) for s, (_, shared, _) in MD17_SITES.items()
                                      for leg in ("x",) + (() if shared else ("w",))])
def test_k5b_legs_walk_k2_launch1_at_md17_plans(site, leg, split):
    """K5b's x and w legs as K2's launch 1 runs them (k2::edge_leg_kernel),
    at MD17 exp_l3's full-width plans, 37 edges of which 29 real (a partial
    last tile and a tile past the real edges), each tile's block whole or cut
    by irrep group, None in the leg's own slot: the plain leg within 1e-6
    (fp64 inputs, the tables' fp32 CG coefficients); rows past n_edges 0."""
    from equiformer_tpu_torch.kernels import dtp_lin_leg_plain

    plan, x, sh, w, W, g = _md17_inputs(site, 37, seed=21)
    ops = {"x": x, "sh": sh, "w": w, leg: None}
    want = dtp_lin_leg_plain(plan, leg, g, ops["x"], ops["sh"], ops["w"], W,
                             torch.tensor(29, dtype=torch.int32))
    got = _emulate_k2_launch1(plan, ops["x"], ops["sh"], ops["w"], W, g, 29, leg=leg,
                              n_split=1 if split == "tile" else len(plan.groups))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want.numpy()) < 1e-6
    assert float(got[29:].abs().max()) == 0.0


# the outputs each caller of K5a asks for at MD17's sites: the force pass
# (dx, dsh, dw at sep_act; dx, dsh at sep_value; dsh, dw at the edge degree)
# and the parameter pass of training (dx, dw at the per-edge-w sites); "sh":
# K5b's sh leg alone
K5A_NEEDS = {
    "md17-sep_act": [("x", "sh", "w"), ("x", "w"), "sh"],
    "md17-sep_value": [("x", "sh"), "sh"],
    "md17-edge_deg": [("sh", "w"), ("x", "w"), "sh"],
}


@pytest.mark.parametrize("split", ["tile", "groups"])
@pytest.mark.parametrize("site,need", [(s, n) for s, needs in K5A_NEEDS.items() for n in needs])
def test_k5a_walks_k2_launch1_at_md17_plans(site, need, split):
    """K5a (k2::bwd3_kernel, each caller's subset of dx, dsh, dw) and K5b's
    sh leg (k2::sh_leg_kernel, sh None) as K2's launch 1 runs them, with the
    dsh sum in the kernel's fixed order, at MD17 exp_l3's full-width plans:
    37 edges of which 29 real (a partial last tile and a tile past the real
    edges), each tile's block whole or cut by irrep group: the plain
    versions within 1e-6 (fp64 inputs, the tables' fp32 CG coefficients);
    rows past n_edges exactly 0."""
    from equiformer_tpu_torch.kernels import dtp_lin_bwd3_plain, dtp_lin_leg_plain

    plan, x, sh, w, W, g = _md17_inputs(site, 37, seed=23)
    n = torch.tensor(29, dtype=torch.int32)
    n_split = 1 if split == "tile" else len(plan.groups)
    if need == "sh":
        want = [dtp_lin_leg_plain(plan, "sh", g, x, None, w, W, n)]
        got = [_emulate_k2_launch1(plan, x, None, w, W, g, 29, leg="sh", n_split=n_split)]
    else:
        plain = dict(zip(("x", "sh", "w"), dtp_lin_bwd3_plain(plan, x, sh, w, W, g, n)))
        out = dict(zip(("x", "sh", "w"), _emulate_k2_launch1(
            plan, x, sh, w, W, g, 29, leg="bwd3", n_split=n_split, need=need)))
        assert all((out[k] is None) == (k not in need) for k in out)
        want, got = [plain[k] for k in need], [out[k] for k in need]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b.numpy()) < 1e-6
        assert float(a[29:].abs().max()) == 0.0


@pytest.mark.parametrize("site", list(MD17_SITES))
def test_k5c_walks_k2_launch2_at_md17_plans(site):
    """K5c as K2's launch 2 runs it (k2::W_leg_kernel: z recomputed per dW
    tile and edge range from x, of row stride 0 at the edge degree, and w,
    None for the shared weights), at MD17 exp_l3's full-width plans with 37
    edges of which 29 real: the plain head-weight leg within 1e-6; the tiles
    cover each element of W_flat once per range, pad rows included."""
    from equiformer_tpu_torch.kernels import dtp_lin_legW_plain

    plan, x, sh, w, _, g = _md17_inputs(site, 37, seed=22)
    assert x.stride(0) == (0 if MD17_SITES[site][2] else plan.d_x)
    want = dtp_lin_legW_plain(plan, g, x, sh, w, torch.tensor(29, dtype=torch.int32))
    part, writes = _emulate_k2_launch2(plan, x, sh, w, g, 29)
    assert bool((writes == 1).all())
    dW = part[0] + sum(part[1:]) if part.shape[0] > 1 else part[0]
    assert _rel(dW.numpy(), want.numpy()) < 1e-6


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
