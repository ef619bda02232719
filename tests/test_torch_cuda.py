"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels have
no CPU mode).  The file imports no jax, so it also runs where only the port
is installed; ``tests/conftest.py`` imports jax, so on such a machine run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances (max |kernel - plain| / max |plain|): fp32 1e-4, the kernels and
the plain versions sum in another order; bf16 2e-2, the plain versions round
intermediates (the TP output z and dz, the softmax weights) to bf16 and the
kernels keep them in fp32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from equiformer_tpu_torch.core import Irreps, depthwise_tp  # noqa: E402
from equiformer_tpu_torch.kernels import (  # noqa: E402
    DTPLinPlan,
    attn_combine,
    attn_combine_fwd,
    attn_combine_plain,
    attn_den_plain,
    csr_segment_sum,
    dtp_lin,
    dtp_lin_bwd,
    dtp_lin_bwd_plain,
    dtp_lin_fwd,
    dtp_lin_plain,
    reset_launch_counts,
    segment_sum_plain,
)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
IRR = "8x0e+4x1e+2x2e"
SH = "1x0e+1x1e+1x2e"
HEADS = {
    "per-edge": (["14x0e+4x1e+2x2e"], False, False),
    "two-head": (["14x0e+4x1e+2x2e", "6x0e"], False, False),
    "shared-w": (["14x0e+4x1e+2x2e"], True, False),
    "broadcast-x": (["14x0e+4x1e+2x2e"], False, True),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    assert bool(torch.isfinite(a).all())
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _csr(dev, dt, C, E=300, N=40, seed=3):
    g = torch.Generator().manual_seed(seed)
    dst = torch.sort(torch.randint(0, N, (E,), generator=g)).values
    dst[-20:] = N - 1  # padded tail, as the radius graph builds it
    mask = torch.rand(E, generator=g) > 0.1
    mask[-20:] = False
    val = torch.randn(E, C, generator=g)
    return val.to(dev, dt), dst.to(dev), mask.to(dev), N


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("case", list(HEADS))
def test_dtp_lin_kernel_matches_plain(dev, case, dtype):
    heads, shared, broadcast = HEADS[case]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    plan = DTPLinPlan(tp, heads, shared_weights=shared)
    E = 300
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    sh = rnd(E, plan.d_sh)
    w = rnd(plan.d_w) if shared else rnd(E, plan.d_w)
    W = plan.pack_weights([[None if w_ is None else rnd(*w_.shape) for w_ in ws]
                           for ws in _head_shapes(tp, heads)])
    n = torch.tensor(250, dtype=torch.int32, device=dev)
    reset_launch_counts()
    k = dtp_lin(plan, x, sh, w, W, n)
    assert dtp_lin_fwd.launches == 1
    p = dtp_lin_plain(plan, x, sh, w, W, n)
    torch.cuda.synchronize()
    assert _rel(k, p) < TOL[dtype]
    assert float(k[250:].abs().max()) == 0.0


def _head_shapes(tp, heads):
    """Zero tensors shaped like each head's IrrepsLinear weights."""
    out = []
    for h in heads:
        ws = []
        for mul_out, ir_out in Irreps(h):
            fan = sum(m for m, ir in tp.irreps_out if ir == ir_out)
            ws.append(torch.zeros(fan, mul_out) if fan else None)
        out.append(ws)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
def test_csr_kernels_match_plain(dev, dtype):
    dt = getattr(torch, dtype)
    val, dst, mask, N = _csr(dev, dt, 160)
    reset_launch_counts()
    assert _rel(csr_segment_sum(val, dst, N, mask), segment_sum_plain(val, dst, N, mask)) \
        < TOL[dtype]
    scores = (2.0 * val[:, :4]).contiguous()
    value = val.reshape(-1, 4, 40)
    drop = (torch.rand(val.shape[0], 4, device=dev) < 0.8).to(dt) / 0.8
    for dm in (None, drop):
        assert _rel(attn_combine(scores, value, dst, N, mask, dm),
                    attn_combine_plain(scores, value, dst, N, mask, dm)) < TOL[dtype]
    assert (csr_segment_sum.launches, attn_combine.launches) == (1, 2)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    val, dst, mask, N = _csr(dev, torch.float64, 160)
    with pytest.raises(TypeError):
        csr_segment_sum(val, dst, N, mask)  # no float64 kernel, and no fallback


@pytest.mark.cuda
def test_reduced_model_on_card_matches_cpu(dev):
    import equiformer_tpu_torch as pt
    from equiformer_tpu_torch.data import GraphLoader, qm9_like_dataset
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer

    cfg = dict(irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
               fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
               num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=1024,
               higher_order_grads=False)
    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, 30, shuffle=False)))
    cpu = GraphAttentionTransformer(**cfg).eval()
    ref = pt.evaluate(cpu, batch)["pred"]
    gpu = GraphAttentionTransformer(**cfg).to(dev).eval()
    reset_launch_counts()
    out = pt.evaluate(gpu, batch.to(dev))["pred"]
    # 1 + 2 per block DTP launches; 2 attention combines; the 60-wide edge-degree
    # scatter is under the CSR kernel's 128-column threshold
    assert (dtp_lin_fwd.launches, csr_segment_sum.launches, attn_combine.launches) == (5, 0, 2)
    assert _rel(out, ref) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("case", list(HEADS) + ["dead-w-cols"])
def test_dtp_lin_bwd_kernel_matches_plain(dev, case, dtype):
    """K2 against dtp_lin_bwd_plain on the same operands: dx, dw, dW; rows
    past n_edges get zero gradients.  dW is fp32 either way; its bound is
    the dtype's."""
    heads, shared, broadcast = HEADS.get(case, (["5x0e+3x1e"], False, False))
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(1)
    tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    plan = DTPLinPlan(tp, heads, shared_weights=shared)
    E = 300
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    sh, W, cot = rnd(E, plan.d_sh), rnd(plan.w_numel), rnd(E, plan.d_out)
    w = None if shared else rnd(E, plan.d_w)  # shared weights: already folded into W
    n = torch.tensor(250, dtype=torch.int32, device=dev)
    reset_launch_counts()
    k = dtp_lin_bwd(plan, x, sh, w, W, cot, n)
    assert dtp_lin_bwd.launches == 1
    p = dtp_lin_bwd_plain(plan, x, sh, w, W, cot, n)
    torch.cuda.synchronize()
    assert k[2].dtype == torch.float32
    for a, b in zip(k, p):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a, b) < TOL[dtype]
    assert float(k[0][250:].abs().max()) == 0.0
    again = dtp_lin_bwd(plan, x, sh, w, W, cot, n)[2]
    assert torch.equal(again, k[2])  # the dW reduction runs in a fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
def test_attn_combine_den_and_grads_match_plain(dev, dtype):
    dt = getattr(torch, dtype)
    val, dst, mask, N = _csr(dev, dt, 160, seed=5)
    scores = (2.0 * val[:, :4]).contiguous()
    value = val.reshape(-1, 4, 40)
    drop = (torch.rand(val.shape[0], 4, device=dev) < 0.8).to(dt) / 0.8
    masked = torch.where(mask[:, None], scores, torch.full_like(scores, -1e30))
    out, den = attn_combine_fwd(masked, value, dst, N, mask, drop)
    assert den.dtype == torch.float32
    assert _rel(den, attn_den_plain(masked, dst, N)) < TOL[dtype]
    assert _rel(out, attn_combine_plain(scores, value, dst, N, mask, drop)) < TOL[dtype]
    grads = []
    for d in (dev, "cpu"):
        s = scores.detach().to(d, torch.float32).requires_grad_()
        v = value.detach().to(d, torch.float32).requires_grad_()
        attn_combine(s, v, dst.to(d), N, mask.to(d), drop.to(d, torch.float32)).square().sum() \
            .backward()
        grads.append((s.grad, v.grad))
    for a, b in zip(*grads):
        assert _rel(a, b) < 1e-4


@pytest.mark.cuda
def test_reduced_train_step_on_card_matches_cpu(dev):
    """One fp32 training step (alpha dropout from injected masks) on the card
    against the same step on the CPU plain path: loss and gradient norm
    within 1e-4 relative, the updated parameters within 1e-4 of the largest."""
    import equiformer_tpu_torch as pt
    from equiformer_tpu_torch.data import GraphLoader, qm9_like_dataset
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer

    cfg = dict(irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
               fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
               num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=1024,
               higher_order_grads=False)
    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, 30, shuffle=False)))
    keep = [torch.rand(1024, 4, generator=torch.Generator().manual_seed(i)) < 0.8
            for i in range(2)]
    results = []
    for d in ("cpu", dev):
        model = GraphAttentionTransformer(**cfg).to(d)
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000))
        step, _ = pt.make_qm9_steps(model, opt)
        reset_launch_counts()
        state, m = step(pt.TrainState.create(model, opt), batch.to(d), iter(keep))
        results.append((m, {n: p.detach().cpu() for n, p in model.named_parameters()}))
    # per block: K1 x2, K2 x2, K3 x2 (the message gather's backward), K4 x1;
    # the edge-degree embedding: K1, K2 (its 60-wide scatter is under the
    # CSR kernel's 128-column threshold)
    assert (dtp_lin_fwd.launches, dtp_lin_bwd.launches, csr_segment_sum.launches,
            attn_combine.launches) == (5, 5, 0, 2)
    (mc, pc), (mg, pg) = results
    for k in ("loss", "grad_norm"):
        assert abs(float(mg[k]) - float(mc[k])) < 1e-4 * abs(float(mc[k]))
    scale = max(float(p.abs().max()) for p in pc.values())
    assert max(float((pg[n] - pc[n]).abs().max()) for n in pc) < 1e-4 * scale


# The three call sites of the force backward (K5a) at small L3 widths:
# (head irreps, shared weights, row-broadcast x without dx)
L3_IRR = "16x0e+8x1e+8x2e+4x3e"
L3_SH = "1x0e+1x1e+1x2e+1x3e"
BWD3_SITES = {
    "sep_act": (["36x0e+8x1e+8x2e+4x3e", "8x0e"], False, False),
    "sep_value": ([L3_IRR], True, False),
    "edge_deg": ([L3_IRR], False, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("site", list(BWD3_SITES))
def test_dtp_lin_bwd3_kernel_matches_plain(dev, site, dtype):
    """K5a against dtp_lin_bwd3_plain on the same operands: dx (not asked
    for at the broadcast site), dsh and dw; rows past n_edges get zeros; a
    second call gives the same bits (no atomics)."""
    from equiformer_tpu_torch.kernels import dtp_lin_bwd3, dtp_lin_bwd3_plain

    heads, shared, broadcast = BWD3_SITES[site]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(2)
    plan = DTPLinPlan(depthwise_tp(Irreps(L3_IRR), Irreps(L3_SH), Irreps(L3_IRR)), heads,
                      shared_weights=shared)
    E = 300
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    sh, W, cot = rnd(E, plan.d_sh), rnd(plan.w_numel), rnd(E, plan.d_out)
    w = None if shared else rnd(E, plan.d_w)
    n = torch.tensor(250, dtype=torch.int32, device=dev)
    reset_launch_counts()
    k = dtp_lin_bwd3(plan, x, sh, w, W, cot, n, need_dx=not broadcast)
    assert dtp_lin_bwd3.launches == 1
    p = dtp_lin_bwd3_plain(plan, x, sh, w, W, cot, n)
    torch.cuda.synchronize()
    assert (k[0] is None) == broadcast and (k[2] is None) == shared
    for a, b in zip(k, p):
        if a is not None:
            assert a.dtype == dt
            assert _rel(a, b) < TOL[dtype]
            assert float(a[250:].abs().max()) == 0.0
    again = dtp_lin_bwd3(plan, x, sh, w, W, cot, n, need_dx=not broadcast)
    for a, b in zip(k, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_reduced_md17_forces_on_card_match_cpu(dev):
    """Energies and forces of a reduced L3 force model (2 blocks, exp basis)
    on the card against the CPU plain path, fp32: within 1e-4 of the
    largest; one force evaluation launches 5 K1 and 5 K5a and no K2 / K4."""
    from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset
    from equiformer_tpu_torch.kernels import dtp_lin_bwd3
    from equiformer_tpu_torch.models import md17_models
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer
    from equiformer_tpu_torch.train import evaluate_md17

    cfg = dict(irreps_node_embedding=L3_IRR, num_layers=2, irreps_sh=L3_SH,
               number_of_basis=32, basis_type="exp", fc_neurons=(16, 16),
               irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4,
               irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e", alpha_drop=0.0, max_atom_type=64,
               avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
               avg_degree=md17_models._AVG_DEGREE_MD17, max_edges=1024, nodes_per_graph=21)
    batch = next(iter(GraphLoader(md17_like_dataset(4, seed=0), 4, 21, shuffle=False,
                                  with_forces=True)))
    out = []
    for d in ("cpu", dev):
        model = GraphAttentionTransformer(**cfg).to(d)
        reset_launch_counts()
        r = evaluate_md17(model, batch.to(d))
        out.append((r["energy"].cpu(), r["forces"].cpu()))
    assert (dtp_lin_fwd.launches, dtp_lin_bwd3.launches, dtp_lin_bwd.launches,
            attn_combine.launches) == (5, 5, 0, 0)
    (ec, fc), (eg, fg) = out
    assert _rel(eg, ec) < 1e-4 and _rel(fg, fc) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("site", list(BWD3_SITES))
def test_dtp_lin_leg_kernels_match_plain(dev, site, dtype):
    """K5b (each edge leg alone, without the operand of that leg) and K5c
    (the head-weight leg, fp32) against their plain versions on the same
    operands; rows past n_edges give zeros; second calls give the same bits
    (no atomics, the dW partials summed in a fixed order)."""
    from equiformer_tpu_torch.kernels import (
        dtp_lin_leg, dtp_lin_leg_plain, dtp_lin_legW, dtp_lin_legW_plain,
    )

    heads, shared, broadcast = BWD3_SITES[site]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    plan = DTPLinPlan(depthwise_tp(Irreps(L3_IRR), Irreps(L3_SH), Irreps(L3_IRR)), heads,
                      shared_weights=shared)
    E = 300
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    sh, W, cot = rnd(E, plan.d_sh), rnd(plan.w_numel), rnd(E, plan.d_out)
    w = None if shared else rnd(E, plan.d_w)
    n = torch.tensor(250, dtype=torch.int32, device=dev)
    legs = ("x", "sh") if shared else ("x", "sh", "w")
    reset_launch_counts()
    for leg in legs:
        ops = {"x": x, "sh": sh, "w": w, leg: None}
        k = dtp_lin_leg(plan, leg, cot, ops["x"], ops["sh"], ops["w"], W, n)
        p = dtp_lin_leg_plain(plan, leg, cot, ops["x"], ops["sh"], ops["w"], W, n)
        torch.cuda.synchronize()
        assert k.dtype == dt and k.shape == p.shape
        assert _rel(k, p) < TOL[dtype], leg
        assert float(k[250:].abs().max()) == 0.0
        assert torch.equal(k, dtp_lin_leg(plan, leg, cot, ops["x"], ops["sh"], ops["w"], W, n))
    assert dtp_lin_leg.launches == 2 * len(legs)
    k = dtp_lin_legW(plan, cot, x, sh, w, n)
    p = dtp_lin_legW_plain(plan, cot, x, sh, w, n)
    torch.cuda.synchronize()
    assert k.dtype == torch.float32 and k.shape == (plan.w_numel,)
    assert _rel(k, p) < TOL[dtype]
    assert torch.equal(k, dtp_lin_legW(plan, cot, x, sh, w, n))
    assert dtp_lin_legW.launches == 2


@pytest.mark.cuda
def test_reduced_md17_train_step_on_card_matches_cpu(dev):
    """One fp32 training step of a reduced L3 force model (2 blocks, exp
    basis, force_weight 80) on the card against the CPU plain path: loss and
    gradient norm within 1e-3 relative (fp32 forces are noisy, the exp
    basis's derivative cancels), parameters within 1e-3 of the largest; the
    step's launches per kernel; two steps from one state give the same bits."""
    import copy

    import equiformer_tpu_torch as pt
    from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset
    from equiformer_tpu_torch.kernels import launch_counts
    from equiformer_tpu_torch.models import md17_models
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer

    cfg = dict(irreps_node_embedding=L3_IRR, num_layers=2, irreps_sh=L3_SH,
               number_of_basis=32, basis_type="exp", fc_neurons=(16, 16),
               irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4,
               irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e", alpha_drop=0.0, max_atom_type=64,
               avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
               avg_degree=md17_models._AVG_DEGREE_MD17, max_edges=1024, nodes_per_graph=21)
    batch = next(iter(GraphLoader(md17_like_dataset(4, seed=0), 4, 21, shuffle=False,
                                  with_forces=True)))
    results = []
    for d in ("cpu", dev, dev):
        model = GraphAttentionTransformer(**cfg).to(d)
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000), weight_decay=1e-6)
        step, _ = pt.make_md17_steps(model, opt, energy_weight=1.0, force_weight=80.0)
        reset_launch_counts()
        _, m = step(pt.TrainState.create(model, opt), batch.to(d))
        results.append(({k: float(v) for k, v in m.items()},
                        copy.deepcopy({n: p.detach().cpu() for n, p in model.named_parameters()})))
    # 5 fused DTP sites (edge degree + 2 per block): K1 5 forward + 3 per
    # per-edge-w site's bwd3 node (2 at the edge-degree site) + 2 per shared
    # site; K5a 5 in the force pass + the 3 per-edge-w sites again in the
    # parameter pass; the narrow model's sums stay under K3's 128 columns
    counts = launch_counts()
    assert (counts["dtp_lin_fwd"], counts["dtp_lin_bwd3"], counts["dtp_lin_leg"],
            counts["dtp_lin_legW"], counts["dtp_lin_bwd"], counts["attn_combine"]) \
        == (17, 8, 15, 17, 0, 0)
    (mc, pc), (mg, pg), (mg2, pg2) = results
    for k in ("loss", "grad_norm"):
        assert abs(mg[k] - mc[k]) < 1e-3 * abs(mc[k])
    scale = max(float(p.abs().max()) for p in pc.values())
    assert max(float((pg[n] - pc[n]).abs().max()) for n in pc) < 1e-3 * scale
    assert mg == mg2 and all(torch.equal(pg[n], pg2[n]) for n in pg)


# The unfused route's primitives (K6) on the DTP term lists of the QM9 and
# L3 call sites at small widths: (node irreps, SH, fold_rescale)
K6_PLANS = {"l2": (IRR, SH, True), "l2-shared-w": (IRR, SH, False), "l3": (L3_IRR, L3_SH, True)}


def _k6_operands(tl, dev, dt, shared_a=False, shared_b=False, E=300, seed=5):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    a = rnd(1, tl.d_a).expand(E, tl.d_a) if shared_a else rnd(E, tl.d_a)
    b = rnd(1, tl.d_b) if shared_b else rnd(E, tl.d_b)
    return a, rnd(E, tl.d_col), b, rnd(E, tl.d_out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("plan", list(K6_PLANS))
def test_dtp_t_r_and_fused_bwd_kernels_match_plain(dev, plan, dtype):
    """K6-T on the DTP's terms and on each transpose's permutation, K6-R and
    K6-FB against their plain versions on the same operands, with a
    broadcast a (an expanded row) or b (one row) where the call sites have
    them; second calls give the same bits (one writer per element, fixed
    reduction order)."""
    from equiformer_tpu_torch.kernels import dtp as kd

    irr, sh, fold = K6_PLANS[plan]
    dt = getattr(torch, dtype)
    tl = kd.TermList.for_plan(depthwise_tp(Irreps(irr), Irreps(sh), Irreps(irr)), fold)
    reset_launch_counts()
    n_t = n_r = 0
    for sa, sb in ((False, False), (True, False), (False, True)):
        a, col, b, d = _k6_operands(tl, dev, dt, sa, sb)
        for member, ops in ((tl, (a, col, b)), (kd.perm_a(tl), (d, col, b)),
                            (kd.perm_b(tl), (a, col, d)), (kd.perm_r_a(tl), (b, col, d))):
            k = kd.dtp_t(member, *ops)
            p = kd.dtp_t_plain(member, *ops)
            torch.cuda.synchronize()
            assert k.dtype == dt and k.shape == p.shape == (300, member.d_out)
            assert _rel(k, p) < TOL[dtype], member.slots
            assert torch.equal(k, kd.dtp_t(member, *ops))
            n_t += 2
        k = kd.dtp_r(tl, a, b, d)
        assert _rel(k, kd.dtp_r_plain(tl, a, b, d)) < TOL[dtype]
        assert k.shape == (300, tl.d_col) and torch.equal(k, kd.dtp_r(tl, a, b, d))
        n_r += 2
        k = kd.dtp_fused_bwd(tl, a, col, b, d)
        for x, y in zip(k, kd.dtp_fused_bwd_plain(tl, a, col, b, d)):
            assert x.dtype == dt and x.shape == y.shape and _rel(x, y) < TOL[dtype]
    assert (kd.dtp_t.launches, kd.dtp_r.launches, kd.dtp_fused_bwd.launches) == (n_t, n_r, 3)


@pytest.mark.cuda
def test_k6_wrappers_reject_what_the_kernels_do_not_take(dev):
    from equiformer_tpu_torch.kernels import dtp as kd

    tl = kd.TermList.for_plan(depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR)), True)
    a, col, b, d = _k6_operands(tl, dev, torch.float32)
    with pytest.raises(TypeError):
        kd.dtp_t(tl, a.double(), col.double(), b.double())
    with pytest.raises(ValueError):
        kd.dtp_t(tl, a[:, 1:], col, b)
    with pytest.raises(TypeError):
        kd.dtp_r(tl, a, b.half(), d)


QM9_SMALL = dict(irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
                 fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
                 num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=1024,
                 higher_order_grads=False)


@pytest.mark.cuda
@pytest.mark.parametrize("first_order", [False, True], ids=["t-r", "fused-bwd"])
def test_reduced_unfused_train_step_on_card_matches_cpu(dev, first_order):
    """One fp32 training step of the reduced QM9 model on the unfused route
    on the card against the CPU plain path, within 1e-4 as the fused
    route's; per step 3 T per DTP site (forward, x and w legs), or one T and
    one FB with dtp_first_order_bwd; no R (QM9 positions need no gradient),
    no K1 / K2."""
    import equiformer_tpu_torch as pt
    from equiformer_tpu_torch.data import GraphLoader, qm9_like_dataset
    from equiformer_tpu_torch.kernels import launch_counts
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer

    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, 30, shuffle=False)))
    keep = [torch.rand(1024, 4, generator=torch.Generator().manual_seed(i)) < 0.8
            for i in range(2)]
    results = []
    for d in ("cpu", dev):
        model = GraphAttentionTransformer(**QM9_SMALL, fused_dtp_lin=False,
                                          dtp_first_order_bwd=first_order).to(d)
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000))
        step, _ = pt.make_qm9_steps(model, opt)
        reset_launch_counts()
        state, m = step(pt.TrainState.create(model, opt), batch.to(d), iter(keep))
        results.append((m, {n: p.detach().cpu() for n, p in model.named_parameters()}))
    c = launch_counts()
    assert (c["dtp_t"], c["dtp_r"], c["dtp_fused_bwd"], c["dtp_lin_fwd"], c["dtp_lin_bwd"],
            c["attn_combine"]) == ((5, 0, 5, 0, 0, 2) if first_order else (15, 0, 0, 0, 0, 2))
    (mc, pc), (mg, pg) = results
    for k in ("loss", "grad_norm"):
        assert abs(float(mg[k]) - float(mc[k])) < 1e-4 * abs(float(mc[k]))
    scale = max(float(p.abs().max()) for p in pc.values())
    assert max(float((pg[n] - pc[n]).abs().max()) for n in pc) < 1e-4 * scale


@pytest.mark.cuda
def test_reduced_unfused_md17_on_card_matches_cpu(dev):
    """The reduced L3 force model (2 blocks) on the unfused route: a force
    evaluation (12 T, 5 R) and a training step (51 T, 5 R: the parameter
    pass runs no R) on the card against the CPU plain path, as the fused
    route's tests hold them; two steps from one state give the same bits."""
    import copy

    import equiformer_tpu_torch as pt
    from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset
    from equiformer_tpu_torch.kernels import launch_counts
    from equiformer_tpu_torch.models import md17_models
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer

    cfg = dict(irreps_node_embedding=L3_IRR, num_layers=2, irreps_sh=L3_SH,
               number_of_basis=32, basis_type="exp", fc_neurons=(16, 16),
               irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4,
               irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e", alpha_drop=0.0, max_atom_type=64,
               avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
               avg_degree=md17_models._AVG_DEGREE_MD17, max_edges=1024, nodes_per_graph=21,
               fused_dtp_lin=False)
    batch = next(iter(GraphLoader(md17_like_dataset(4, seed=0), 4, 21, shuffle=False,
                                  with_forces=True)))
    forces, results = [], []
    for d in ("cpu", dev, dev):
        model = GraphAttentionTransformer(**cfg).to(d)
        reset_launch_counts()
        r = pt.evaluate_md17(model, batch.to(d))
        forces.append((r["energy"].cpu(), r["forces"].cpu()))
        ev = launch_counts()
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000), weight_decay=1e-6)
        step, _ = pt.make_md17_steps(model, opt, energy_weight=1.0, force_weight=80.0)
        reset_launch_counts()
        _, m = step(pt.TrainState.create(model, opt), batch.to(d))
        results.append(({k: float(v) for k, v in m.items()},
                        copy.deepcopy({n: p.detach().cpu() for n, p in model.named_parameters()})))
    tr = launch_counts()
    assert (ev["dtp_t"], ev["dtp_r"], ev["dtp_lin_fwd"], ev["dtp_lin_bwd3"]) == (12, 5, 0, 0)
    assert (tr["dtp_t"], tr["dtp_r"], tr["dtp_fused_bwd"], tr["dtp_lin_fwd"],
            tr["dtp_lin_leg"], tr["dtp_lin_legW"]) == (51, 5, 0, 0, 0, 0)
    (ec, fc), (eg, fg), (eg2, fg2) = forces
    assert _rel(eg, ec) < 1e-4 and _rel(fg, fc) < 1e-4
    assert torch.equal(eg, eg2) and torch.equal(fg, fg2)
    (mc, pc), (mg, pg), (mg2, pg2) = results
    for k in ("loss", "grad_norm"):
        assert abs(mg[k] - mc[k]) < 1e-3 * abs(mc[k])
    scale = max(float(p.abs().max()) for p in pc.values())
    assert max(float((pg[n] - pc[n]).abs().max()) for n in pc) < 1e-3 * scale
    assert mg == mg2 and all(torch.equal(pg[n], pg2[n]) for n in pg)


# The radial fold (K7): w = [h, 1] @ [Wr; offset] built in the kernel.
# (irreps, SH, heads, radial hidden width): the QM9 sep_act plan at small
# widths, a plan whose w columns partly feed no head, and an L3 sep_act plan
RAD_PLANS = {
    "two-head": (IRR, SH, ["14x0e+4x1e+2x2e", "6x0e"], 16),
    "dead-w-cols": (IRR, SH, ["5x0e+3x1e"], 8),
    "l3": (L3_IRR, L3_SH, ["36x0e+8x1e+8x2e+4x3e", "8x0e"], 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("plan_name", list(RAD_PLANS))
def test_radial_fold_kernels_match_plain(dev, plan_name, dtype):
    """K7-F, K7-B and K7-B3 against dtp_lin_rad_plain, dtp_lin_rad_bwd_plain
    and dtp_lin_rad_bwd3_plain on the same operands, with n_edges below E
    (the padded rows get zeros and add nothing to d[Wr; offset]) and, for
    K7-B3, without dx as at the broadcast edge-degree site; two calls give
    the same bits."""
    from equiformer_tpu_torch.kernels import (
        dtp_lin_rad_bwd, dtp_lin_rad_bwd3, dtp_lin_rad_bwd3_plain, dtp_lin_rad_bwd_plain,
        dtp_lin_rad_fwd, dtp_lin_rad_plain,
    )

    irr, sh_irr, heads, hd = RAD_PLANS[plan_name]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    plan = DTPLinPlan(depthwise_tp(Irreps(irr), Irreps(sh_irr), Irreps(irr)), heads,
                      radial_fold=hd)
    assert plan.dw_has_dead_cols == (plan_name == "dead-w-cols")
    E = 300
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x, sh, h, W, cot = (rnd(E, plan.d_x), rnd(E, plan.d_sh), rnd(E, hd), rnd(plan.w_numel),
                        rnd(E, plan.d_out))
    Wrs = plan.pack_radial(0.3 * rnd(hd, plan.d_w), 0.3 * rnd(plan.d_w))
    n = torch.tensor(250, dtype=torch.int32, device=dev)
    reset_launch_counts()
    calls = {
        "fwd": (lambda: dtp_lin_rad_fwd(plan, x, sh, h, Wrs, W, n),
                lambda: dtp_lin_rad_plain(plan, x, sh, h, Wrs, W, n)),
        "bwd": (lambda: dtp_lin_rad_bwd(plan, x, sh, h, Wrs, W, cot, n),
                lambda: dtp_lin_rad_bwd_plain(plan, x, sh, h, Wrs, W, cot, n)),
        "bwd3": (lambda: dtp_lin_rad_bwd3(plan, x, sh, h, Wrs, W, cot, n),
                 lambda: dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wrs, W, cot, n)),
        "bwd3-no-dx": (lambda: dtp_lin_rad_bwd3(plan, x, sh, h, Wrs, W, cot, n, need_dx=False),
                       lambda: (None,) + dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wrs, W, cot,
                                                                n)[1:]),
    }
    for name, (kernel, plain) in calls.items():
        k, p = kernel(), plain()
        torch.cuda.synchronize()
        k, p = (k, p) if isinstance(k, tuple) else ((k,), (p,))
        for a, b in zip(k, p):
            assert (a is None) == (b is None), name
            if a is None:
                continue
            assert _rel(a, b) < TOL[dtype], name
            if a.shape[0] == E:  # per-edge outputs: zero past n_edges
                assert float(a[250:].abs().max()) == 0.0, name
        again = kernel()
        again = again if isinstance(again, tuple) else (again,)
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(k, again)), name
    assert (dtp_lin_rad_fwd.launches, dtp_lin_rad_bwd.launches,
            dtp_lin_rad_bwd3.launches) == (2, 2, 4)


@pytest.mark.cuda
def test_reduced_folded_units_on_card_match_cpu(dev):
    """A reduced QM9 step with ``radial_fold`` on the card against the CPU
    plain path (fp32, loss within 1e-4), and a reduced L3 force evaluation
    with ``radial_fold_ho``: its fp32 energies and forces on the card no
    farther from a float64 CPU evaluation than 3x the fp32 CPU path's
    distance (+1e-6; fp32 forces carry ~3e-4 of max |F| of rounding noise,
    the exp basis's derivative cancels, and the fold sums h @ Wr in another
    order: ``tests/test_torch_md17.py``'s FP32_FACTOR rule).  The folded
    sites launch K7-F / K7-B / K7-B3 (2 blocks: 3 folded sites, 2
    shared-weight ones)."""
    from equiformer_tpu_torch import evaluate_md17
    from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset, qm9_like_dataset
    from equiformer_tpu_torch.kernels import launch_counts
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel

    import equiformer_tpu_torch as pt

    qm9 = dict(irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
               fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
               num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=512,
               nodes_per_graph=30, higher_order_grads=False, alpha_drop=0.0, radial_fold=True)
    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, 30, shuffle=False)))
    res = []
    for d in ("cpu", dev):
        m = TModel(**qm9).to(d)
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(1e-3, 2, 10))
        step, _ = pt.make_qm9_steps(m, opt)
        reset_launch_counts()
        _, metrics = step(pt.TrainState.create(m, opt), batch.to(d), None)
        res.append((float(metrics["loss"]), launch_counts()))
    assert abs(res[1][0] - res[0][0]) < 1e-4 * abs(res[0][0])
    c = res[1][1]
    assert (c["dtp_lin_rad_fwd"], c["dtp_lin_rad_bwd"], c["dtp_lin_fwd"], c["dtp_lin_bwd"]) == (
        3, 3, 2, 2)

    md17 = dict(irreps_node_embedding="16x0e+8x1e+8x2e+4x3e", num_layers=2,
                irreps_sh="1x0e+1x1e+1x2e+1x3e", number_of_basis=32, fc_neurons=(16, 16),
                irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4,
                irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e", alpha_drop=0.0, max_atom_type=64,
                max_edges=1536, nodes_per_graph=21, basis_type="exp", radial_fold=True,
                radial_fold_ho=True)
    mb = next(iter(GraphLoader(md17_like_dataset(4, num_atoms=21, seed=0), 4, 21,
                               shuffle=False, with_forces=True)))
    out = []
    for d in ("cpu", dev):
        m = TModel(**md17).to(d)
        reset_launch_counts()
        out.append((evaluate_md17(m, mb.to(d)), launch_counts()))
    (cpu, _), (card, c) = out
    ref = evaluate_md17(TModel(**md17).double(), mb.to(dtype=torch.float64))
    for k in ("energy", "forces"):
        assert _rel(card[k], ref[k]) <= 3.0 * _rel(cpu[k], ref[k]) + 1e-6, k
    assert (c["dtp_lin_rad_fwd"], c["dtp_lin_rad_bwd3"], c["dtp_lin_fwd"], c["dtp_lin_bwd3"]) == (
        3, 3, 2, 2)
