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

import importlib

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
               nodes_per_graph=30, higher_order_grads=False)
    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, dense_slots=30, shuffle=False)))
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
               nodes_per_graph=30, higher_order_grads=False)
    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, dense_slots=30, shuffle=False)))
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


# The three call sites of the force backward (K5a) at small L3 widths, and a
# plan whose one head reads one irrep group (its edge-leg launches keep each
# 16-edge tile whole: grid.y = 1): (head irreps, shared weights,
# row-broadcast x without dx)
L3_IRR = "16x0e+8x1e+8x2e+4x3e"
L3_SH = "1x0e+1x1e+1x2e+1x3e"
BWD3_SITES = {
    "sep_act": (["36x0e+8x1e+8x2e+4x3e", "8x0e"], False, False),
    "sep_value": ([L3_IRR], True, False),
    "edge_deg": ([L3_IRR], False, True),
    "one_group": (["8x0e"], False, False),
}


# every subset of K5a's outputs: (dx, dsh, dw) and the pairs, which the
# callers ask for, and each output alone (K5b's edge leg); no dw where the
# weights are shared
K5A_SUBSETS = (("x", "sh", "w"), ("x", "sh"), ("sh", "w"), ("x", "w"), ("x",), ("sh",), ("w",))


def _k5a_cases(plan, x, sh, w, W, cot, n):
    """(need, K5a's outputs) of every subset of dx, dsh and dw at this plan
    (none with dw where the weights are shared)."""
    from equiformer_tpu_torch.kernels import dtp_lin_bwd3

    for need in K5A_SUBSETS:
        if w is None and "w" in need:
            continue
        flags = {f"need_d{k}": k in need for k in ("x", "sh", "w")}
        yield need, lambda flags=flags: dtp_lin_bwd3(plan, x, sh, w, W, cot, n, **flags)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("site", list(BWD3_SITES))
def test_dtp_lin_bwd3_kernel_matches_plain(dev, site, dtype):
    """K5a (K2's launch 1 with the dsh sum) against dtp_lin_bwd3_plain on the
    same operands, with every subset of dx, dsh and dw (one alone on K5b's
    leg): what is not asked for comes back None, rows past n_edges get
    zeros, a second call gives the same bits (no atomics)."""
    from equiformer_tpu_torch.kernels import dtp_lin_bwd3, dtp_lin_bwd3_plain, dtp_lin_leg

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
    p = dict(zip(("x", "sh", "w"), dtp_lin_bwd3_plain(plan, x, sh, w, W, cot, n)))
    reset_launch_counts()
    n_calls = [0, 0]  # two or three outputs, one alone
    for need, call in _k5a_cases(plan, x, sh, w, W, cot, n):
        k = dict(zip(("x", "sh", "w"), call()))
        again = dict(zip(("x", "sh", "w"), call()))
        n_calls[len(need) == 1] += 2
        torch.cuda.synchronize()
        for key, a in k.items():
            assert (a is None) == (key not in need), (need, key)
            if a is not None:
                assert a.dtype == dt
                assert _rel(a, p[key]) < TOL[dtype], (need, key)
                assert float(a[250:].abs().max()) == 0.0
                assert torch.equal(a, again[key])
    assert [dtp_lin_bwd3.launches, dtp_lin_leg.launches] == n_calls


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
    batch = next(iter(GraphLoader(md17_like_dataset(4, seed=0), 4, dense_slots=21, shuffle=False,
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
    """K5b (each edge leg alone, without the operand of that leg, on K2's
    launch 1: the one-group plan keeps each tile whole) and K5c
    (the head-weight leg, fp32) against their plain versions on the same
    operands; rows past n_edges give zeros; second calls give the same bits
    (no atomics, the dW and dsh partials summed in a fixed order)."""
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
        p = dtp_lin_leg_plain(plan, leg, cot, ops["x"], ops["sh"], ops["w"], W, n)
        k = dtp_lin_leg(plan, leg, cot, ops["x"], ops["sh"], ops["w"], W, n)
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


# MD17 exp_l3's three fused sites at full width (block 0's sep_act with its
# two heads, sep_value with shared weights, the edge-degree embedding with
# its row-broadcast x): (heads, shared weights, broadcast x)
MD17_EMB = "128x0e+64x1e+64x2e+32x3e"
MD17_SITES = {
    "sep_act": (["288x0e+64x1e+64x2e+32x3e", "128x0e"], False, False),
    "sep_value": ([MD17_EMB], True, False),
    "edge_deg": ([MD17_EMB], False, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("site", list(MD17_SITES))
def test_k5b_k5c_on_k2_launches_at_md17_sites(dev, site, dtype):
    """K5b's x and w legs (K2's launch 1, a block per tile and irrep group)
    and K5c (K2's launch 2) at MD17 exp_l3's full-width sites
    against their plain versions: E = 2941 (a multiple of neither 16 nor 64)
    with 2600 real rows, whose tail gives zeros, and E = 0; two calls give
    the same bits (no float atomics; the x leg's per-group partials and the
    dW partial rows are summed in a fixed order)."""
    from equiformer_tpu_torch.kernels import (
        dtp_lin_leg, dtp_lin_leg_plain, dtp_lin_legW, dtp_lin_legW_plain,
    )

    heads, shared, broadcast = MD17_SITES[site]
    dt = getattr(torch, dtype)
    plan = DTPLinPlan(depthwise_tp(Irreps(MD17_EMB), Irreps(L3_SH), Irreps(MD17_EMB)), heads,
                      shared_weights=shared)
    legs = ("x",) if shared else ("x", "w")
    g = torch.Generator().manual_seed(9)
    for E, n_live in ((2941, 2600), (0, 0)):
        rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
        x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
        sh, W, cot = rnd(E, plan.d_sh), rnd(plan.w_numel), rnd(E, plan.d_out)
        w = None if shared else rnd(E, plan.d_w)
        n = torch.tensor(n_live, dtype=torch.int32, device=dev)
        reset_launch_counts()
        for leg in legs:
            ops = {"x": x, "sh": sh, "w": w, leg: None}
            call = lambda: dtp_lin_leg(plan, leg, cot, ops["x"], ops["sh"], ops["w"], W, n)  # noqa: E731
            k = call()
            width = plan.d_x if leg == "x" else plan.d_w
            assert k.dtype == dt and k.shape == (E, width)
            if E == 0:
                continue
            p = dtp_lin_leg_plain(plan, leg, cot, ops["x"], ops["sh"], ops["w"], W, n)
            torch.cuda.synchronize()
            assert _rel(k, p) < TOL[dtype], leg
            assert float(k[n_live:].abs().max()) == 0.0
            assert torch.equal(k, call())
        k = dtp_lin_legW(plan, cot, x, sh, w, n)
        assert k.dtype == torch.float32 and k.shape == (plan.w_numel,)
        if E == 0:
            assert float(k.abs().max()) == 0.0
            assert (dtp_lin_leg.launches, dtp_lin_legW.launches) == (0, 0)
            continue
        p = dtp_lin_legW_plain(plan, cot, x, sh, w, n)
        torch.cuda.synchronize()
        assert _rel(k, p) < TOL[dtype]
        assert torch.equal(k, dtp_lin_legW(plan, cot, x, sh, w, n))
        assert (dtp_lin_leg.launches, dtp_lin_legW.launches) == (2 * len(legs), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("site", list(MD17_SITES))
def test_k5a_and_sh_leg_on_k2_launch1_at_md17_sites(dev, site, dtype):
    """K5a with every subset of its outputs, and K5b's sh leg, on K2's
    launch 1 at MD17 exp_l3's full-width sites (fp32 sep_act reads x through
    L2: its tile does not fit the block's shared memory), each tile cut by
    irrep group, against their plain versions: E = 2941
    with 2600 real rows, whose tail gives zeros, and E = 0; two calls give
    the same bits (the dsh sum has one fixed order)."""
    from equiformer_tpu_torch.kernels import (
        dtp_lin_bwd3, dtp_lin_bwd3_plain, dtp_lin_leg, dtp_lin_leg_plain,
    )

    heads, shared, broadcast = MD17_SITES[site]
    dt = getattr(torch, dtype)
    plan = DTPLinPlan(depthwise_tp(Irreps(MD17_EMB), Irreps(L3_SH), Irreps(MD17_EMB)), heads,
                      shared_weights=shared)
    g = torch.Generator().manual_seed(10)
    for E, n_live in ((2941, 2600), (0, 0)):
        rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
        x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
        sh, W, cot = rnd(E, plan.d_sh), rnd(plan.w_numel), rnd(E, plan.d_out)
        w = None if shared else rnd(E, plan.d_w)
        n = torch.tensor(n_live, dtype=torch.int32, device=dev)
        p = {}
        if E:  # the plain versions take no empty tensors
            p = dict(zip(("x", "sh", "w"), dtp_lin_bwd3_plain(plan, x, sh, w, W, cot, n)))
            p["sh-leg"] = dtp_lin_leg_plain(plan, "sh", cot, x, None, w, W, n)
        reset_launch_counts()
        cases = list(_k5a_cases(plan, x, sh, w, W, cot, n))
        cases.append((("sh-leg",), lambda: (dtp_lin_leg(plan, "sh", cot, x, None, w, W, n),)))
        for need, call in cases:
            k = dict(zip(need if need == ("sh-leg",) else ("x", "sh", "w"), call()))
            again = dict(zip(k, call()))
            torch.cuda.synchronize()
            for key, a in k.items():
                assert (a is None) == (key not in need), (need, key)
                if a is None:
                    continue
                assert a.dtype == dt and a.shape[0] == E
                if E == 0:
                    continue
                assert a.shape == p[key].shape
                assert _rel(a, p[key]) < TOL[dtype], (need, key)
                assert float(a[n_live:].abs().max()) == 0.0
                assert torch.equal(a, again[key])
        if E == 0:
            assert (dtp_lin_bwd3.launches, dtp_lin_leg.launches) == (0, 0)


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
    batch = next(iter(GraphLoader(md17_like_dataset(4, seed=0), 4, dense_slots=21, shuffle=False,
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


@pytest.mark.cuda
def test_reduced_dens_step_on_card_matches_cpu(dev):
    """One fp32 DeNS step (``train_step.noised``) of a reduced L3 model (2
    blocks, a wide 32x0e+16x1e+16x2e+8x3e feature, the denoising head
    through irreps_pre_attn) on the card against the CPU plain path, from
    one noise draw made on the CPU: the four loss terms and the gradient
    norm within 1e-3 relative, the parameters within 1e-3 of the largest;
    the step's launches (the MD17 step's 17 K1, 8 K5a, 15 K5b and 17 K5c
    plus the head's 2, 1, 1 and 2); two steps from one state give the same
    bits."""
    import copy

    import equiformer_tpu_torch as pt
    from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset
    from equiformer_tpu_torch.kernels import launch_counts

    cfg = dict(irreps_node_embedding=L3_IRR, num_layers=2, irreps_sh=L3_SH,
               irreps_equivariant_inputs=L3_SH, number_of_basis=32, basis_type="exp",
               fc_neurons=(16, 16), irreps_feature="32x0e+16x1e+16x2e+8x3e",
               irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4, irreps_pre_attn=L3_IRR,
               irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e", max_edges=1024, nodes_per_graph=21)
    batch = next(iter(GraphLoader(md17_like_dataset(4, seed=0), 4, dense_slots=21, shuffle=False,
                                  with_forces=True)))
    batch = pt.add_masked_gaussian_noise(batch, torch.Generator().manual_seed(1), 0.05, 1.0,
                                         0.25)
    assert 0 < int(batch.extras["noise_mask"].sum()) < int(batch.node_mask.sum())
    results = []
    for d in ("cpu", dev, dev):
        model = pt.model_entrypoint("equiformer_md17_dens")(**cfg, device=d)
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(2e-4, 100, 100000), weight_decay=1e-6)
        step, _ = pt.make_dens_steps(model, opt, denoising_pos_std=0.05)
        reset_launch_counts()
        _, m = step.noised(pt.TrainState.create(model, opt), batch.to(d), 5.0)
        results.append(({k: float(v) for k, v in m.items()},
                        copy.deepcopy({n: p.detach().cpu() for n, p in model.named_parameters()})))
    counts = launch_counts()
    assert (counts["dtp_lin_fwd"], counts["dtp_lin_bwd3"], counts["dtp_lin_leg"],
            counts["dtp_lin_legW"], counts["dtp_lin_bwd"], counts["attn_combine"]) \
        == (19, 9, 16, 19, 0, 0)
    (mc, pc), (mg, pg), (mg2, pg2) = results
    for k in ("loss", "loss_e", "loss_f", "loss_dp", "grad_norm"):
        assert abs(mg[k] - mc[k]) < 1e-3 * abs(mc[k]), k
    scale = max(float(p.abs().max()) for p in pc.values())
    assert max(float((pg[n] - pc[n]).abs().max()) for n in pc) < 1e-3 * scale
    assert mg == mg2 and all(torch.equal(pg[n], pg2[n]) for n in pg)


# The unfused route's primitives (K6) on the DTP term lists of the QM9 and
# L3 call sites at small widths, and the QM9 flagship's: (node irreps, SH,
# fold_rescale).  "l2" has 2-wide tiles (lanes of one column), "l3" and
# "l2-flagship" lanes of 4 columns.
K6_PLANS = {"l2": (IRR, SH, True), "l2-shared-w": (IRR, SH, False), "l3": (L3_IRR, L3_SH, True),
            "l2-flagship": ("128x0e+64x1e+32x2e", SH, True)}
# edge counts: none, one, a partial 32-edge tile either side of one, and
# one that is a multiple of no tile the host picks
K6_EDGES = (0, 1, 31, 33, 301)
# a and b: per edge, one row (broadcast), or one row expanded (stride 0)
K6_BROADCAST = {"none": (False, False), "a-row": (True, False), "b-row": (False, True),
                "a-expand": ("expand", False), "b-expand": (False, "expand")}


def _k6_operands(tl, dev, dt, shared_a=False, shared_b=False, E=300, seed=5):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    a = rnd(1, tl.d_a).expand(E, tl.d_a) if shared_a else rnd(E, tl.d_a)
    b = rnd(1, tl.d_b) if shared_b else rnd(E, tl.d_b)
    return a, rnd(E, tl.d_col), b, rnd(E, tl.d_out)


def _k6_broadcast(tl, dev, dt, case, E):
    """Operands (a, col, b, d) with a or b per edge, one row, or one row
    expanded over the edges."""
    ca, cb = K6_BROADCAST[case]
    a, col, b, d = _k6_operands(tl, dev, dt, E=E, seed=5 + E)
    if ca:
        a = a[:1].expand(E, tl.d_a) if ca == "expand" else a[:1]
    if cb:
        b = b[:1].expand(E, tl.d_b) if cb == "expand" else b[:1]
    return a, col, b, d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("plan", list(K6_PLANS))
def test_dtp_t_r_and_fused_bwd_kernels_match_plain(dev, plan, dtype):
    """K6-T and K6-R on the DTP's terms and on every member of its family
    (each transpose's permutation, the force grad-of-grad's), and K6-FB,
    against their plain versions on the same operands, at each of
    ``K6_EDGES`` and with a or b broadcast (one row, or an expanded row);
    second calls give the same bits (one writer per element, fixed
    reduction order); K6-FB's dx and dw are the bits of K6-T's x and w legs
    and K6-R's output is K6-FB's dsh in every bit, on every member (the
    same sums in the same order)."""
    from equiformer_tpu_torch.kernels import dtp as kd

    irr, sh, fold = K6_PLANS[plan]
    dt = getattr(torch, dtype)
    tl = kd.TermList.for_plan(depthwise_tp(Irreps(irr), Irreps(sh), Irreps(irr)), fold)
    members = (tl, kd.perm_a(tl), kd.perm_b(tl), kd.perm_r_a(tl), kd.perm_r_b(tl), kd.perm_r_d(tl),
               kd.perm_a(kd.perm_r_a(tl)))
    reset_launch_counts()
    n = {"t": 0, "r": 0, "fb": 0}
    for E in K6_EDGES:
        for case in K6_BROADCAST if E == 301 else ("none", "a-row"):
            a, col, b, d = _k6_broadcast(tl, dev, dt, case, E)
            lanes = {0: a, 1: b, 2: d}  # the plan's lane operands x, w, z by slot
            for member in members:
                m_ops = (lanes[member.slots[0]], col, lanes[member.slots[1]])
                k = kd.dtp_t(member, *m_ops)
                p = kd.dtp_t_plain(member, *m_ops)
                torch.cuda.synchronize()
                assert k.dtype == dt and k.shape == p.shape == (E, member.d_out)
                if E:
                    assert _rel(k, p) < TOL[dtype], (member.slots, E, case)
                    assert torch.equal(k, kd.dtp_t(member, *m_ops))
                    n["t"] += 2
            for member in members:  # R's d is a whole [E, d_out] operand
                r_ops = (lanes[member.slots[0]], lanes[member.slots[1]],
                         lanes[member.slots[2]].expand(E, member.d_out))
                k = kd.dtp_r(member, *r_ops)
                assert k.dtype == dt and k.shape == (E, member.d_col)
                if E:
                    assert _rel(k, kd.dtp_r_plain(member, *r_ops)) < TOL[dtype], (member.slots,
                                                                                  E, case)
                    assert torch.equal(k, kd.dtp_r(member, *r_ops))
                    fb_m = kd.dtp_fused_bwd(member, r_ops[0], col, r_ops[1], r_ops[2])
                    assert torch.equal(k, fb_m[1]), (member.slots, E, case)
                    n["r"] += 2
                    n["fb"] += 1
            fb = kd.dtp_fused_bwd(tl, a, col, b, d)
            if not E:
                continue
            for x, y in zip(fb, kd.dtp_fused_bwd_plain(tl, a, col, b, d)):
                assert x.dtype == dt and x.shape == y.shape and _rel(x, y) < TOL[dtype]
            assert all(torch.equal(x, y) for x, y in zip(fb, kd.dtp_fused_bwd(tl, a, col, b, d)))
            assert torch.equal(fb[0], kd.dtp_t(kd.perm_a(tl), d, col, b)), (E, case)
            assert torch.equal(fb[2], kd.dtp_t(kd.perm_b(tl), a, col, d)), (E, case)
            n["t"] += 2
            n["fb"] += 2
    assert (kd.dtp_t.launches, kd.dtp_r.launches, kd.dtp_fused_bwd.launches) == (
        n["t"], n["r"], n["fb"])


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
                 nodes_per_graph=30, higher_order_grads=False)


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

    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, dense_slots=30, shuffle=False)))
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
    batch = next(iter(GraphLoader(md17_like_dataset(4, seed=0), 4, dense_slots=21, shuffle=False,
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
    "one-group": (IRR, SH, ["6x0e"], 8),  # its tiles uncut: the legs write once
    "l3": (L3_IRR, L3_SH, ["36x0e+8x1e+8x2e+4x3e", "8x0e"], 16),
}
# the folded sites of the two paths at full width (hd 64): K7-B runs at
# QM9's (the edge degree with its row-broadcast x), the K7 legs at MD17's
RAD_QM9_SITES = {
    "qm9-sep_act": ("128x0e+64x1e+32x2e", SH, ["224x0e+64x1e+32x2e", "128x0e"], 64),
    "qm9-edge_deg": ("128x0e+64x1e+32x2e", SH, ["128x0e+64x1e+32x2e"], 64),
}
RAD_MD17_SITES = {
    "md17-sep_act": ("128x0e+64x1e+64x2e+32x3e", L3_SH, ["288x0e+64x1e+64x2e+32x3e", "128x0e"],
                     64),
    "md17-edge_deg": ("128x0e+64x1e+64x2e+32x3e", L3_SH, ["128x0e+64x1e+64x2e+32x3e"], 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("plan_name",
                         list(RAD_PLANS) + list(RAD_QM9_SITES) + list(RAD_MD17_SITES))
def test_radial_fold_kernels_match_plain(dev, plan_name, dtype, monkeypatch):
    """K7-F, K7-B and K7-B3 against dtp_lin_rad_plain, dtp_lin_rad_bwd_plain
    and dtp_lin_rad_bwd3_plain on the same operands, at small plans, the
    QM9 flagship's folded sites (the edge degree's x a broadcast row) and
    MD17 L3's sep_act and edge degree, with n_edges below E (the padded rows
    get zeros and add nothing to d[Wr; offset]); K7-B3 with every set of two
    or three of dx, dsh and dh, and with [Wr; 0]; K7-F also with [Wr; 0]
    (as a tangent in h's slot gives it) and with x read through L2 wherever
    its wrapper would stage it; two calls give the same bits.  (K7-B, the
    first-order backward, runs on the QM9 paths only: its fp32 tile at MD17
    L3's width exceeds a block's shared memory.)"""
    from equiformer_tpu_torch.kernels import (
        dtp_lin_rad_bwd, dtp_lin_rad_bwd3, dtp_lin_rad_bwd3_plain, dtp_lin_rad_bwd_plain,
        dtp_lin_rad_fwd, dtp_lin_rad_plain,
    )
    kdl = importlib.import_module("equiformer_tpu_torch.kernels.dtp_lin")

    irr, sh_irr, heads, hd = {**RAD_PLANS, **RAD_QM9_SITES, **RAD_MD17_SITES}[plan_name]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    plan = DTPLinPlan(depthwise_tp(Irreps(irr), Irreps(sh_irr), Irreps(irr)), heads,
                      radial_fold=hd)
    assert plan.dw_has_dead_cols == (plan_name in ("dead-w-cols", "one-group"))
    E = 300
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if plan_name.endswith("edge_deg") else \
        rnd(E, plan.d_x)
    sh, h, W, cot = rnd(E, plan.d_sh), rnd(E, hd), rnd(plan.w_numel), rnd(E, plan.d_out)
    Wrs = plan.pack_radial(0.3 * rnd(hd, plan.d_w), 0.3 * rnd(plan.d_w))
    Wr0 = torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])
    n = torch.tensor(250, dtype=torch.int32, device=dev)
    shape = kdl._k7f_launch_shape  # the wrapper's choice, and x through L2 regardless

    def fwd_l2(Wl):
        with monkeypatch.context() as m:
            m.setattr(kdl, "_k7f_launch_shape", lambda *a: (16, True))
            return dtp_lin_rad_fwd(plan, x, sh, h, Wl, W, n)

    reset_launch_counts()
    calls = {
        "fwd": (lambda: dtp_lin_rad_fwd(plan, x, sh, h, Wrs, W, n),
                lambda: dtp_lin_rad_plain(plan, x, sh, h, Wrs, W, n)),
        "fwd-Wr0": (lambda: dtp_lin_rad_fwd(plan, x, sh, h, Wr0, W, n),
                    lambda: dtp_lin_rad_plain(plan, x, sh, h, Wr0, W, n)),
        "fwd-x-L2": (lambda: fwd_l2(Wrs), lambda: dtp_lin_rad_plain(plan, x, sh, h, Wrs, W, n)),
        "bwd": (lambda: dtp_lin_rad_bwd(plan, x, sh, h, Wrs, W, cot, n),
                lambda: dtp_lin_rad_bwd_plain(plan, x, sh, h, Wrs, W, cot, n)),
        "bwd3": (lambda: dtp_lin_rad_bwd3(plan, x, sh, h, Wrs, W, cot, n),
                 lambda: dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wrs, W, cot, n)),
        "bwd3-Wr0": (lambda: dtp_lin_rad_bwd3(plan, x, sh, h, Wr0, W, cot, n),
                     lambda: dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wr0, W, cot, n)),
    }
    for need in (("sh", "h"), ("x", "h"), ("x", "sh")):  # the two-output sets
        flags = {f"need_d{k}": k in need for k in ("x", "sh", "h")}
        calls["bwd3-" + "-".join(need)] = (
            lambda flags=flags: dtp_lin_rad_bwd3(plan, x, sh, h, Wrs, W, cot, n, **flags),
            lambda need=need: tuple(o if k in need else None for k, o in zip(
                ("x", "sh", "h"), dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wrs, W, cot, n))))
    if plan_name.startswith("md17"):
        del calls["bwd"]
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
    assert kdl._k7f_launch_shape is shape
    assert (dtp_lin_rad_fwd.launches, dtp_lin_rad_bwd.launches,
            dtp_lin_rad_bwd3.launches) == (6, 2 * ("bwd" in calls), 10)


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
    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, dense_slots=30, shuffle=False)))
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
    mb = next(iter(GraphLoader(md17_like_dataset(4, num_atoms=21, seed=0), 4, dense_slots=21,
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("plan_name", list(RAD_PLANS) + list(RAD_MD17_SITES))
def test_radial_fold_leg_kernels_match_plain(dev, plan_name, dtype):
    """K7-L (each of the x, sh and h legs, without the operand of that leg,
    with [Wr; offset] and with [Wr; 0]; a one-group plan's tiles whole),
    K7-LW (with [Wr; offset], and with [Wr; 0] as the grad-of-grad passes it
    when h's slot holds a tangent: the offset is read from the operand, not
    assumed, so the two differ) and K7-Wr (with h's ones column 1, and 0 as
    when h's slot holds a cotangent) against their plain versions on the
    same operands, at small plans and MD17 exp_l3's folded sites, with a
    row-broadcast x and n_edges below E: rows past n_edges get zeros and add
    nothing to d[Wr; offset]; w columns of no live group get an exact 0;
    second calls give the same bits."""
    from equiformer_tpu_torch.kernels import (
        dtp_lin_rad_leg, dtp_lin_rad_leg_plain, dtp_lin_rad_legW, dtp_lin_rad_legW_plain,
        dtp_lin_rad_legWr, dtp_lin_rad_legWr_plain,
    )

    irr, sh_irr, heads, hd = {**RAD_PLANS, **RAD_MD17_SITES}[plan_name]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(4)
    plan = DTPLinPlan(depthwise_tp(Irreps(irr), Irreps(sh_irr), Irreps(irr)), heads,
                      radial_fold=hd)
    E = 300
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    sh, h, W, cot = rnd(E, plan.d_sh), rnd(E, hd), rnd(plan.w_numel), rnd(E, plan.d_out)
    Wrs = plan.pack_radial(0.3 * rnd(hd, plan.d_w), 0.3 * rnd(plan.d_w))
    n = torch.tensor(250, dtype=torch.int32, device=dev)
    reset_launch_counts()
    Wr0 = torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])
    for x in (rnd(E, plan.d_x), rnd(1, plan.d_x).expand(E, plan.d_x)):
        for leg in ("x", "sh", "h"):
            ops = {"x": x, "sh": sh, "h": h, leg: None}
            for Wl in (Wrs, Wr0):
                call = lambda: dtp_lin_rad_leg(plan, leg, cot, ops["x"], ops["sh"],  # noqa: E731
                                               ops["h"], Wl, W, n)
                k = call()
                p = dtp_lin_rad_leg_plain(plan, leg, cot, ops["x"], ops["sh"], ops["h"], Wl, W,
                                          n)
                torch.cuda.synchronize()
                assert k.dtype == dt and k.shape == p.shape, leg
                assert _rel(k, p) < TOL[dtype], leg
                assert float(k[250:].abs().max()) == 0.0, leg
                assert torch.equal(k, call()), leg
        dWs = []
        for Wl in (Wrs, torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])):
            k = dtp_lin_rad_legW(plan, cot, x, sh, h, Wl, n)
            p = dtp_lin_rad_legW_plain(plan, cot, x, sh, h, Wl, n)
            torch.cuda.synchronize()
            assert k.dtype == torch.float32 and k.shape == (plan.w_numel,)
            assert _rel(k, p) < TOL[dtype]
            assert torch.equal(k, dtp_lin_rad_legW(plan, cot, x, sh, h, Wl, n))
            dWs.append(k)
        assert not torch.equal(*dWs)
        dead = torch.ones(plan.d_w, dtype=torch.bool, device=dev)
        dead[plan.radial_cols(dev)] = False
        assert bool(dead.any()) == (plan_name in ("dead-w-cols", "one-group"))
        for ones in (True, False):
            k = dtp_lin_rad_legWr(plan, cot, x, sh, h, W, n, ones)
            p = dtp_lin_rad_legWr_plain(plan, cot, x, sh, h, W, n, ones)
            torch.cuda.synchronize()
            assert k.dtype == torch.float32 and k.shape == (hd + 1, plan.d_w)
            assert _rel(k, p) < TOL[dtype]
            assert (float(k[-1].abs().max()) == 0.0) == (not ones)
            assert float(k[:, dead].abs().sum()) == 0.0
            assert torch.equal(k, dtp_lin_rad_legWr(plan, cot, x, sh, h, W, n, ones))
        # padded rows add nothing, to the offset row too
        far = torch.where(torch.arange(E, device=dev)[:, None] < 250, cot, 100 * cot)
        assert torch.equal(dtp_lin_rad_legWr(plan, far, x, sh, h, W, n),
                           dtp_lin_rad_legWr(plan, cot, x, sh, h, W, n))
    assert (dtp_lin_rad_leg.launches, dtp_lin_rad_legW.launches,
            dtp_lin_rad_legWr.launches) == (24, 8, 12)


@pytest.mark.cuda
def test_reduced_folded_md17_train_step_on_card_matches_cpu(dev):
    """One fp32 force training step of a reduced L3 model with
    ``radial_fold`` and ``radial_fold_ho`` (2 blocks, exp basis, force_weight
    80) on the card against the CPU plain path: loss and gradient norm
    within 1e-3 relative and the updated parameters within 1e-3 of the
    largest, the bounds of the unfolded step's test; the 3 folded sites run
    on K7-F / K7-B3 / K7-L / K7-LW / K7-Wr and the 2 shared-weight ones on
    K1 / K5a / K5b / K5c; two steps from one state give the same bits."""
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
               radial_fold=True, radial_fold_ho=True)
    batch = next(iter(GraphLoader(md17_like_dataset(4, seed=0), 4, dense_slots=21, shuffle=False,
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
    # per folded site (the edge degree, each block's sep_act) what the
    # unfolded per-edge-w site launches on K1 / K5a / K5b / K5c goes to K7-F
    # / K7-B3 / K7-L / K7-LW, and each K7-LW has a K7-Wr beside it; the 2
    # sep_value sites keep 3 K1, 1 K5a, 2 K5b, 3 K5c each (counted on the CPU)
    c = launch_counts()
    assert (c["dtp_lin_fwd"], c["dtp_lin_bwd3"], c["dtp_lin_leg"], c["dtp_lin_legW"]) \
        == (6, 2, 4, 6)
    assert (c["dtp_lin_rad_fwd"], c["dtp_lin_rad_bwd3"], c["dtp_lin_rad_leg"],
            c["dtp_lin_rad_legW"], c["dtp_lin_rad_legWr"]) == (11, 6, 11, 11, 11)
    (mc, pc), (mg, pg), (mg2, pg2) = results
    for k in ("loss", "grad_norm"):
        assert abs(mg[k] - mc[k]) < 1e-3 * abs(mc[k])
    scale = max(float(p.abs().max()) for p in pc.values())
    assert max(float((pg[n] - pc[n]).abs().max()) for n in pc) < 1e-3 * scale
    assert mg == mg2 and all(torch.equal(pg[n], pg2[n]) for n in pg)


# The kron-basis op (K8): Kop = sh x w times G, the CG coefficients folded
# into the packed W.  (irreps, SH, heads, shared weights, row-broadcast x)
# of the QM9 flagship's three sites at small widths, a plan whose w columns
# partly feed no head, plans whose muls and head columns are not multiples
# of 8 (K8-B pads Kop rows and G columns to the mma steps), and the
# flagship's sites at full width (the widest (g, k) 896 Kop rows by 352
# columns)
KRON_SITES = {
    "sep_act": (IRR, SH, ["14x0e+4x1e+2x2e", "6x0e"], False, False),
    "sep_value": (IRR, SH, ["14x0e+4x1e+2x2e"], True, False),
    "edge_deg": (IRR, SH, ["14x0e+4x1e+2x2e"], False, True),
    "dead-w-cols": (IRR, SH, ["5x0e+3x1e"], False, False),
    "odd-two-head": ("4x0e+2x1e", "1x0e+1x1e", ["4x0e+2x1e", "3x0e"], False, False),
    "odd-shared-w": ("4x0e+2x1e", "1x0e+1x1e", ["3x0e+5x1e"], True, False),
    "odd-broadcast-x": ("4x0e+2x1e", "1x0e+1x1e", ["4x0e+2x1e", "3x0e"], False, True),
    "qm9-sep_act": ("128x0e+64x1e+32x2e", SH, ["224x0e+64x1e+32x2e", "128x0e"], False, False),
    "qm9-sep_value": ("128x0e+64x1e+32x2e", SH, ["128x0e+64x1e+32x2e"], True, False),
    "qm9-edge_deg": ("128x0e+64x1e+32x2e", SH, ["128x0e+64x1e+32x2e"], False, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("site", list(KRON_SITES))
def test_kron_kernels_match_plain(dev, site, dtype):
    """K8-F and K8-B against dtp_lin_kron_plain and dtp_lin_kron_bwd_plain on
    the same operands (G from build_G), E = 300 with n_edges 250: out, dx,
    dw and dG within the dtype's bound, rows past n_edges zero (the last
    live tile is partly dead, the tiles past it skipped), dG fp32, the same
    bits in a second call (K8-F's too) and with the cotangent's rows past
    n_edges x 100 (they add nothing to dG)."""
    from equiformer_tpu_torch.kernels import (
        dtp_lin_kron_bwd, dtp_lin_kron_bwd_plain, dtp_lin_kron_fwd, dtp_lin_kron_plain, kron_meta,
    )

    irr, sh_irr, heads, shared, broadcast = KRON_SITES[site]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(4)
    plan = DTPLinPlan(depthwise_tp(Irreps(irr), Irreps(sh_irr), Irreps(irr)), heads,
                      shared_weights=shared)
    meta = kron_meta(plan)
    E = 300
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    sh, cot = rnd(E, plan.d_sh), rnd(E, plan.d_out)
    w = None if shared else rnd(E, plan.d_w)  # shared weights: folded into W, so into G
    G = meta.build_G(rnd(plan.w_numel))
    n = torch.tensor(250, dtype=torch.int32, device=dev)
    reset_launch_counts()
    k = dtp_lin_kron_fwd(meta, x, sh, w, G, n)
    p = dtp_lin_kron_plain(meta, x, sh, w, G, n)
    torch.cuda.synchronize()
    assert _rel(k, p) < TOL[dtype] and float(k[250:].abs().max()) == 0.0
    assert torch.equal(k, dtp_lin_kron_fwd(meta, x, sh, w, G, n))
    k = dtp_lin_kron_bwd(meta, x, sh, w, G, cot, n)
    p = dtp_lin_kron_bwd_plain(meta, x, sh, w, G, cot, n)
    torch.cuda.synchronize()
    assert k[2].dtype == torch.float32 and (k[1] is None) == shared
    for a, b in zip(k, p):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a, b) < TOL[dtype]
            if a.shape[0] == E:
                assert float(a[250:].abs().max()) == 0.0
    far = torch.where(torch.arange(E, device=dev)[:, None] < 250, cot, 100 * cot)
    for again in (dtp_lin_kron_bwd(meta, x, sh, w, G, cot, n),
                  dtp_lin_kron_bwd(meta, x, sh, w, G, far, n)):
        assert all(a is None or torch.equal(a, b) for a, b in zip(k, again))
    assert (dtp_lin_kron_fwd.launches, dtp_lin_kron_bwd.launches) == (2, 3)


@pytest.mark.cuda
def test_reduced_kron_train_step_on_card_matches_cpu(dev):
    """One fp32 training step of the reduced QM9 model with ``kron_g=True``
    (alpha dropout from injected masks) on the card against the CPU plain
    path, within 1e-4 as the fused route's; per step one K8-F and one K8-B at
    each of the 5 fused sites, no K1 / K2; a second step from the same
    weights gives the same bits."""
    import equiformer_tpu_torch as pt
    from equiformer_tpu_torch.data import GraphLoader, qm9_like_dataset
    from equiformer_tpu_torch.kernels import launch_counts
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer

    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, dense_slots=30, shuffle=False)))
    keep = [torch.rand(1024, 4, generator=torch.Generator().manual_seed(i)) < 0.8
            for i in range(2)]
    results = []
    for d in ("cpu", dev, dev):
        model = GraphAttentionTransformer(**QM9_SMALL, kron_g=True).to(d)
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000))
        step, _ = pt.make_qm9_steps(model, opt)
        reset_launch_counts()
        state, m = step(pt.TrainState.create(model, opt), batch.to(d), iter(keep))
        results.append(({k: float(v) for k, v in m.items()},
                        {n: p.detach().cpu() for n, p in model.named_parameters()}))
    c = launch_counts()
    assert (c["dtp_lin_kron_fwd"], c["dtp_lin_kron_bwd"], c["dtp_lin_fwd"], c["dtp_lin_bwd"],
            c["attn_combine"]) == (5, 5, 0, 0, 2)
    (mc, pc), (mg, pg), (mg2, pg2) = results
    for k in ("loss", "grad_norm"):
        assert abs(mg[k] - mc[k]) < 1e-4 * abs(mc[k])
    scale = max(float(p.abs().max()) for p in pc.values())
    assert max(float((pg[n] - pc[n]).abs().max()) for n in pc) < 1e-4 * scale
    assert mg == mg2 and all(torch.equal(pg[n], pg2[n]) for n in pg)


# ------------------------------------------------------ measurement kernels
# S2: fp32 within 1e-5 relative (the kernel's FMA rounds once where the plain
# version rounds the product and the sum), bf16 within 1e-2; S1-F exact up
# to the dtype's bound; S1-A dense gives K6-T's bits; S3's full stage gives
# K2's bits, its dW stages K2's dW.
FMA_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
FMA_SHAPES = {"narrow": (512, 128, 512), "ragged-tail": (37, 129, 64)}
FLOOR_SHAPES = {"flagship": (300, 480, 9, 960, 3136), "unaligned": (77, 131, 4, 133, 201)}
L2_FLAGSHIP = "128x0e+64x1e+32x2e"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", list(FMA_SHAPES))
def test_fma_probe_matches_plain(dev, shape, dtype):
    from equiformer_tpu_torch.kernels import fma_probe, fma_probe_plain

    rows, width, k = FMA_SHAPES[shape]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(6)
    x = (1.0 + 0.1 * torch.randn(rows, width, generator=g)).to(dev, dt)
    reset_launch_counts()
    got = fma_probe(x, k)
    want = fma_probe_plain(x, k)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == dt
    assert _rel(got, want) < FMA_TOL[dtype]
    assert fma_probe.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", [*FMA_SHAPES, "one-chunk-and-tail"])
def test_fma_probe_gives_the_first_designs_bits(dev, shape, dtype):
    """The kernel (32 chains a thread in fp32, 8 in bf16) in every bit
    against the first design, itself against the plain version: each
    element runs the same chain of FMAs whatever the mapping.  The odd
    shapes leave a tail after the last whole chunk."""
    from equiformer_tpu_torch.kernels import fma_probe, fma_probe_plain
    from equiformer_tpu_torch.kernels.peaks import fma_probe_first

    rows, width, k = FMA_SHAPES.get(shape, (3, 1100, 33))
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(7)
    x = (1.0 + 0.1 * torch.randn(rows, width, generator=g)).to(dev, dt)
    first = fma_probe_first(x, k)
    assert _rel(first, fma_probe_plain(x, k)) < FMA_TOL[dtype]
    assert torch.equal(fma_probe(x, k), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", list(FLOOR_SHAPES))
def test_dtp_t_floor_matches_plain(dev, shape, dtype):
    """S1-F equals its plain version; a NaN in one edge's inputs (past the
    128 columns the output reads) turns that edge tile's output to NaN and
    leaves the other tiles alone."""
    from equiformer_tpu_torch.kernels import dtp_t_floor, dtp_t_floor_plain

    E, d_x, d_sh, d_w, d_z = FLOOR_SHAPES[shape]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(7)
    x, sh, w = (torch.randn(E, d, generator=g).to(dev, dt) for d in (d_x, d_sh, d_w))
    reset_launch_counts()
    got = dtp_t_floor(x, sh, w, d_z)
    want = dtp_t_floor_plain(x, sh, w, d_z)
    torch.cuda.synchronize()
    assert got.shape == (E, d_z) and torch.equal(got, want)
    x[20, d_x - 1] = float("nan")  # edge 20 lies in the tile of edges 16-31
    got = dtp_t_floor(x, sh, w, d_z)
    assert bool(got[16:32].isnan().all())
    assert torch.equal(got[:16], want[:16]) and torch.equal(got[32:], want[32:])
    assert dtp_t_floor.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("irreps", [IRR, L2_FLAGSHIP])
def test_dtp_t_staged_matches_plain_and_k6t(dev, irreps, dtype):
    """S1-A in both layouts against its plain version, at the small widths
    and kbench's (the flagship's), 301 edges (a partial last tile); the
    dense layout is K6-T's function summed in K6-T's order: the same bits
    as dtp_t at every edge tile, and the slot layout's padding is zero."""
    from equiformer_tpu_torch.kernels import dtp as kd
    from equiformer_tpu_torch.kernels import dtp_t_staged, dtp_t_staged_plain, make_layouts

    dt = getattr(torch, dtype)
    tp = depthwise_tp(Irreps(irreps), Irreps(SH), Irreps(irreps))
    tl = kd.TermList.for_plan(tp, True)
    z_slots = make_layouts(tp)[4]
    a, col, b, _ = _k6_operands(tl, dev, dt, E=301, seed=8)
    reset_launch_counts()
    for slots in (None, z_slots):
        got = dtp_t_staged(tl, a, col, b, slots)
        want = dtp_t_staged_plain(tl, a, col, b, slots)
        torch.cuda.synchronize()
        assert got.shape == want.shape and _rel(got, want) < TOL[dtype]
    assert got.shape[1] == 128 * len(z_slots)
    pad = torch.ones(got.shape[1], dtype=torch.bool)
    for slot, mul in z_slots.values():
        pad[slot:slot + mul] = False
    assert float(got[:, pad.to(dev)].abs().max()) == 0.0
    k6t = kd.dtp_t(tl, a, col, b)
    for tile in (None, 1, 2, 4, 8):
        assert torch.equal(dtp_t_staged(tl, a, col, b, tile=tile), k6t), tile
    assert dtp_t_staged.launches == 7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("case", ["two-head", "shared-w", "flagship"])
def test_dtp_lin_bwd_stages_match_k2(dev, case, dtype):
    """S3: the full stage gives dtp_lin_bwd's bits; the stages from the
    transposes on (K2's first launch whole) K2's dx and dw bits with dW =
    0; the earlier stages zeros; every stage within the dtype's bound of
    its plain version."""
    from equiformer_tpu_torch.kernels import dtp_lin_bwd_stage, dtp_lin_bwd_stage_plain
    from equiformer_tpu_torch.kernels.dtp_lin import DXDW_STAGE, FULL_STAGE

    irreps, (heads, shared, _) = ((L2_FLAGSHIP, (["224x0e+64x1e+32x2e", "128x0e"], False, False))
                                  if case == "flagship" else (IRR, HEADS[case]))
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(9)
    plan = DTPLinPlan(depthwise_tp(Irreps(irreps), Irreps(SH), Irreps(irreps)), heads,
                      shared_weights=shared)
    E = 300
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x, sh, cot = rnd(E, plan.d_x), rnd(E, plan.d_sh), rnd(E, plan.d_out)
    w = None if shared else rnd(E, plan.d_w)
    W = 0.2 * rnd(plan.w_numel)
    n = torch.tensor(250, dtype=torch.int32, device=dev)
    ref = dtp_lin_bwd(plan, x, sh, w, W, cot, n)
    reset_launch_counts()
    for stage in range(FULL_STAGE + 1):
        got = dtp_lin_bwd_stage(plan, x, sh, w, W, cot, stage, n)
        want = dtp_lin_bwd_stage_plain(plan, x, sh, w, W, cot, stage, n)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.shape == b.shape and _rel(a, b) < TOL[dtype]
        if stage == FULL_STAGE:
            assert all(a is None or torch.equal(a, b) for a, b in zip(got, ref))
        else:
            assert float(got[2].abs().max()) == 0.0
            if stage >= DXDW_STAGE:
                assert torch.equal(got[0], ref[0])
                assert got[1] is None or torch.equal(got[1], ref[1])
            else:
                assert float(got[0].abs().max()) == 0.0
                assert got[1] is None or float(got[1].abs().max()) == 0.0
    assert dtp_lin_bwd_stage.launches == FULL_STAGE + 1


def _sorted_dst(E, N, n_real, seed, long_node=None):
    """A dst-sorted edge list with its mask, as the radius graph lays it
    out: n_real live edges over nodes 0..N-2 (some nodes without edges; the
    node ``long_node``, if given, with 2000 of them, masked every 7th),
    then the padding edges, masked, on the last node."""
    g = torch.Generator().manual_seed(seed)
    live = torch.sort(torch.randint(0, N - 1, (n_real,), generator=g)).values
    live = live[(live % 11) != 5]  # nodes without edges
    mask = torch.ones(live.shape[0], dtype=torch.bool)
    if long_node is not None:
        live = torch.sort(torch.cat([live, torch.full((2000,), long_node)])).values
        mask = torch.ones(live.shape[0], dtype=torch.bool)
        first = int((live < long_node).sum())
        mask[first : first + 2000 : 7] = False
    dst = torch.cat([live, torch.full((E - live.shape[0],), N - 1)])
    mask = torch.cat([mask, torch.zeros(E - live.shape[0], dtype=torch.bool)])
    return dst, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", [
    "qm9-edge_deg", "qm9-gather", "md17-edge_deg", "md17-attn", "md17-gather", "odd-C",
    "unaligned", "long", "int32-dst",
])
def test_csr_segment_sum_matches_plain_at_path_shapes(dev, shape, dtype):
    """K3 at the QM9 shapes (E = 36352, C = 480, N = 3840; masked, and the
    gathers' backward unmasked with ~6400 edges on the last node) and the
    three MD17 ones (E = 2944, C = 864 or [4, 216], N = 168), an odd C and
    an unaligned val (one scalar column a lane), a node with more edges
    than a warp's 512-edge round, int32 dst:
    within the dtype's bound of its plain version, one launch a call, the
    same bits twice."""
    from equiformer_tpu_torch.kernels.segment_csr import vector_width

    dt = getattr(torch, dtype)
    E, N, C, n_real = (36352, 3840, 480, 32888) if shape.startswith("qm9") else (
        2944, 168, 864, 2800)
    if shape == "odd-C":
        C = 161
    if shape == "long":
        n_real = 800  # + the long node's 2000
    dst, mask = _sorted_dst(E, N, n_real, 11, long_node=50 if shape == "long" else None)
    if shape.endswith("gather"):
        mask = None  # the padding edges on the last node are summed too
    if shape == "int32-dst":
        dst = dst.int()
    g = torch.Generator().manual_seed(12)
    val = torch.randn(E, C, generator=g).to(dev, dt)
    if shape == "unaligned":
        buf = torch.empty(E * C + 1, dtype=dt, device=dev)
        buf[1:].copy_(val.reshape(-1))
        val = buf[1:].view(E, C)
    assert (vector_width(C, val.element_size(), val.data_ptr(), 0) == 1) == (
        shape in ("odd-C", "unaligned"))
    dst = dst.to(dev)
    mask = None if mask is None else mask.to(dev)
    reset_launch_counts()
    got = csr_segment_sum(val, dst, N, mask)
    again = csr_segment_sum(val, dst, N, mask)
    want = segment_sum_plain(val, dst.long(), N, mask)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == 2 and torch.equal(got, again)
    assert _rel(got, want) < TOL[dtype]
    if mask is not None:
        assert float(got[N - 1].abs().max()) == 0.0  # the padding node: all masked


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("site", ["sep_act", "sep_value", "edge_deg"])
@pytest.mark.parametrize("rows", ["qm9", "ragged", "none-live"])
def test_dtp_lin_bwd_at_the_qm9_sites(dev, site, rows, dtype):
    """K2 at the QM9 flagship's three sites: E = 36352 with the batch's
    32888 live rows; E = 1013 (a multiple of neither tile, 16 or 64 edges)
    with n_edges = 997; n_edges = 0.  dx, dw, dW within the dtype's bound
    of the plain version, rows past n_edges zero, two calls bitwise equal."""
    emb = Irreps(L2_FLAGSHIP)
    heads = ["224x0e+64x1e+32x2e", "128x0e"] if site == "sep_act" else [L2_FLAGSHIP]
    plan = DTPLinPlan(depthwise_tp(emb, Irreps(SH), emb), heads,
                      shared_weights=site == "sep_value")
    E, n_live = {"qm9": (36352, 32888), "ragged": (1013, 997), "none-live": (1013, 0)}[rows]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(13)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if site == "edge_deg" else rnd(E, plan.d_x)
    sh, cot, W = rnd(E, plan.d_sh), rnd(E, plan.d_out), 0.05 * rnd(plan.w_numel)
    w = None if plan.shared_weights else rnd(E, plan.d_w)
    n = torch.tensor(n_live, dtype=torch.int32, device=dev)
    reset_launch_counts()
    k = dtp_lin_bwd(plan, x, sh, w, W, cot, n)
    again = dtp_lin_bwd(plan, x, sh, w, W, cot, n)
    p = dtp_lin_bwd_plain(plan, x, sh, w, W, cot, n)
    torch.cuda.synchronize()
    assert dtp_lin_bwd.launches == 2
    for a, b, c in zip(k, p, again):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert torch.equal(a, c)
        if n_live:
            assert _rel(a, b) < TOL[dtype]
        else:
            assert float(a.abs().max()) == 0.0
    assert float(k[0][n_live:].abs().max()) == 0.0
    assert k[1] is None or float(k[1][n_live:].abs().max()) == 0.0


MD17_L3 = "128x0e+64x1e+64x2e+32x3e"
# the fused DTP's sites on the two paths at full width: (node irreps, SH,
# heads, shared weights, row-broadcast x, E and live rows of the path)
K1_SITES = {
    "qm9-sep_act": (L2_FLAGSHIP, SH, ["224x0e+64x1e+32x2e", "128x0e"], False, False,
                    (36352, 32888)),
    "qm9-sep_value": (L2_FLAGSHIP, SH, [L2_FLAGSHIP], True, False, (36352, 32888)),
    "qm9-edge_deg": (L2_FLAGSHIP, SH, [L2_FLAGSHIP], False, True, (36352, 32888)),
    "md17-sep_act": (MD17_L3, L3_SH, ["288x0e+64x1e+64x2e+32x3e", "128x0e"], False, False,
                     (2944, 2922)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("site", list(K1_SITES))
@pytest.mark.parametrize("rows", ["path", "ragged"])
def test_dtp_lin_fwd_at_the_path_sites(dev, site, rows, dtype):
    """K1 at the QM9 flagship's three sites and MD17 L3's sep_act (32-edge
    tiles in fp32 at QM9, 16 elsewhere): the path's E and live rows, and E =
    1013 (a multiple of neither tile) with n_edges = 997.  Within the dtype's
    bound of the plain version, rows past n_edges zero, one launch a call,
    two calls bitwise equal."""
    irr, sh_irr, heads, shared, broadcast, path_rows = K1_SITES[site]
    emb = Irreps(irr)
    plan = DTPLinPlan(depthwise_tp(emb, Irreps(sh_irr), emb), heads, shared_weights=shared)
    E, n_live = path_rows if rows == "path" else (1013, 997)
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(14)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if broadcast else rnd(E, plan.d_x)
    sh, W = rnd(E, plan.d_sh), 0.05 * rnd(plan.w_numel)
    w = None if shared else rnd(E, plan.d_w)
    n = torch.tensor(n_live, dtype=torch.int32, device=dev)
    reset_launch_counts()
    got = dtp_lin_fwd(plan, x, sh, w, W, n)
    again = dtp_lin_fwd(plan, x, sh, w, W, n)
    want = dtp_lin_plain(plan, x, sh, w, W, n)
    torch.cuda.synchronize()
    assert dtp_lin_fwd.launches == 2 and torch.equal(got, again)
    assert _rel(got, want) < TOL[dtype]
    assert float(got[n_live:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("case", ["qm9-drop", "qm9-nodrop", "no-mask", "long", "int32-dst",
                                  "odd-D", "no-edges"])
def test_attn_combine_at_the_qm9_shape(dev, case, dtype):
    """K4 at the QM9 shape (E = 36352 with 32888 live edges, N = 3840, H =
    4, D = 120; the masked padding edges on the last node), with and without
    the dropout multiplier; without a mask (the padding edges combined), a
    node with 2000 edges, int32 dst, D = 30 (one scalar column a lane), E =
    0.  out and den within the dtype's bound of the plain versions, one
    launch a call, the same bits in two calls."""
    E, N, n_real = (0, 3840, 0) if case == "no-edges" else (36352, 3840, 32888)
    H, D = 4, 30 if case == "odd-D" else 120
    dst, mask = _sorted_dst(E, N, n_real, 21, long_node=50 if case == "long" else None)
    if case == "no-edges":
        dst, mask = dst[:0], mask[:0]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(22)
    scores = torch.randn(E, H, generator=g).to(dev, dt)
    value = torch.randn(E, H, D, generator=g).to(dev, dt)
    drop = None if case == "qm9-nodrop" else (
        (torch.rand(E, H, generator=g) < 0.8).to(dt) / 0.8).to(dev)
    dst = (dst.int() if case == "int32-dst" else dst).to(dev)
    mask = None if case == "no-mask" else mask.to(dev)
    masked = scores if mask is None else torch.where(mask[:, None], scores,
                                                     torch.full_like(scores, -1e30))
    reset_launch_counts()
    out, den = attn_combine_fwd(masked, value, dst, N, mask, drop)
    out2, den2 = attn_combine_fwd(masked, value, dst, N, mask, drop)
    torch.cuda.synchronize()
    assert attn_combine.launches == 2
    assert torch.equal(out, out2) and torch.equal(den, den2)
    assert _rel(den, attn_den_plain(masked, dst.long(), N)) < TOL[dtype]
    if E == 0:
        assert float(out.abs().max()) == 0.0
        return
    assert _rel(out, attn_combine_plain(scores, value, dst.long(), N, mask, drop)) < TOL[dtype]
    if mask is not None:
        assert float(out[N - 1].abs().max()) == 0.0  # the padding node: all masked


# ------------------------------------------------------- the packed layout

def _packed_qm9_batch(graphs, seed):
    """A packed batch at the QM9 CLI's capacities (cli/train_qm9.py:58-59)
    and its ``max_edges``."""
    from equiformer_tpu_torch.data import GraphLoader, qm9_like_dataset
    from equiformer_tpu_torch.graph.batching import cli_capacities

    nodes, max_edges = cli_capacities(graphs, 30, 17)
    batch = next(iter(GraphLoader(qm9_like_dataset(graphs, seed=seed), graphs, nodes,
                                  shuffle=False)))
    return batch, max_edges


@pytest.mark.cuda
def test_packed_radius_graph_on_card_equals_cpu_at_qm9_capacity(dev):
    """The [N, N] radius graph of 128 graphs in 3840 node rows and 65280
    edge slots: src, dst, mask and the src-sort plan on the card equal the
    CPU's element by element, with no truncation."""
    from equiformer_tpu_torch.graph.radius_graph import radius_graph, src_sort_plan

    b, max_edges = _packed_qm9_batch(128, 0)
    assert (b.pos.shape[0], max_edges) == (3840, 65280)
    cpu = radius_graph(b.pos, b.batch, b.node_mask, 5.0, max_edges)
    g = b.to(dev)
    card = radius_graph(g.pos, g.batch, g.node_mask, 5.0, max_edges)
    for k in ("src", "dst", "mask"):
        assert torch.equal(getattr(card, k).cpu(), getattr(cpu, k)), k
    for a, c in zip(src_sort_plan(card), src_sort_plan(cpu)):
        assert torch.equal(a.cpu(), c)
    assert 30000 < int(cpu.mask.sum()) < max_edges


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_src_plan_backward_runs_k3_and_repeats_its_bits(dev, dtype):
    """The gather over src of a packed edge list truncated below its real
    edges: its backward is one K3 over the sorted src, the same bits in two
    calls, within the dtype's bound of ``index_add_`` over the unsorted
    src."""
    from equiformer_tpu_torch.graph.radius_graph import radius_graph, src_sort_plan
    from equiformer_tpu_torch.graph.segment import take_src

    b, _ = _packed_qm9_batch(16, 1)
    edges = radius_graph(b.pos, b.batch, b.node_mask, 5.0, 2048)
    assert bool(edges.mask.all())  # more real edges than slots
    plan = src_sort_plan(edges)
    src, dst = edges.src.to(dev), edges.dst.to(dev)
    plan = type(plan)(*(t.to(dev) for t in plan))
    gen = torch.Generator().manual_seed(3)
    dt = getattr(torch, dtype)
    x = torch.randn(b.pos.shape[0], 480, generator=gen).to(dev, dt).requires_grad_(True)
    cot = torch.randn(2048, 480, generator=gen).to(dev, dt)

    def grad():
        (gx,) = torch.autograd.grad(take_src(x, src, dst, src_plan=plan), x, cot)
        return gx

    reset_launch_counts()
    a, c = grad(), grad()
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == 2
    assert torch.equal(a, c)
    plain = torch.zeros(x.shape, dtype=torch.float32, device=dev).index_add_(0, src, cot.float())
    assert _rel(a, plain) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_src_plan_gives_the_reverse_twins_bits_on_fixed_slots(dev, dtype):
    """On an untruncated fixed-slot edge list the src-sort plan's ids are
    dst and its order is the reverse-twin permutation on the real edges, so
    its K3 sums the rows that the twin route sums, in the same order: equal
    bits at first and second order.  (Where ``max_edges`` truncates the
    list the two differ, and the fixed-slot layout keeps the twins, which
    are the JAX package's function there.)"""
    from equiformer_tpu_torch.data import GraphLoader, qm9_like_dataset
    from equiformer_tpu_torch.graph.radius_graph import (
        radius_graph_dense, reverse_edge_perm_dense, src_sort_plan,
    )
    from equiformer_tpu_torch.graph.segment import take_src

    b = next(iter(GraphLoader(qm9_like_dataset(16, seed=4), 16, dense_slots=30,
                              shuffle=False)))
    edges = radius_graph_dense(b.pos, b.node_mask, 16, 5.0, 16 * 30 * 30)
    rev, plan = reverse_edge_perm_dense(edges, 16, 30), src_sort_plan(edges)
    real = edges.mask
    assert torch.equal(plan.ids, edges.dst) and torch.equal(plan.order[real], rev[real])
    src, dst, rev = edges.src.to(dev), edges.dst.to(dev), rev.to(dev)
    plan = type(plan)(*(t.to(dev) for t in plan))
    real = real.to(dev)[:, None]
    gen = torch.Generator().manual_seed(5)
    dt = getattr(torch, dtype)
    x = torch.randn(b.pos.shape[0], 256, generator=gen).to(dev, dt).requires_grad_(True)
    w = torch.randn(src.shape[0], 256, generator=gen).to(dev, dt)

    def grads(**route):
        y = torch.where(real, torch.sin(take_src(x, src, dst, **route)) * w, torch.zeros_like(w))
        (g,) = torch.autograd.grad(y.float().sum(), x, create_graph=True)
        (gg,) = torch.autograd.grad((g.float() ** 2).sum(), x)
        return g, gg

    twins = grads(rev=rev)
    reset_launch_counts()
    planned = grads(src_plan=plan)
    assert csr_segment_sum.launches >= 2
    for a, c in zip(planned, twins):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_packed_step_gradients_match_fixed_slot_on_card(dev):
    """A reduced QM9 model's fp32 training loss on the card (alpha dropout
    off): the parameter gradients on the packed layout within 1e-5 of the
    fixed-slot layout's on the same molecules and weights."""
    from equiformer_tpu_torch.data import GraphLoader, qm9_like_dataset
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer

    cfg = dict(irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
               fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
               num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", higher_order_grads=False,
               alpha_drop=0.0)
    packed, packed_edges = _packed_qm9_batch(8, 2)
    dense = next(iter(GraphLoader(qm9_like_dataset(8, seed=2), 8, dense_slots=30,
                                  shuffle=False)))
    grads = []
    for batch, kw in ((packed, dict(max_edges=packed_edges, nodes_per_graph=0)),
                      (dense, dict(max_edges=8 * 30 * 30, nodes_per_graph=30))):
        model = GraphAttentionTransformer(**cfg, **kw, seed=7).to(dev).train()
        b = batch.to(dev)
        loss = (model(b) - b.y).abs().mean()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    scale = max(float(g.abs().max()) for g in grads[1])
    assert max(float((p - q).abs().max()) for p, q in zip(*grads)) <= 1e-5 * scale


def _remat_qm9_setup(dev, remat, clip=None, dtype=None):
    """A reduced packed QM9 model with every dropout site on, its training
    step (AdamW, ``grad_clip_norm`` ``clip``) and state, on the card."""
    import equiformer_tpu_torch as pt
    from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer

    cfg = dict(irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
               fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
               num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", higher_order_grads=False,
               alpha_drop=0.2, proj_drop=0.1, drop_path_rate=0.1)
    batch, edges = _packed_qm9_batch(8, 2)
    model = GraphAttentionTransformer(**cfg, max_edges=edges, remat=remat, seed=7,
                                      compute_dtype=dtype).to(dev)
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000),
                              grad_clip_norm=clip)
    step, _ = pt.make_qm9_steps(model, opt)
    return model, step, pt.TrainState.create(model, opt), batch.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_qm9_step_matches_the_unrematted_step_on_card(dev, dtype):
    """One reduced QM9 step with remat and without, from one seed, dropout
    drawn from one CUDA generator seed: metrics and updated parameters
    within 1e-6 of each other (bits printed), the generators in the same
    state, and the recompute's launches on top (K1 twice per block's
    forward more)."""
    from equiformer_tpu_torch.kernels import dtp_lin_fwd

    res = []
    for remat in (False, True):
        model, step, state, batch = _remat_qm9_setup(dev, remat, dtype=None if dtype == "float32"
                                                     else dtype)
        gen = torch.Generator(device=dev).manual_seed(3)
        reset_launch_counts()
        _, m = step(state, batch, gen)
        torch.cuda.synchronize()
        res.append(({k: float(v) for k, v in m.items()},
                    [p.detach().clone() for p in model.parameters()], gen.get_state(),
                    dtp_lin_fwd.launches))
    (m0, p0, g0, k0), (m1, p1, g1, k1) = res
    bits = m0 == m1 and all(torch.equal(a, b) for a, b in zip(p0, p1))
    print(f"remat vs no remat, reduced QM9 step {dtype}: {m1} / {m0}, bits equal: {bits}, "
          f"K1 launches {k1} / {k0}")
    assert torch.equal(g0, g1)
    assert all(abs(m1[k] - m0[k]) <= 1e-6 * abs(m0[k]) for k in m0)
    scale = max(float(p.abs().max()) for p in p0)
    assert max(float((a - b).abs().max()) for a, b in zip(p0, p1)) <= 1e-6 * scale
    assert k1 == k0 + 2 * 2  # the two blocks' two K1 sites, once more


def _sync_warnings(fn):
    """The number of synchronizing CUDA calls ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.cuda
def test_grad_clip_adds_no_host_sync(dev):
    """A warm training step with a binding ``grad_clip_norm`` makes no more
    synchronizing calls than the same step without a clip; where the step
    makes none, it also runs under ``set_sync_debug_mode("error")``."""
    counts = {}
    for clip in (None, 1e-3):
        model, step, state, batch = _remat_qm9_setup(dev, True, clip)
        gen = torch.Generator(device=dev).manual_seed(3)
        step(state, batch, gen)  # the first step builds the kernels' tables
        torch.cuda.synchronize()
        counts[clip] = _sync_warnings(lambda: step(state, batch, gen))
        torch.cuda.synchronize()
        if counts[clip] == 0:
            torch.cuda.set_sync_debug_mode("error")
            try:
                step(state, batch, gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    print(f"synchronizing calls a step: no clip {counts[None]}, clip {counts[1e-3]}")
    assert counts[1e-3] <= counts[None]
