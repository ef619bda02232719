"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels have
no CPU mode).  The file imports no jax, so it also runs where only the port
is installed; ``tests/conftest.py`` imports jax, so on such a machine run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances (max |kernel - plain| / max |plain|): fp32 1e-4, the kernels and
the plain versions sum in another order; bf16 2e-2, the plain versions round
intermediates (the TP output z, the softmax weights) to bf16 and the kernels
keep them in fp32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from equiformer_tpu_torch.core import Irreps, depthwise_tp  # noqa: E402
from equiformer_tpu_torch.kernels import (  # noqa: E402
    DTPLinPlan,
    attn_combine,
    attn_combine_plain,
    csr_segment_sum,
    dtp_lin,
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
    assert dtp_lin.launches == 1
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
               num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=1024)
    batch = next(iter(GraphLoader(qm9_like_dataset(4, seed=0), 4, 30, shuffle=False)))
    cpu = GraphAttentionTransformer(**cfg).eval()
    ref = pt.evaluate(cpu, batch)["pred"]
    gpu = GraphAttentionTransformer(**cfg).to(dev).eval()
    reset_launch_counts()
    out = pt.evaluate(gpu, batch.to(dev))["pred"]
    # 1 + 2 per block DTP launches; 2 attention combines; the 60-wide edge-degree
    # scatter is under the CSR kernel's 128-column threshold
    assert (dtp_lin.launches, csr_segment_sum.launches, attn_combine.launches) == (5, 0, 2)
    assert _rel(out, ref) < 1e-4
