"""The port's measurement kernels (S1-S3) and tools against the JAX scripts.

S2: ``fma_probe``'s plain version against ``scripts/chip_peaks.py``'s
``_vpu_kernel`` under an interpret-mode ``pallas_call`` built here.  S1:
the plain versions of ``dtp_t_floor`` and ``dtp_t_staged`` (both layouts)
against the outputs of ``scripts/kbench.py``'s own ``pallas_call``s,
captured by loading the script and running its ``main()`` in interpret
mode with its ``timeit`` replaced by one call that keeps inputs and
outputs; the script's fused prototype against the port's ``dtp_lin`` on
the real rows of its weights.  S3: ``dtp_lin_bwd_stage``'s plain version
at every stage against ``jax.vjp`` of ``make_fused_dtp_lin`` in interpret
mode.  Then each tool's ``main`` at a small size on the CPU, and the
profiling utilities.  The CUDA kernels themselves are held to these plain
versions on the card by ``tests/test_torch_cuda.py``.

Tolerances, relative to the largest reference value: fp32 1e-5 (float32
sums in another order; the probe's 64 steps round the same way), bf16 1e-2.
"""

import functools
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps, depthwise_tp as j_dtp  # noqa: E402
from equiformer_tpu.kernels.dtp_lin_pallas import (  # noqa: E402
    DTPLinPlan as JPlan,
    make_fused_dtp_lin,
)
from equiformer_tpu_torch.core import Irreps, depthwise_tp  # noqa: E402
from equiformer_tpu_torch.kernels import (  # noqa: E402
    KERNEL_WRAPPERS,
    DTPLinPlan,
    TermList,
    _build,
    dtp_lin_bwd_plain,
    dtp_lin_bwd_stage,
    dtp_lin_bwd_stage_plain,
    dtp_lin_plain,
    dtp_t_floor,
    dtp_t_floor_plain,
    dtp_t_plain,
    dtp_t_staged,
    dtp_t_staged_plain,
    fma_probe,
    fma_probe_plain,
    make_layouts,
    reset_launch_counts,
)
from equiformer_tpu_torch.kernels.dtp_lin import BWD_STAGES, FULL_STAGE  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):  # see tests/test_torch_md17_train.py
    torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
NEW_KERNELS = ("fma_probe", "dtp_t_floor", "dtp_t_staged", "dtp_lin_bwd_stage")


def _rel(a, b, rows=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if rows is not None:
        a, b = a[:rows], b[:rows]
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ S2
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("width", [128, 1024], ids=["bench_vpu", "bench_vpu_wide"])
def test_fma_probe_plain_matches_chip_peaks_kernel(width, dtype):
    """The script's VPU body (``acc * 1.000001 + 0.5``, K times) in interpret
    mode at T = 8, K = 64, grid 2, on seeded normal inputs; the same inputs
    through the port's probe (its plain version on the CPU)."""
    cp = _load_script("chip_peaks")
    T, K, grid = 8, 64, 2
    jdt = getattr(jnp, dtype)
    x = np.random.default_rng(1).normal(size=(grid * T, width)).astype(np.float32)
    call = pl.pallas_call(
        functools.partial(cp._vpu_kernel, K),
        out_shape=jax.ShapeDtypeStruct((grid * T, width), jdt),
        grid=(grid,),
        in_specs=[pl.BlockSpec((T, width), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((T, width), lambda i: (i, 0)),
        interpret=True,
    )
    want = np.asarray(call(jnp.asarray(x, jdt)).astype(jnp.float32))
    reset_launch_counts()
    got = fma_probe(torch.from_numpy(x).to(getattr(torch, dtype)), K)
    assert got.dtype == getattr(torch, dtype) and fma_probe.launches == 0
    assert _rel(got.float().numpy(), want) < TOL[dtype]
    assert torch.equal(got, fma_probe_plain(torch.from_numpy(x).to(got.dtype), K))


def test_fma_probe_rounds_its_constants_to_the_dtype():
    """In bf16 the multiplier 1.000001 is 1.0, so K steps add K * 0.5."""
    x = torch.ones(4, dtype=torch.bfloat16)
    assert torch.equal(fma_probe(x, 64), torch.full((4,), 33.0, dtype=torch.bfloat16))
    assert float(fma_probe(torch.ones(1), 64)[0]) > 33.0  # fp32 keeps 1.000001


# ------------------------------------------------------------------ S1
KB_EDGES = 256


@pytest.fixture(scope="module")
def kbench_run():
    """``scripts/kbench.py``'s main in interpret mode (E = 256, tile 128,
    fp32), each timed call made once: (the module, [(fn, args, output)]) in
    the script's order: current, dmafloor, aligned-in, aligned-i/o,
    fusedlin, cur+xla-lin; and the fused prototype's output again with
    random values in its weights' pad rows.

    The aligned and fused kernels read 128-lane slots of scratch that only
    partly hold data: what the other lanes hold is undefined on the TPU, and
    this JAX's interpret mode fills fresh scratch with NaN.  The run fills
    it with zeros, where those lanes are defined: the pad columns of the
    aligned output are zero, and the pad rows of the fused weights meet
    zeros in z."""
    from jax._src.pallas import primitives as pallas_primitives

    kb = _load_script("kbench")
    calls = []

    def once(fn, *args, n=30, warmup=3):
        calls.append((fn, args, fn(*args)))
        return 1.0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_primitives, "uninitialized_value",
                   lambda shape, dtype: jnp.zeros(shape, dtype))
        mp.setattr(kb, "timeit", once)
        mp.setattr(sys, "argv", ["kbench.py", "--interpret", "--edges", str(KB_EDGES),
                                 "--tile", "128", "--fp32"])
        kb.main()
        assert len(calls) == 6
        fn, args, _ = calls[4]
        rng = np.random.default_rng(2)
        padded = []
        for W, pad in zip(args[3:], _fused_pad_rows()):
            W = np.asarray(W).copy()
            W[pad] = rng.normal(size=(len(pad), W.shape[1]))
            padded.append(jnp.asarray(W))
        repadded = np.asarray(fn(*args[:3], *padded))
    return kb, calls, repadded


def _port_tl():
    tp = depthwise_tp(Irreps("128x0e+64x1e+32x2e"), Irreps("1x0e+1x1e+1x2e"),
                      Irreps("128x0e+64x1e+32x2e"))
    return tp, TermList.for_plan(tp, fold_rescale=True)


def _fused_pad_rows():
    """Per irrep group (0e, 1e, 2e), the rows of the fused prototype's
    weights that pad each block's fan to 128."""
    tp, _ = _port_tl()
    plan = DTPLinPlan(tp, ["224x0e+64x1e+32x2e"])
    return [[128 * i + u for i, bo in enumerate(g.blocks)
             for u in range(tp.irreps_out[bo].mul, 128)] for g in plan.groups]


def _operands(call):
    return [torch.from_numpy(np.array(a)) for a in call[1][:3]]


def test_make_layouts_matches_kbench(kbench_run):
    kb = kbench_run[0]
    jtp = j_dtp(JIrreps("128x0e+64x1e+32x2e"), JIrreps("1x0e+1x1e+1x2e"),
                JIrreps("128x0e+64x1e+32x2e"))
    tp, _ = _port_tl()
    assert make_layouts(tp) == kb.make_layouts(jtp)


def test_current_is_k6t(kbench_run):
    """The script's ``current`` (JAX's PallasDTP) is the port's T."""
    calls = kbench_run[1]
    _, tl = _port_tl()
    assert _rel(dtp_t_plain(tl, *_operands(calls[0])).numpy(), calls[0][2]) < TOL["float32"]


def test_dtp_t_floor_plain_matches_kbench_dma(kbench_run):
    calls = kbench_run[1]
    x, sh, w = _operands(calls[1])
    want = np.asarray(calls[1][2])
    reset_launch_counts()
    got = dtp_t_floor(x, sh, w, want.shape[1])  # the plain version on the CPU
    assert dtp_t_floor.launches == 0 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want[:, 128:] == 0) and torch.equal(got, dtp_t_floor_plain(x, sh, w,
                                                                            want.shape[1]))


@pytest.mark.parametrize("layout", ["aligned-in", "aligned-i/o"])
def test_dtp_t_staged_plain_matches_kbench_aligned(kbench_run, layout):
    """``aligned_call(False)``: z dense; ``aligned_call(True)``: z in
    128-column slots, zero padded."""
    calls = kbench_run[1]
    call = calls[2 if layout == "aligned-in" else 3]
    tp, tl = _port_tl()
    slots = None if layout == "aligned-in" else make_layouts(tp)[4]
    want = np.asarray(call[2])
    reset_launch_counts()
    got = dtp_t_staged(tl, *_operands(call), slots)
    assert dtp_t_staged.launches == 0 and got.shape == want.shape
    assert _rel(got.numpy(), want) < TOL["float32"]
    assert torch.equal(got, dtp_t_staged_plain(tl, *_operands(call), slots))


def test_kbench_fusedlin_is_dtp_lin(kbench_run):
    """The fused prototype's per-group weights pad each block's fan to 128
    rows (random, like the rest); its output equals the port's ``dtp_lin``
    on the real rows, and new values in the pad rows leave it as it was:
    the pad lanes of z are zero (the fixture's zero scratch)."""
    _, calls, repadded = kbench_run
    _, args, out = calls[4]
    x, sh, w = _operands(calls[4])
    Ws = [np.asarray(W) for W in args[3:]]
    tp, _ = _port_tl()
    plan = DTPLinPlan(tp, ["224x0e+64x1e+32x2e"])
    flat = []
    for gi, g in enumerate(plan.groups):  # both order the groups 0e, 1e, 2e
        Wg = np.zeros((g.fan_stride, g.cols), np.float32)
        for i, bo in enumerate(g.blocks):
            mul = tp.irreps_out[bo].mul
            Wg[g.fan_slot[bo] : g.fan_slot[bo] + mul] = Ws[gi][128 * i : 128 * i + mul]
        flat.append(Wg.reshape(-1))
    got = dtp_lin_plain(plan, x, sh, w, torch.from_numpy(np.concatenate(flat)))
    assert _rel(got.numpy(), np.asarray(out)) < TOL["float32"]
    np.testing.assert_array_equal(repadded, np.asarray(out))


# ------------------------------------------------------------------ S3
S3_IRR, S3_SH = "8x0e+4x1e+2x2e", "1x0e+1x1e+1x2e"
S3_HEADS = ["14x0e+4x1e+2x2e", "6x0e"]  # two heads, as the sep_act site
S3_E, S3_REAL = 128, 100


@pytest.fixture(scope="module")
def s3_case():
    """Operands of a two-head per-edge plan and ``jax.vjp`` of the JAX fused
    op in interpret mode: dx, dw and the head weights' gradients for a
    cotangent that is zero past the real edges."""
    rng = np.random.default_rng(5)
    tp = depthwise_tp(Irreps(S3_IRR), Irreps(S3_SH), Irreps(S3_IRR))
    x = rng.normal(size=(S3_E, tp.irreps_in1.dim)).astype(np.float32)
    sh = rng.normal(size=(S3_E, tp.irreps_in2.dim)).astype(np.float32)
    w = rng.normal(size=(S3_E, tp.weight_numel)).astype(np.float32)
    head_ws = [[rng.normal(size=(sum(m for m, ir in tp.irreps_out if ir == ir_out), mul_out))
                .astype(np.float32) for mul_out, ir_out in Irreps(h)] for h in S3_HEADS]
    jplan = JPlan(j_dtp(JIrreps(S3_IRR), JIrreps(S3_SH), JIrreps(S3_IRR)),
                  [JIrreps(h) for h in S3_HEADS], fold_rescale=True, shared_weights=False)
    fused = make_fused_dtp_lin(jplan, tile=128, interpret=True)

    def f(x, w, hw):
        return fused(x, jnp.asarray(sh), w, jplan.pack_weights(hw), n_edges=S3_REAL)

    hw = [[jnp.asarray(a) for a in ws] for ws in head_ws]
    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), hw)
    g = rng.normal(size=out.shape).astype(np.float32)
    g[S3_REAL:] = 0.0
    jdx, jdw, jdhw = vjp(jnp.asarray(g))
    return (tp, x, sh, w, head_ws, g,
            (np.asarray(jdx), np.asarray(jdw), [[np.asarray(a) for a in ws] for ws in jdhw]))


@pytest.mark.parametrize("stage", range(FULL_STAGE + 1), ids=BWD_STAGES)
def test_dtp_lin_bwd_stage_plain_matches_jax_vjp(s3_case, stage):
    """The full stage gives dx, dw and dW; from the transposes on (launch 1
    whole) dx and dw with dW = 0; the earlier stages zeros."""
    tp, x, sh, w, head_ws, g, (jdx, jdw, jdhw) = s3_case
    plan = DTPLinPlan(tp, S3_HEADS)
    tws = [[torch.from_numpy(a).requires_grad_() for a in ws] for ws in head_ws]
    W = plan.pack_weights(tws)
    n = torch.tensor(S3_REAL, dtype=torch.int32)
    reset_launch_counts()
    dx, dw, dW = dtp_lin_bwd_stage(plan, torch.from_numpy(x), torch.from_numpy(sh),
                                   torch.from_numpy(w), W.detach(), torch.from_numpy(g), stage, n)
    assert dtp_lin_bwd_stage.launches == 0 and dW.dtype == torch.float32
    assert dx.shape == (S3_E, plan.d_x) and dw.shape == (S3_E, plan.d_w)
    flat = [a for ws in tws for a in ws]
    dhw = torch.autograd.grad(W, flat, dW)
    if stage >= BWD_STAGES.index("+transposes"):
        assert _rel(dx.numpy(), jdx, rows=S3_REAL) < TOL["float32"]
        assert _rel(dw.numpy(), jdw, rows=S3_REAL) < TOL["float32"]
    else:
        assert float(dx.abs().max()) == 0.0 and float(dw.abs().max()) == 0.0
    for got, want in zip(dhw, [a for ws in jdhw for a in ws]):
        if stage == FULL_STAGE:
            assert _rel(got.numpy(), want) < TOL["float32"]
        else:
            assert float(got.abs().max()) == 0.0


def test_dtp_lin_bwd_stage_full_is_k2_plain():
    """The full stage is ``dtp_lin_bwd_plain`` itself, in fp64 too, and a
    stage outside 0-6 is refused."""
    tp = depthwise_tp(Irreps(S3_IRR), Irreps(S3_SH), Irreps(S3_IRR))
    plan = DTPLinPlan(tp, S3_HEADS)
    gen = torch.Generator().manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)  # noqa: E731
    ops = (rnd(20, plan.d_x), rnd(20, plan.d_sh), rnd(20, plan.d_w), rnd(plan.w_numel),
           rnd(20, plan.d_out))
    got = dtp_lin_bwd_stage_plain(plan, *ops, FULL_STAGE)
    want = dtp_lin_bwd_plain(plan, *ops)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and got[2].dtype == torch.float64
    with pytest.raises(ValueError):
        dtp_lin_bwd_stage(plan, *ops, FULL_STAGE + 1)


# ------------------------------------------------------ registration
def test_measurement_kernels_are_registered():
    """The four wrappers count launches through KERNEL_WRAPPERS (so every
    model phase of chip_smoke.py expects 0 of them) and have C signatures."""
    for name in NEW_KERNELS:
        assert name in KERNEL_WRAPPERS and name in _build._SIGNATURES
    assert len(KERNEL_WRAPPERS) == 22


# ------------------------------------------------------------ the tools
def test_chip_peaks_main_on_cpu(capsys):
    from equiformer_tpu_torch.tools import chip_peaks

    r = chip_peaks.main(["--device", "cpu", "--grid", "1", "--hbm-mb", "1", "2", "--mm", "32",
                         "--edges", "40"])
    assert r["device"] == "cpu" and capsys.readouterr().out.startswith("cpu")
    assert [(f["dtype"], f["variant"]) for f in r["fma"]] == [
        ("float32", "narrow"), ("float32", "wide"), ("bfloat16", "narrow"), ("bfloat16", "wide")]
    assert [f["shape"] for f in r["fma"][:2]] == [[512, 128], [256, 1024]]
    assert [h["mb"] for h in r["hbm"]] == [1, 2] and r["tensor_cores"][0]["n"] == 32
    assert [f["dtype"] for f in r["dtp_t_floor"]] == ["float32", "bfloat16"]
    rows = r["fma"] + r["hbm"] + r["tensor_cores"] + r["dtp_t_floor"]
    assert all(row["ms"] > 0 for row in rows)


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_kbench_main_on_cpu(fp32):
    from equiformer_tpu_torch.tools import kbench

    r = kbench.main(["--device", "cpu", "--edges", "24"] + (["--fp32"] if fp32 else []))
    assert list(r["variants"]) == list(kbench.VARIANTS)
    assert r["dims"] == {"x": 480, "sh": 9, "w": 960, "z": 3136, "z_aligned": 128 * 51,
                         "lin": 576, "terms": 137}
    assert r["variants"]["dmafloor"]["bytes"] == 24 * (480 + 9 + 960 + 3136) * (4 if fp32 else 2)
    assert r["fusedlin_vs_composition_rel"] < (1e-5 if fp32 else 2e-2)
    fl = r["variants"]["fusedlin"]
    assert fl["bound_by"] in ("bytes", "operations") and fl["bound_ms"] > 0


def test_bwd_attr_main_on_cpu(tmp_path):
    from equiformer_tpu_torch.tools import bwd_attr

    out = tmp_path / "bwd.json"
    r = bwd_attr.main(["--device", "cpu", "--edges", "20", "--out", str(out)])
    assert r["edges"] == 20 and out.exists()
    for name in ("float32", "bfloat16"):
        rows = r["times"][name]
        assert [s["name"] for s in rows] == list(BWD_STAGES)
        assert rows[0]["delta_ms"] == rows[0]["ms"]


def test_bwd_attr_qm9_geometry_on_cpu():
    """``--qm9`` takes the real edges of chip_smoke.py's batch 0."""
    from equiformer_tpu_torch.tools import bwd_attr

    sh = bwd_attr.qm9_sh(torch.device("cpu"))
    assert sh.shape[1] == 9 and 20000 < sh.shape[0] < 36352
    assert torch.allclose(sh[:, 0], torch.ones(sh.shape[0]))


def test_tools_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from equiformer_tpu_torch.utils.profiling import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


# ------------------------------------------------------------ profiling
def test_step_timer_and_trace(tmp_path):
    from equiformer_tpu_torch.utils import StepTimer, trace

    timer = StepTimer()
    with trace(None):
        for _ in range(2):
            timer.start()
            timer.stop({"loss": torch.ones(3).sum(), "aux": [torch.zeros(2)]})
    assert len(timer.times) == 2 and timer.mean_ms >= 0.0
    with trace(str(tmp_path)):
        torch.ones(8).sum()
    assert any(p.suffix == ".json" for p in tmp_path.rglob("*"))


@pytest.mark.parametrize("name, short, there", [
    ("void <unnamed>::dtp_lin_leg_kernel<float, 3, (bool)1>(const T1 *, long long)",
     "dtp_lin_leg_kernel<float, 3, (bool)1>", "equal"),
    ("void k2::rad_dW_kernel<__nv_bfloat16>(const T1 *)", "k2::rad_dW_kernel<__nv_bfloat16>",
     "differ"),
    ("eqt::sum_partial_rows_kernel(const float *, int, int, float *)",
     "eqt::sum_partial_rows_kernel", "not_here"),
])
def test_ptxas_report_matches_kernels_across_trees(name, short, there):
    """The ptxas report names a kernel without its parameters, and sorts
    the other tree's kernels by name into equal, differing and absent here
    (a retired kernel: no difference); this tree's others are new."""
    from equiformer_tpu_torch.tools.ptxas_report import _short, compare

    assert _short(name) == short
    mine = {} if there == "not_here" else {short: ["Used 40 registers"], "k2::new": ["x"]}
    other = {short: ["Used 40 registers" if there == "equal" else "Used 48 registers"]}
    res = compare(mine, other)
    assert res[there] == [short]
    assert res["new_here"] == ([] if there == "not_here" else ["k2::new"])
    assert compare(mine, other, match="no such kernel")["new_here"] == list(mine)
