"""The port's MD17 force training step against the JAX package's.

Three ``train_step``s of ``make_md17_steps`` (training-mode forward, forces =
-dE/dpos with ``create_graph=True``, the L2-MAE loss with ``energy_weight=1``
and ``force_weight=80``, the parameter gradient as a grad-of-grad through the
plain versions of every kernel, AdamW with the no-decay mask, EMA) of a
reduced force model (L3 SH, exp basis, 2 blocks on 16x0e+8x1e+8x2e+4x3e, 4
md17-like molecules of 21 atoms) from one set of weights, the JAX model's own
``init`` with ``higher_order_grads=True``, against ``jax.jit`` of the JAX
``train_step``.  On the CPU the JAX package takes its einsum / XLA path (no
Pallas) and the port its plain versions.  ``alpha_drop=0`` and no drop path:
the step draws no random numbers.

Tolerances, relative to the largest JAX value: fp64 1e-9 (loss, the four aux
metrics, the gradient norm, and the parameters and EMA against max |param|).
In fp32 the forces of both packages are noisy (the exp basis's derivative
cancels; ``tests/test_torch_md17.py``), so the port's fp32 metrics are held
to the fp64 ones within FP32_FACTOR times the JAX package's own fp32 distance
to them, and its parameters likewise on the elements whose fp64 gradient is
not zero; Adam divides each gradient element by its own magnitude, so an
element whose exact gradient is zero moves by the sign of rounding noise
times the learning rate, differently in the two packages (see
``tests/test_torch_train.py``), and is held only to Adam's largest step.
The JAX grad-of-grad takes about a minute to compile here (several when
the other test workers load the machine), so each precision's step is built
once per module, and the fp32 case, which needs a second compilation, is in
the slow tier with the full-width case (minutes on the CPU).
"""

import copy
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.graph.batching import collate_dense as j_collate  # noqa: E402
from equiformer_tpu.models import model_entrypoint as j_entry  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.train import engine as jeng, optim as jopt, state as jstate  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.data import md17_like_dataset  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate_dense as t_collate  # noqa: E402
from equiformer_tpu_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from equiformer_tpu_torch.models import md17_models  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax, torch_name  # noqa: E402
from test_torch_jax_ref import fast_jit  # noqa: E402


SLOTS, GRAPHS = 21, 4
REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+8x2e+4x3e", num_layers=2, irreps_sh="1x0e+1x1e+1x2e+1x3e",
    number_of_basis=32, basis_type="exp", fc_neurons=(16, 16), irreps_feature="32x0e",
    irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4, irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e",
    alpha_drop=0.0, max_atom_type=64, avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
    avg_degree=md17_models._AVG_DEGREE_MD17, max_edges=1536, nodes_per_graph=SLOTS,
)
# a schedule that warms up and decays within the three steps, so each step
# runs at another learning rate; EMA decay low enough that the EMA moves
LR, WARMUP, TOTAL, WD, EMA = 2e-3, 2, 6, 1e-6, 0.5
MEAN, STD = 0.5, 2.0
E_WEIGHT, F_WEIGHT = 1.0, 80.0
STEPS = 3
METRICS = ("loss", "loss_e", "loss_f", "mae_e", "mae_f", "grad_norm")
DTYPES = {"fp64": (np.float64, torch.float64), "fp32": (np.float32, torch.float32)}
FP64_TOL = 1e-9
FP32_FACTOR = 3.0

# Under pytest-xdist every worker imports every test file, and each worker's
# torch would spin one OpenMP thread per core through the grad-of-grad's many
# small einsums: six workers on eight cores then slow every test of the run,
# the JAX ones included (measured: the whole fast tier 1112 s, and 557 s with
# two threads per worker).  Tests at these sizes gain nothing from more.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _jax_batch(data, npdt):
    jb = j_collate(data, SLOTS, with_forces=True)
    return dataclasses.replace(jb, pos=np.asarray(jb.pos, npdt), y=np.asarray(jb.y, npdt),
                               forces=np.asarray(jb.forces, npdt))


def _torch_batch(data, tdt):
    return t_collate(data, SLOTS, with_forces=True).to(dtype=tdt)


def _leaves(tree):
    """{port parameter name: array in the port's layout} of a flax tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    out = {}
    for path, a in flat:
        name = torch_name(tuple(k.key for k in path))
        a = np.asarray(a)
        out[name] = a.T if name.endswith(".weight") and a.ndim == 2 else a
    return out


def _port_leaves(named):
    return {n: t.detach().numpy().copy() for n, t in named.items()}


def _optimizers():
    return (jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD),
            pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD))


@pytest.fixture(scope="module")
def reduced():
    jcfg = {k: JIrreps(v) if k.startswith("irreps") else v for k, v in REDUCED.items()}
    jm = JModel(**jcfg, nonlinear_message=True, higher_order_grads=True)
    data = md17_like_dataset(GRAPHS, seed=0)
    tree = jax.jit(lambda b: jm.init(jax.random.PRNGKey(1), b, deterministic=True))(
        _jax_batch(data, np.float32))
    return jm, jax.tree_util.tree_map(np.asarray, tree), data


@pytest.fixture(scope="module")
def jax_steps(reduced):
    """dt -> (per-step metrics, final parameters, final EMA) of three jitted
    JAX train_steps; each precision compiles once, on first use."""
    jm, tree, data = reduced
    done = {}

    def run(dt):
        if dt not in done:
            npdt = DTYPES[dt][0]
            opt, _ = _optimizers()
            step, _ = jeng.make_md17_steps(jm, opt, task_mean=MEAN, task_std=STD,
                                           energy_weight=E_WEIGHT, force_weight=F_WEIGHT,
                                           ema_decay=EMA)
            step = fast_jit(step) if dt == "fp64" else jax.jit(step)
            st = jstate.TrainState.create(
                jax.tree_util.tree_map(lambda a: np.asarray(a, npdt), tree), opt)
            jb, metrics = _jax_batch(data, npdt), []
            for i in range(STEPS):
                st, m = step(st, jb, jax.random.PRNGKey(i))
                metrics.append({k: float(m[k]) for k in METRICS})
            assert int(st.step) == STEPS
            done[dt] = (metrics, _leaves(st.params), _leaves(st.ema_params))
        return done[dt]

    return run


def _port_model(tree, tdt):
    tm = TModel(**REDUCED, seed=4).to(tdt)
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    return tm


def _port_steps(tree, data, dt, steps=STEPS):
    tdt = DTYPES[dt][1]
    tm = _port_model(tree, tdt)
    _, opt = _optimizers()
    step, _ = pt.make_md17_steps(tm, opt, task_mean=MEAN, task_std=STD, energy_weight=E_WEIGHT,
                                 force_weight=F_WEIGHT, ema_decay=EMA)
    st = pt.TrainState.create(tm, opt)
    tb, metrics = _torch_batch(data, tdt), []
    for _ in range(steps):
        st, m = step(st, tb)
        assert all(v.dim() == 0 and not v.requires_grad for v in m.values())
        metrics.append({k: float(m[k]) for k in METRICS})
    assert st.step == steps
    return metrics, _port_leaves(st.params), _port_leaves(st.ema)


def _loss(tm, batch):
    """The training loss as make_md17_steps computes it, with its graph."""
    e, f = pt.energy_and_forces(tm.train(), batch, create_graph=True)
    e_err = e - (batch.y - MEAN) / STD
    f_err = f - batch.forces / STD
    gm, nm = batch.graph_mask.to(e.dtype), batch.node_mask.to(e.dtype)
    return (E_WEIGHT * (e_err.abs() * gm).sum() / gm.sum()
            + F_WEIGHT * (torch.sqrt((f_err * f_err).sum(-1) + 1e-12) * nm).sum() / nm.sum())


@pytest.fixture(scope="module")
def fp64_grads(reduced):
    """{name: float64 gradient of the first step's loss} in the port."""
    _, tree, data = reduced
    tm = _port_model(tree, torch.float64)
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(_loss(tm, _torch_batch(data, torch.float64)),
                                list(params.values()))
    return {n: g.numpy() for n, g in zip(params, grads)}


def test_training_steps_match_make_md17_steps_fp64(reduced, jax_steps):
    """Three steps in fp64: loss, the four aux metrics and the gradient norm
    of every step within 1e-9, the updated parameters and the EMA within 1e-9
    of max |param|; the steps really move the parameters."""
    _, tree, data = reduced
    jmet, jp, je = jax_steps("fp64")
    tmet, tp, te = _port_steps(tree, data, "fp64")
    for i in range(STEPS):
        for k in METRICS:
            assert _rel(tmet[i][k], jmet[i][k]) < FP64_TOL, (i, k)
    assert set(tp) == set(jp)
    scale = max(np.abs(v).max() for v in jp.values())
    for got, want in ((tp, jp), (te, je)):
        assert max(np.abs(got[n] - want[n]).max() for n in got) < FP64_TOL * scale
    init = _leaves(tree)
    assert max(np.abs(jp[n] - init[n]).max() for n in init) > 1e4 * FP64_TOL * scale
    assert tmet[0]["loss_f"] > 0 and tmet[0]["loss"] != tmet[STEPS - 1]["loss"]


@pytest.mark.slow
def test_training_steps_match_make_md17_steps_fp32(reduced, jax_steps, fp64_grads):
    """Three steps in fp32: each metric within FP32_FACTOR times the JAX
    package's own fp32 distance to its fp64 value (plus 1e-5: fp32 forces
    are noisy in both), the parameters with a nonzero fp64 gradient likewise
    against max |param|, the others within Adam's largest step."""
    _, tree, data = reduced
    j64, jp64, je64 = jax_steps("fp64")
    j32, jp32, je32 = jax_steps("fp32")
    tmet, tp, te = _port_steps(tree, data, "fp32")
    for i in range(STEPS):
        for k in METRICS:
            bound = FP32_FACTOR * _rel(j32[i][k], j64[i][k]) + 1e-5
            assert _rel(tmet[i][k], j64[i][k]) <= bound, (i, k)
    top = max(np.abs(g).max() for g in fp64_grads.values())
    dead = {n: np.abs(g) < 1e-12 * top for n, g in fp64_grads.items()}
    n_dead = sum(int(m.sum()) for m in dead.values())
    assert 0 < n_dead < 0.3 * sum(m.size for m in dead.values())
    scale = max(np.abs(v).max() for v in jp64.values())
    adam_max = 2 * sum(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL)(i) for i in range(STEPS)) * (
        0.1 / 0.001 ** 0.5 + WD * scale)
    for got, j32_, j64_ in ((tp, jp32, jp64), (te, je32, je64)):
        jax_dist = max(np.abs(j32_[n] - j64_[n])[~dead[n]].max(initial=0.0) for n in got)
        for n in got:
            d = np.abs(got[n].astype(np.float64) - j64_[n])
            assert d[~dead[n]].max(initial=0.0) <= FP32_FACTOR * jax_dist + 1e-6 * scale, n
            assert d.max() <= adam_max, n


def test_loss_gradient_matches_central_differences(reduced, fp64_grads):
    """The grad-of-grad against central differences of the training loss on
    a few parameters of different modules (fp64, each moved by 1e-6 of its
    tensor's largest value; within 1e-5 of the tensor's largest gradient):
    the radial MLP and the two head linears of a fused DTP, the shared DTP
    weight, the attention's dot vector, the edge-degree embedding's scalar
    expansion and the output head."""
    _, tree, data = reduced
    tm = _port_model(tree, torch.float64)
    batch = _torch_batch(data, torch.float64)
    params = dict(tm.named_parameters())
    picks = [n for n in params if any(key in n for key in (
        "block_0.ga.sep_act.dtp_rad", "block_1.ga.sep_act.lin", "block_0.ga.sep_alpha",
        "block_1.ga.sep_value.dtp.w", "block_0.ga.alpha_dot", "edge_deg_embed.exp",
        "edge_deg_embed.proj", "head_lin2"))]
    assert len(picks) >= 8
    rng = np.random.default_rng(21)
    for n in picks[::2][:8]:
        p, g = params[n], fp64_grads[n]
        idx = np.unravel_index(int(np.argmax(np.abs(g))), g.shape)
        if rng.random() < 0.5:  # and some element that is not the largest
            idx = tuple(int(rng.integers(0, s)) for s in g.shape)
        h = 1e-6 * max(float(p.abs().max()), 1e-3)
        vals = []
        for sign in (1.0, -1.0):
            with torch.no_grad():
                p[idx] += sign * h
            vals.append(float(_loss(tm, batch)))
            with torch.no_grad():
                p[idx] -= sign * h
        fd = (vals[0] - vals[1]) / (2 * h)
        assert abs(fd - g[idx]) < 1e-5 * np.abs(g).max(), (n, idx, fd, g[idx])


def test_two_steps_from_one_state_are_bitwise_equal(reduced):
    """The step draws no random numbers and every sum runs in a fixed order:
    two steps from copies of one state give the same bits (fp32), and launch
    no kernel on the CPU."""
    _, tree, data = reduced
    reset_launch_counts()
    a = _port_steps(tree, data, "fp32", steps=1)
    b = _port_steps(tree, data, "fp32", steps=1)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert all(np.array_equal(x[n], y[n]) for n in x)
    assert set(launch_counts().values()) == {0}


def test_energy_and_forces_create_graph_carries_the_graph(reduced):
    """create_graph=True reads the live parameters and returns an energy and
    forces that carry the graph, equal to the detached evaluation's values
    (1e-12: the same arithmetic); the default path stays detached."""
    _, tree, data = reduced
    tm = _port_model(tree, torch.float64).eval()
    batch = _torch_batch(data, torch.float64)
    e0, f0 = pt.energy_and_forces(tm, batch)
    e1, f1 = pt.energy_and_forces(tm, batch, create_graph=True)
    assert not e0.requires_grad and not f0.requires_grad
    assert e1.requires_grad and f1.requires_grad
    assert _rel(e1.detach().numpy(), e0.numpy()) < 1e-12
    assert _rel(f1.detach().numpy(), f0.numpy()) < 1e-12
    assert float(f1[~batch.node_mask].abs().sum()) == 0.0
    (g,) = torch.autograd.grad(f1.square().sum(), tm.block_0.ga.sep_act.lin.weight_list()[0])
    assert bool(g.isfinite().all()) and float(g.abs().max()) > 0


def test_make_md17_steps_defaults_and_eval_step(reduced):
    """JAX's defaults (energy_weight 0.2, force_weight 0.8, EMA 0.999), and
    eval_step is evaluate_md17 with the normalization bound."""
    import inspect

    jsig = inspect.signature(jeng.make_md17_steps).parameters
    tsig = inspect.signature(pt.make_md17_steps).parameters
    for k in ("task_mean", "task_std", "energy_weight", "force_weight", "ema_decay"):
        assert tsig[k].default == jsig[k].default, k
    assert "pmean_axis" not in tsig
    _, tree, data = reduced
    tm = _port_model(tree, torch.float32)
    _, opt = _optimizers()
    _, eval_step = pt.make_md17_steps(tm, opt, task_mean=MEAN, task_std=STD)
    batch = _torch_batch(data, torch.float32)
    got, want = eval_step(tm, batch), pt.evaluate_md17(copy.deepcopy(tm), batch, MEAN, STD)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.slow
def test_full_width_exp_l3_training_step_matches_jax():
    """One fp64 step of the headline force model at full width and depth on
    2 molecules, bench.py's settings (minutes on the CPU: slow tier)."""
    name = "graph_attention_transformer_nonlinear_exp_l3_md17"
    data = md17_like_dataset(2, seed=2)
    jm = j_entry(name)(max_edges=1024, nodes_per_graph=SLOTS)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(0), b, deterministic=True))(
        _jax_batch(data, np.float32)))
    jo = jopt.create_optimizer(jopt.cosine_warmup_schedule(5e-4, 100, 100000), weight_decay=1e-6)
    to = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000), weight_decay=1e-6)
    jstep, _ = jeng.make_md17_steps(jm, jo, energy_weight=1.0, force_weight=80.0)
    jst, jmet = jax.jit(jstep)(
        jstate.TrainState.create(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                                        tree), jo),
        _jax_batch(data, np.float64), jax.random.PRNGKey(0))
    tm = pt.model_entrypoint(name)(max_edges=1024, nodes_per_graph=SLOTS, device="cpu").double()
    params_from_jax(tm, tree)
    tstep, _ = pt.make_md17_steps(tm, to, energy_weight=1.0, force_weight=80.0)
    tst, tmet = tstep(pt.TrainState.create(tm, to), _torch_batch(data, torch.float64))
    for k in METRICS:
        assert _rel(float(tmet[k]), float(jmet[k])) < FP64_TOL, k
    jp = _leaves(jst.params)
    scale = max(np.abs(v).max() for v in jp.values())
    tp = _port_leaves(tst.params)
    assert max(np.abs(tp[n] - jp[n]).max() for n in tp) < FP64_TOL * scale
