"""The unfused DTP route (K6) through whole models, against the JAX package.

Three ``make_qm9_steps`` of the reduced flagship on the unfused route (with
and without ``dtp_first_order_bwd``), and energies, forces and three
``make_md17_steps`` of a reduced L3 force model on it, against JAX's einsum
route, which computes the same function: JAX's Pallas route in interpret
mode traces a kernel body per term and compiles a whole step for tens of
seconds to minutes on a CPU (130 s for one force evaluation of the 2-block
L3 model, 252 s for its training step), and its T / R primitives and
modules are held to the port in ``tests/test_torch_dtp.py``.  The two
routes of the port agree, and one JAX tree loads into both.

Tolerance: 1e-9 of the largest JAX value, fp64.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.data import qm9_like_dataset  # noqa: E402
from equiformer_tpu.graph.batching import collate_dense as j_collate  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.models.md17_models import energy_and_forces as j_forces  # noqa: E402
from equiformer_tpu.train import engine as jeng, optim as jopt, state as jstate  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.data import md17_like_dataset  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate_dense as t_collate  # noqa: E402
from equiformer_tpu_torch.kernels import dtp as kd  # noqa: E402
from equiformer_tpu_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from equiformer_tpu_torch.models import md17_models  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax, torch_name  # noqa: E402
from test_torch_jax_ref import fast_jit  # noqa: E402

SH3 = "1x0e+1x1e+1x2e+1x3e"
TOL = 1e-9

if os.environ.get("PYTEST_XDIST_WORKER"):  # see tests/test_torch_md17_train.py
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _jax_grads(tree):
    """{port name: gradient in the port's layout} of a flax gradient tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    out = {}
    for path, g in flat:
        name = torch_name(tuple(k.key for k in path))
        g = np.asarray(g)
        out[name] = g.T if name.endswith(".weight") and g.ndim == 2 else g
    return out


QM9_REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
    fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
    num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=512, nodes_per_graph=30,
    alpha_drop=0.0,
)
L3_REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+8x2e+4x3e", num_layers=1, irreps_sh=SH3,
    number_of_basis=32, basis_type="exp", fc_neurons=(16, 16), irreps_feature="32x0e",
    irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4, irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e",
    alpha_drop=0.0, max_atom_type=64, avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
    avg_degree=md17_models._AVG_DEGREE_MD17, max_edges=1536, nodes_per_graph=21,
)
LR, WARMUP, TOTAL, EMA = 2e-2, 2, 6, 0.5
STEPS = 3


def _jcfg(cfg):
    return {k: JIrreps(v) if k.startswith("irreps") else v for k, v in cfg.items()}


def _port_leaves(named):
    return {n: t.detach().numpy().copy() for n, t in named.items()}


def _check_steps(jmet, jst, tmet, tst, keys):
    for i in range(STEPS):
        for k in keys:
            assert _rel(tmet[i][k], jmet[i][k]) < TOL, (i, k)
    want_p, want_e = _jax_grads(jst.params), _jax_grads(jst.ema_params)
    got_p, got_e = _port_leaves(tst.params), _port_leaves(tst.ema)
    assert set(got_p) == set(want_p)
    scale = max(np.abs(v).max() for v in want_p.values())
    for got, want in ((got_p, want_p), (got_e, want_e)):
        assert max(np.abs(got[n] - want[n]).max() for n in got) < TOL * scale


@pytest.fixture(scope="module")
def qm9():
    """JAX's three make_qm9_steps of the reduced flagship (fp64, from its own
    init), its init tree and the port's batch."""
    data = qm9_like_dataset(4, seed=0)
    jb = j_collate(data, 30)
    jb = dataclasses.replace(jb, pos=np.asarray(jb.pos, np.float64), y=np.asarray(jb.y, np.float64))
    jm = JModel(**_jcfg(QM9_REDUCED), nonlinear_message=True, higher_order_grads=False)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(0), b, deterministic=True))(jb))
    jopt_ = jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=5e-3)
    j_step = fast_jit(jeng.make_qm9_steps(jm, jopt_, task_mean=0.3, task_std=1.7,
                                         ema_decay=EMA)[0])
    jst, jmet = jstate.TrainState.create(tree, jopt_), []
    for i in range(STEPS):
        jst, m = j_step(jst, jb, jax.random.PRNGKey(i))
        jmet.append({k: float(v) for k, v in m.items()})
    return tree, jst, jmet, t_collate(data, 30).to(dtype=torch.float64)


@pytest.mark.parametrize("first_order", [False, True], ids=["t-r", "fused-bwd"])
def test_qm9_training_steps_unfused_match_jax(first_order, qm9):
    """Three make_qm9_steps of the reduced flagship on the unfused route
    (with dtp_first_order_bwd: each DTP's backward one FB) against JAX's
    steps, fp64, from JAX's own init."""
    tree, jst, jmet, tb = qm9
    tm = TModel(**QM9_REDUCED, higher_order_grads=False, fused_dtp_lin=False,
                dtp_first_order_bwd=first_order).double()
    params_from_jax(tm, tree)
    topt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=5e-3)
    t_step, _ = pt.make_qm9_steps(tm, topt, task_mean=0.3, task_std=1.7, ema_decay=EMA)
    tst, tmet = pt.TrainState.create(tm, topt), []
    reset_launch_counts()
    for _ in range(STEPS):
        tst, m = t_step(tst, tb, None)
        tmet.append({k: float(v) for k, v in m.items()})
    assert set(launch_counts().values()) == {0}  # CPU tensors: the plain versions
    _check_steps(jmet, jst, tmet, tst, ("loss", "mae", "grad_norm"))


@pytest.fixture(scope="module")
def l3():
    """The reduced L3 force model's JAX module, its init tree (fp64) and
    the md17-like batch."""
    jm = JModel(**_jcfg(L3_REDUCED), nonlinear_message=True, higher_order_grads=True)
    data = md17_like_dataset(4, seed=0)
    jb = j_collate(data, 21, with_forces=True)
    jb = dataclasses.replace(jb, pos=np.asarray(jb.pos, np.float64), y=np.asarray(jb.y, np.float64),
                             forces=np.asarray(jb.forces, np.float64))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(1), b, deterministic=True))(jb))
    tb = t_collate(data, 21, with_forces=True).to(dtype=torch.float64)
    return jm, tree, jb, tb


def _l3_port(tree, fused=False):
    tm = TModel(**L3_REDUCED, fused_dtp_lin=fused).double()
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    return tm


def test_md17_energies_and_forces_unfused_match_jax(l3):
    """Energies and forces (the T / R family differentiated once) of the
    reduced L3 force model on the unfused route against JAX's, fp64."""
    jm, tree, jb, tb = l3
    je, jf = fast_jit(lambda p, b: j_forces(jm, p, b))(tree, jb)
    e, f = pt.energy_and_forces(_l3_port(tree), tb)
    assert _rel(e.numpy(), je) < TOL and _rel(f.numpy(), jf) < TOL


def test_md17_training_steps_unfused_match_jax(l3):
    """Three make_md17_steps (the grad-of-grad through T and R) of the
    reduced L3 force model on the unfused route against JAX's, fp64."""
    jm, tree, jb, tb = l3
    opt = jopt.create_optimizer(jopt.cosine_warmup_schedule(2e-3, WARMUP, TOTAL), weight_decay=1e-6)
    j_step = fast_jit(jeng.make_md17_steps(jm, opt, task_mean=0.5, task_std=2.0, energy_weight=1.0,
                                          force_weight=80.0, ema_decay=EMA)[0])
    jst, jmet = jstate.TrainState.create(tree, opt), []
    for i in range(STEPS):
        jst, m = j_step(jst, jb, jax.random.PRNGKey(i))
        jmet.append({k: float(v) for k, v in m.items()})
    tm = _l3_port(tree)
    topt = pt.create_optimizer(pt.cosine_warmup_schedule(2e-3, WARMUP, TOTAL), weight_decay=1e-6)
    t_step, _ = pt.make_md17_steps(tm, topt, task_mean=0.5, task_std=2.0, energy_weight=1.0,
                                   force_weight=80.0, ema_decay=EMA)
    tst, tmet = pt.TrainState.create(tm, topt), []
    for _ in range(STEPS):
        tst, m = t_step(tst, tb)
        tmet.append({k: float(v) for k, v in m.items()})
    _check_steps(jmet, jst, tmet, tst, ("loss", "loss_e", "loss_f", "mae_e", "mae_f", "grad_norm"))


def test_routes_agree_and_load_one_jax_tree(l3):
    """One JAX tree loads into the fused and the unfused model (the switch
    does not change the parameters), and both give the same energies,
    forces and training loss gradient (fp64, 1e-12: the same function)."""
    _, tree, _, tb = l3
    models = [_l3_port(tree, fused) for fused in (True, False)]
    assert [n for n, _ in models[0].named_parameters()] == \
        [n for n, _ in models[1].named_parameters()]
    res = []
    for tm in models:
        e, f = pt.energy_and_forces(tm.train(), tb, create_graph=True)
        loss = e.square().sum() + 80.0 * f.square().sum()
        res.append([e, f] + list(torch.autograd.grad(loss, list(tm.parameters()))))
    for a, b in zip(*res):
        assert _rel(a.detach().numpy(), b.detach().numpy()) < 1e-12
    seeded = [TModel(**L3_REDUCED, fused_dtp_lin=fused, seed=5) for fused in (True, False)]
    for (n, p), (_, q) in zip(*(m.named_parameters() for m in seeded)):
        assert torch.equal(p, q), n


def _count_calls(monkeypatch):
    """Record each T / R call of the family (its term list's slots and the
    row counts of its lane operands)."""
    calls = {"t": [], "r": []}
    t0, r0 = kd.dtp_t, kd.dtp_r

    def t(tl, a, col, b):
        calls["t"].append((tl.slots, a.shape[0], b.shape[0]))
        return t0(tl, a, col, b)

    def r(tl, a, b, d):
        calls["r"].append((tl.slots, a.shape[0], b.shape[0]))
        return r0(tl, a, b, d)

    monkeypatch.setattr(kd, "dtp_t", t)
    monkeypatch.setattr(kd, "dtp_r", r)
    return calls


def test_training_passes_skip_the_legs_nobody_reads(l3, monkeypatch):
    """make_md17_steps' force pass computes no gradient of the broadcast
    operands (sep_value's shared weight, the edge-degree embedding's
    constant feature: functions of the parameters alone, one T each), and
    its parameter pass runs no R.  Without the skips both would run."""
    _, tree, _, tb = l3
    calls = _count_calls(monkeypatch)
    tm = _l3_port(tree).train()
    sites = 1 + 2 * tm.num_layers  # the edge degree, sep_act and sep_value per block
    e, f = pt.energy_and_forces(tm, tb, create_graph=True)
    # a forward T per site; the force pass an R per site and the x and w
    # legs of each site but the broadcast ones (1 + num_layers)
    assert len(calls["r"]) == sites
    assert len(calls["t"]) == 3 * sites - (1 + tm.num_layers)
    calls["t"].clear()
    with kd.skip_leg_grads("sh"):
        torch.autograd.grad(e.square().sum() + f.square().sum(), list(tm.parameters()))
    assert len(calls["r"]) == sites and len(calls["t"]) > 0

    # the same two passes without the skips
    calls["t"].clear()
    pos = tb.pos.detach().requires_grad_(True)
    energy = tm(dataclasses.replace(tb, pos=pos))
    (g,) = torch.autograd.grad(energy.sum(), pos, create_graph=True)
    assert len(calls["t"]) == 3 * sites
    torch.autograd.grad(g.square().sum() + energy.square().sum(), list(tm.parameters()))
    assert len(calls["r"]) > 2 * sites
