"""Reduced models with the radial fold (K7) against the JAX package.

The radial fold runs the radial MLPs' final linear layers inside the fused
DTP op (``radial_fold``, and for force models also ``radial_fold_ho``: JAX's
``EQUIFORMER_TPU_FOLD_RADIAL`` / ``EQUIFORMER_TPU_FOLD_RADIAL_HO``).  The
parameters do not change with it, so one JAX tree (its own ``init``) loads
into either setting through ``params_from_jax``.  On the CPU the JAX package
never folds: the unfolded JAX models are the target, in fp64 within 1e-9 of
the largest JAX value (``tests/test_torch_train.py`` and
``tests/test_torch_md17.py`` hold the unfolded port to the same).  The ops
themselves are in ``tests/test_torch_radial_fold.py``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.data import qm9_like_dataset  # noqa: E402
from equiformer_tpu.data.synthetic import md17_like_dataset as j_md17_like  # noqa: E402
from equiformer_tpu.graph.batching import collate_dense as j_collate  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.models.md17_models import energy_and_forces as j_energy_and_forces  # noqa: E402
from equiformer_tpu.train import engine as jeng, optim as jopt, state as jstate  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate_dense as t_collate  # noqa: E402
from equiformer_tpu_torch.models import md17_models  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax, torch_name  # noqa: E402

# the modules (the package's names dtp_lin / dtp_lin_ho are the functions)
kdl = importlib.import_module("equiformer_tpu_torch.kernels.dtp_lin")
kho = importlib.import_module("equiformer_tpu_torch.kernels.dtp_lin_ho")
TOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _flip(name, a):
    """flax Dense kernels are [in, out], torch Linear weights [out, in]."""
    return a.T if name.endswith(".weight") and np.ndim(a) == 2 else a


def _leaves(tree):
    """{port parameter name: array} of a flax parameter tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    return {torch_name(tuple(k.key for k in path)): np.asarray(a) for path, a in flat}


QM9_REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
    fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
    num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=512, nodes_per_graph=30,
)
MD17_REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+8x2e+4x3e", num_layers=2, irreps_sh="1x0e+1x1e+1x2e+1x3e",
    number_of_basis=32, fc_neurons=(16, 16), irreps_feature="32x0e",
    irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4, irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e",
    alpha_drop=0.0, max_atom_type=64, avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
    avg_degree=md17_models._AVG_DEGREE_MD17, max_edges=1536, nodes_per_graph=21,
    basis_type="exp",
)
LR, WARMUP, TOTAL, WD, EMA, MEAN, STD = 2e-2, 2, 6, 5e-3, 0.5, 0.3, 1.7


def _jcfg(cfg):
    return {k: JIrreps(v) if k.startswith("irreps") else v for k, v in cfg.items()}


def _qm9_batch(data, npdt):
    jb = j_collate(data, 30)
    return jb.__class__(**{**jb.__dict__, "pos": np.asarray(jb.pos, npdt),
                           "y": np.asarray(jb.y, npdt)})


@pytest.fixture(scope="module")
def qm9():
    data = qm9_like_dataset(4, seed=0)
    jm = JModel(**_jcfg(QM9_REDUCED), nonlinear_message=True, higher_order_grads=False,
                alpha_drop=0.0)
    tree = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, deterministic=True))(
        _qm9_batch(data, np.float32))
    return jm, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree), data


def _qm9_port(tree, **route):
    tm = TModel(**QM9_REDUCED, higher_order_grads=False, alpha_drop=0.0, **route).double()
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    return tm


def test_one_jax_tree_loads_into_either_setting(qm9):
    """The fold changes no parameter: one JAX tree loads into a reduced
    flagship with the fold on and off, and both give the same loss and the
    same parameter gradients."""
    _, tree, data = qm9
    b = t_collate(data, 30).to(dtype=torch.float64)
    res = []
    for fold in (False, True):
        tm = _qm9_port(tree, radial_fold=fold)
        assert (tm.block_0.ga.sep_act.plan.radial_fold is None) != fold
        loss = (tm.eval()(b) ** 2).sum()
        res.append((float(loss.detach()), torch.autograd.grad(loss, list(tm.parameters()))))
    assert abs(res[0][0] - res[1][0]) <= 1e-12 * abs(res[0][0])
    assert max(_rel(a, c) for a, c in zip(res[0][1], res[1][1])) < 1e-10


def test_reduced_qm9_training_steps_fold_match_make_qm9_steps(qm9):
    """Three training steps of a reduced flagship with ``radial_fold=True``
    (K7-F / K7-B plain versions at the sep_act and edge-degree sites)
    against JAX's ``make_qm9_steps`` (unfolded), fp64, 1e-9 of the largest
    JAX value: loss, MAE, gradient norm per step, then every parameter."""
    jm, tree, data = qm9
    opt = jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD)
    j_step, _ = jeng.make_qm9_steps(jm, opt, task_mean=MEAN, task_std=STD, ema_decay=EMA)
    j_step = jax.jit(j_step)
    jst = jstate.TrainState.create(tree, opt)
    jb = _qm9_batch(data, np.float64)
    tm = _qm9_port(tree, radial_fold=True)
    topt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD)
    tst = pt.TrainState.create(tm, topt)
    t_step, _ = pt.make_qm9_steps(tm, topt, task_mean=MEAN, task_std=STD, ema_decay=EMA)
    tb = t_collate(data, 30).to(dtype=torch.float64)
    for i in range(3):
        jst, jm_ = j_step(jst, jb, jax.random.PRNGKey(i))
        tst, tm_ = t_step(tst, tb, None)
        for k in ("loss", "mae", "grad_norm"):
            assert _rel(float(tm_[k]), float(jm_[k])) < TOL, (i, k)
    want = _leaves(jst.params)
    scale = max(np.abs(v).max() for v in want.values())
    for n, p in tst.params.items():
        assert np.abs(_flip(n, p.detach().numpy()) - want[n]).max() < TOL * scale, n


def test_reduced_md17_fold_forces_match_jax():
    """A reduced exp-L3 force model with ``radial_fold`` and
    ``radial_fold_ho`` (K7-F / K7-B3 plain versions): energies and forces
    against JAX's unfolded force model, fp64, 1e-9 of the largest value."""
    data = j_md17_like(4, seed=0)
    jm = JModel(**_jcfg(MD17_REDUCED), nonlinear_message=True, higher_order_grads=True)
    jb = j_collate(data, 21, with_forces=True)
    jb64 = jb.__class__(**{**jb.__dict__, "pos": np.asarray(jb.pos, np.float64)})
    tree = jax.jit(lambda b: jm.init(jax.random.PRNGKey(1), b, deterministic=True))(jb)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    je, jf = jax.jit(lambda p, b: j_energy_and_forces(jm, p, b))(tree, jb64)
    tm = TModel(**MD17_REDUCED, radial_fold=True, radial_fold_ho=True).double()
    params_from_jax(tm, tree)
    assert tm.edge_deg_embed.plan.radial_fold == 16
    te, tf = pt.energy_and_forces(tm.eval(), t_collate(data, 21, with_forces=True)
                                  .to(dtype=torch.float64))
    assert _rel(te.numpy(), je) < TOL and _rel(tf.numpy(), jf) < TOL
    assert float(tf.abs().max()) > 0.0


MD17_LR, MD17_WD, MD17_EMA, MD17_MEAN, MD17_STD = 2e-3, 1e-6, 0.5, 0.5, 2.0
METRICS = ("loss", "loss_e", "loss_f", "mae_e", "mae_f", "grad_norm")


def test_reduced_md17_fold_training_steps_match_make_md17_steps():
    """Three force training steps of a reduced exp-L3 model with
    ``radial_fold`` and ``radial_fold_ho`` (the folded force op's
    grad-of-grad on the plain versions of K7-F, K7-B3, K7-L, K7-LW and
    K7-Wr) against ``jax.jit`` of JAX's ``train_step`` from
    ``make_md17_steps`` on the same JAX tree (unfolded: the same function),
    fp64: the six metrics of every step within 1e-9, then every parameter
    and the EMA within 1e-9 of max |param|; the steps move the parameters.
    The counterpart of ``tests/test_torch_md17_train.py``'s fast case."""
    data = j_md17_like(4, seed=0)
    jm = JModel(**_jcfg(MD17_REDUCED), nonlinear_message=True, higher_order_grads=True)
    jb = j_collate(data, 21, with_forces=True)
    tree = jax.jit(lambda b: jm.init(jax.random.PRNGKey(1), b, deterministic=True))(jb)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    jb64 = jb.__class__(**{**jb.__dict__, **{k: np.asarray(getattr(jb, k), np.float64)
                                            for k in ("pos", "y", "forces")}})
    kw = dict(task_mean=MD17_MEAN, task_std=MD17_STD, energy_weight=1.0, force_weight=80.0,
              ema_decay=MD17_EMA)
    jopt_ = jopt.create_optimizer(jopt.cosine_warmup_schedule(MD17_LR, WARMUP, TOTAL),
                                  weight_decay=MD17_WD)
    j_step = jax.jit(jeng.make_md17_steps(jm, jopt_, **kw)[0])
    jst = jstate.TrainState.create(tree, jopt_)
    tm = TModel(**MD17_REDUCED, radial_fold=True, radial_fold_ho=True).double()
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    topt = pt.create_optimizer(pt.cosine_warmup_schedule(MD17_LR, WARMUP, TOTAL),
                               weight_decay=MD17_WD)
    t_step, _ = pt.make_md17_steps(tm, topt, **kw)
    tst = pt.TrainState.create(tm, topt)
    tb = t_collate(data, 21, with_forces=True).to(dtype=torch.float64)
    for i in range(3):
        jst, jm_ = j_step(jst, jb64, jax.random.PRNGKey(i))
        tst, tm_ = t_step(tst, tb)
        for k in METRICS:
            assert _rel(float(tm_[k]), float(jm_[k])) < TOL, (i, k)
    want, want_ema = _leaves(jst.params), _leaves(jst.ema_params)
    scale = max(np.abs(v).max() for v in want.values())
    for n, p in tst.params.items():
        assert np.abs(_flip(n, p.detach().numpy()) - want[n]).max() < TOL * scale, n
        assert np.abs(_flip(n, tst.ema[n].numpy()) - want_ema[n]).max() < TOL * scale, n
    init = _leaves(tree)
    assert max(np.abs(want[n] - init[n]).max() for n in init) > 1e4 * TOL * scale


def _count(monkeypatch, names, plans=None):
    """Count the calls of the named wrappers (the CPU wrappers count no
    launches), patched where the autograd ops look them up; ``plans``, a
    dict, collects each call's plan under the wrapper's name."""
    calls = dict.fromkeys(names, 0)
    for mod in (kdl, kho):
        for name in names:
            if hasattr(mod, name):
                def counting(*a, _f=getattr(mod, name), _n=name, **k):
                    calls[_n] += 1
                    if plans is not None:
                        plans.setdefault(_n, []).append(a[0])
                    return _f(*a, **k)
                monkeypatch.setattr(mod, name, counting)
    return calls


def test_reduced_units_call_the_folded_kernels(qm9, monkeypatch):
    """Per reduced QM9 step (2 blocks): 3 K7-F + 2 K1 forward, 3 K7-B + 2 K2
    backward; per reduced force evaluation: 3 K7-F + 2 K1, 3 K7-B3 + 2 K5a
    (the folded sites: each block's sep_act and the edge degree); per
    reduced force training step: K7-L, K7-LW and K7-Wr at the folded sites,
    and K5b / K5c only at the 2 shared-weight sep_value sites."""
    names = ("dtp_lin_fwd", "dtp_lin_bwd", "dtp_lin_bwd3", "dtp_lin_rad_fwd",
             "dtp_lin_rad_bwd", "dtp_lin_rad_bwd3")
    names_train = ("dtp_lin_leg", "dtp_lin_legW", "dtp_lin_rad_leg", "dtp_lin_rad_legW",
                   "dtp_lin_rad_legWr")
    plans = {}
    calls = _count(monkeypatch, names + names_train, plans)
    _, tree, data = qm9
    tm = _qm9_port(tree, radial_fold=True).float()
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL))
    step, _ = pt.make_qm9_steps(tm, opt)
    step(pt.TrainState.create(tm, opt), t_collate(data, 30), None)
    assert calls == {"dtp_lin_fwd": 2, "dtp_lin_bwd": 2, "dtp_lin_bwd3": 0,
                     "dtp_lin_rad_fwd": 3, "dtp_lin_rad_bwd": 3, "dtp_lin_rad_bwd3": 0,
                     **dict.fromkeys(names_train, 0)}
    calls.update(dict.fromkeys(calls, 0))
    tm = TModel(**MD17_REDUCED, radial_fold=True, radial_fold_ho=True)
    mb = next(iter(GraphLoader(md17_like_dataset(2, num_atoms=21, seed=0), 2, dense_slots=21,
                               with_forces=True)))
    pt.evaluate_md17(tm, mb)
    assert calls == {"dtp_lin_fwd": 2, "dtp_lin_bwd": 0, "dtp_lin_bwd3": 2,
                     "dtp_lin_rad_fwd": 3, "dtp_lin_rad_bwd": 0, "dtp_lin_rad_bwd3": 3,
                     **dict.fromkeys(names_train, 0)}
    calls.update(dict.fromkeys(calls, 0))
    plans.clear()
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL))
    step, _ = pt.make_md17_steps(tm, opt, energy_weight=1.0, force_weight=80.0)
    step(pt.TrainState.create(tm, opt), mb)
    # per folded site what the unfolded per-edge-w site launches on K1 /
    # K5a / K5b / K5c goes to K7-F / K7-B3 / K7-L / K7-LW, and each K7-LW
    # has a K7-Wr beside it; each sep_value site keeps 3 K1, 1 K5a, 2 K5b
    # (x legs), 3 K5c
    assert calls == {"dtp_lin_fwd": 6, "dtp_lin_bwd": 0, "dtp_lin_bwd3": 2,
                     "dtp_lin_rad_fwd": 11, "dtp_lin_rad_bwd": 0, "dtp_lin_rad_bwd3": 6,
                     "dtp_lin_leg": 4, "dtp_lin_legW": 6, "dtp_lin_rad_leg": 11,
                     "dtp_lin_rad_legW": 11, "dtp_lin_rad_legWr": 11}
    assert all(p.shared_weights for n in ("dtp_lin_fwd", "dtp_lin_bwd3", "dtp_lin_leg",
                                          "dtp_lin_legW") for p in plans[n])
    assert all(p.radial_fold == 16 for n in names_train[2:] for p in plans[n])
