"""The port's training recipe of the CLIs against the JAX package's.

The optimizer zoo of ``create_optimizer`` (every name, with and without a
binding ``grad_clip_norm``) against optax on a small module whose parameter
names hit the weight-decay mask and which holds a 160 x 128 kernel, so that
adafactor factors it; ``multistep_warmup_schedule``; the weights-only npz
checkpoints crossing between the packages; ``CheckpointManager``; remat of
the TransBlocks (``GraphAttentionTransformer(remat=True)``) against the
un-rematted QM9 and MD17 force steps with dropout on; and the QM9
entrypoint's reference-compat arguments against JAX's forward.

Tolerances: the optimizers 1e-12 relative to the largest parameter (fp64,
the same arithmetic in another order); the schedules 1e-6 (float32 in both
packages); remat against no remat 1e-12 (the same kernels in the same
order, so in practice the same bits); the entrypoint against JAX 1e-9 of
the largest prediction (fp64, as ``tests/test_torch_model.py``).  No JAX
training step is compiled: the JAX calls are optax on small trees,
``jax.eval_shape``, the npz functions and one reduced forward.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.data import GraphLoader as JLoader  # noqa: E402
from equiformer_tpu.models import model_entrypoint as j_entry  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.train import checkpoint as jckpt, optim as jopt  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset, qm9_like_dataset  # noqa: E402
from equiformer_tpu_torch.graph.batching import cli_capacities  # noqa: E402
from equiformer_tpu_torch.models import md17_models  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.nn.dropout import MaskReplay  # noqa: E402
from equiformer_tpu_torch.nn.radial import make_rbf  # noqa: E402
from equiformer_tpu_torch.train import CheckpointManager, load_params, save_params  # noqa: E402
from equiformer_tpu_torch.train import optim as topt  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax, params_to_jax  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

LR, WARMUP, TOTAL, WD = 2e-2, 2, 6, 5e-2
STEPS = 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


class Leafy(torch.nn.Module):
    """Leaves the decay mask sorts both ways: a Dense kernel of 160 x 128
    (decayed; factored by adafactor), biases, a LayerNorm's scale, an
    ``affine_weight``, ``b0`` / ``w0`` of an irreps linear and the radial
    basis' parameters (never decayed)."""

    def __init__(self, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.rbf = make_rbf("gaussian", 8, 5.0)
        self.dense = torch.nn.Linear(160, 128)
        self.norm = torch.nn.LayerNorm(8)
        self.lin = torch.nn.Module()
        self.lin.w0 = torch.nn.Parameter(torch.empty(8, 8))
        self.lin.b0 = torch.nn.Parameter(torch.empty(8))
        self.affine_weight = torch.nn.Parameter(torch.empty(8))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
            self.lin.b0.zero_()  # a zero tensor: the trust ratios' zero-norm branch
        self.double()


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without XLA's backend
    optimization passes (they take most of a compile and change no
    rounding here): a third of the time of optax's op-by-op dispatch,
    which compiles every primitive at every leaf shape."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})


def _tree_map(fn, *trees):
    return jax.tree_util.tree_map(fn, *trees)


def _grads(tree, step):
    rng = np.random.default_rng(100 + step)
    return _tree_map(lambda a: rng.normal(size=a.shape) * 3.0, tree)


def _global_norm(tree):
    return float(np.sqrt(sum(np.sum(np.square(a)) for a in jax.tree_util.tree_leaves(tree))))


def _port_grads(model, tree):
    """Port-ordered gradient tensors of a JAX-layout tree of gradients."""
    from equiformer_tpu_torch.utils import flax_paths

    out = []
    for name, path in flax_paths(model).items():
        node = tree
        for k in path:
            node = node[k]
        out.append(torch.from_numpy(np.ascontiguousarray(node.T if path[-1] == "kernel"
                                                         else node)))
    return out


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", topt.OPTIMIZERS)
def test_optimizer_matches_optax(name, clip):
    """Three updates of ``create_optimizer(opt_name=name)`` equal optax's
    (the JAX package's ``create_optimizer``) to 1e-12 relative, with the
    cosine schedule; the clip, where on, at half the smallest gradient norm
    of the three steps, so that it binds on each."""
    model = Leafy()
    tree = params_to_jax(model)
    grads = [_grads(tree, s) for s in range(STEPS)]
    c = 0.5 * min(_global_norm(g) for g in grads) if clip else None
    kw = dict(weight_decay=WD, grad_clip_norm=c, opt_name=name)
    jo = jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), **kw)
    to = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), **kw)
    jp, js = tree, jo.init(tree)
    state = to.init(model)
    params = dict(model.named_parameters())
    # fromage's float32 scalar 1 / sqrt(1 + lr^2) is correctly rounded
    # op by op, as the port computes it; compiled, XLA takes its float32
    # rsqrt, one ulp away at about half of all learning rates
    update = jo.update if name == "fromage" else _compiled(jo.update, grads[0], js, jp)
    for g in grads:
        upd, js = update(g, js, jp)
        jp = _tree_map(lambda a, u: np.asarray(a + u), jp, upd)
        to.update(params, _port_grads(model, g), state)
    assert state["count"] == STEPS
    got = params_to_jax(model)
    scale = max(np.abs(a).max() for a in jax.tree_util.tree_leaves(jp))
    moved = max(np.abs(a - b).max() for a, b in zip(jax.tree_util.tree_leaves(jp),
                                                    jax.tree_util.tree_leaves(tree)))
    assert moved > 1e-6 * scale
    for (path, want), have in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                  jax.tree_util.tree_leaves(got)):
        assert np.max(np.abs(have - want)) <= 1e-12 * scale, (name, path)


def test_radam_rectified_branch_matches_optax():
    """RAdam's rectified update (the SMA length at least 5 from the sixth
    step at b2 = 0.9) against optax over eight steps."""
    model = Leafy()
    tree = params_to_jax(model)
    kw = dict(beta2=0.9, opt_name="radam")
    jo = jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), **kw)
    to = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), **kw)
    jp, js, state = tree, jo.init(tree), to.init(model)
    params = dict(model.named_parameters())
    update = _compiled(jo.update, _grads(tree, 0), js, jp)
    for s in range(8):
        g = _grads(tree, s)
        upd, js = update(g, js, jp)
        jp = _tree_map(lambda a, u: np.asarray(a + u), jp, upd)
        to.update(params, _port_grads(model, g), state)
    scale = max(np.abs(a).max() for a in jax.tree_util.tree_leaves(jp))
    for want, have in zip(jax.tree_util.tree_leaves(jp),
                          jax.tree_util.tree_leaves(params_to_jax(model))):
        assert np.max(np.abs(have - want)) <= 1e-12 * scale


def test_unknown_optimizer_raises_value_error():
    sched = pt.cosine_warmup_schedule(LR, WARMUP, TOTAL)
    with pytest.raises(ValueError, match="unknown optimizer"):
        pt.create_optimizer(sched, opt_name="adamax")
    with pytest.raises(ValueError, match="unknown optimizer"):
        jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), opt_name="adamax")


def test_clip_factor_is_a_device_scalar_and_grad_norm_stays_unclipped():
    """The clip factor is a 0-dim tensor (no host number), 1 below the
    bound, c / norm at or above it."""
    gs = [torch.full((3,), 2.0, dtype=torch.float64), torch.full((4,), 2.0, dtype=torch.float64)]
    norm = float(np.sqrt(7 * 4.0))
    f = topt.clip_factor(gs, norm / 2)
    assert isinstance(f, torch.Tensor) and f.dim() == 0
    assert float(f) == pytest.approx(0.5, rel=1e-15)
    assert float(topt.clip_factor(gs, norm * 2)) == 1.0
    # a step's grad_norm is the norm before the clip, as in JAX
    batch, max_edges = _qm9_batch()
    runs = [_run_steps(_qm9_model(max_edges), batch, pt.make_qm9_steps,
                       [torch.Generator().manual_seed(0)], clip=clip) for clip in (None, 1e-3)]
    assert runs[0][0][0]["grad_norm"] == runs[1][0][0]["grad_norm"] > 1e-3
    assert any(not torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])


@pytest.mark.parametrize("cfg", [(5e-4, 100, (150, 400)), (2e-2, 2, (3, 5, 9), 0.5),
                                 (1e-3, 0, (0, 2), 0.1, 0.5)])
def test_multistep_warmup_schedule_matches(cfg):
    """Equal to JAX's float32 schedule around warmup and each milestone."""
    j = jopt.multistep_warmup_schedule(*cfg)
    t = pt.train.multistep_warmup_schedule(*cfg)
    steps = {0, 1, cfg[1] - 1, cfg[1], cfg[1] + 1}
    for m in cfg[2]:
        steps |= {m - 1, m, m + 1}
    for step in sorted(s for s in steps if s >= 0):
        want = float(j(step))
        assert abs(t(step) - want) <= 1e-6 * abs(want), step


# ------------------------------------------------------------ the models

QM9 = dict(irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
           fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
           num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", higher_order_grads=False)
MD17 = dict(irreps_node_embedding="8x0e+4x1e+4x2e+2x3e", num_layers=2,
            irreps_sh="1x0e+1x1e+1x2e+1x3e", number_of_basis=16, basis_type="exp",
            fc_neurons=(8, 8), irreps_feature="16x0e", irreps_head="4x0e+2x1e+2x2e+2x3e",
            num_heads=2, irreps_mlp_mid="8x0e+4x1e+4x2e+2x3e", max_atom_type=64,
            avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
            avg_degree=md17_models._AVG_DEGREE_MD17)
# every dropout site on: alpha dropout, the equivariant dropouts and drop path
DROPOUT = dict(alpha_drop=0.2, proj_drop=0.1, drop_path_rate=0.1)
ROUTES = {"fused": {}, "folded": {"radial_fold": True, "radial_fold_ho": True}}


def _qm9_batch(n=4):
    nodes, edges = cli_capacities(n, 30, 17)
    return next(iter(GraphLoader(qm9_like_dataset(n, seed=0), n, nodes, shuffle=False))), edges


def _md17_batch(n=2, atoms=9):
    """Packed into n x atoms node rows (not rounded up to 128, which would
    make the CPU steps several times as long), atoms + 1 edges a row."""
    nodes = n * atoms
    edges = nodes * (atoms + 1)
    data = md17_like_dataset(n, num_atoms=atoms, seed=0)
    return (next(iter(GraphLoader(data, n, nodes, shuffle=False, with_forces=True))),
            edges)


def _qm9_model(max_edges, seed=1, **kw):
    return TModel(**QM9, **DROPOUT, max_edges=max_edges, seed=seed, **kw).double()


def _run_steps(model, batch, make_steps, rngs, opt_name="adamw", clip=None):
    """Training steps of ``make_steps`` from ``model``'s weights, the i-th
    fed ``rngs[i]``; returns (metrics, parameters, EMA, block runs):
    the block runs count the calls of ``block_0``'s forward (remat's
    recomputes included)."""
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD,
                              grad_clip_norm=clip, opt_name=opt_name)
    step, _ = make_steps(model, opt)
    state = pt.TrainState.create(model, opt)
    runs = []
    hook = model.block_0.register_forward_pre_hook(lambda *_: runs.append(1))
    metrics = []
    for rng in rngs:
        state, m = step(state, batch, rng)
        metrics.append({k: float(v) for k, v in m.items()})
    hook.remove()
    return (metrics, {n: p.detach().clone() for n, p in model.named_parameters()},
            {n: e.clone() for n, e in state.ema.items()}, len(runs))


def _recorded_masks(model, batch, make_steps, seed, n_steps=2):
    """The keep masks ``n_steps`` steps of the un-rematted ``model`` draw
    from a generator seeded with ``seed``, step by step in call order."""
    gen = torch.Generator().manual_seed(seed)
    tapes = [MaskReplay(gen) for _ in range(n_steps)]
    _run_steps(model, batch, make_steps, [t.start() for t in tapes])
    assert all(t.masks for t in tapes)
    return [t.masks for t in tapes]


def _same(a, b):
    (ma, pa, ea, _), (mb, pb, eb, _) = a, b
    scale = max(float(p.abs().max()) for p in pa.values())
    for k in ma[0]:
        for x, y in zip(ma, mb):
            assert abs(x[k] - y[k]) <= 1e-12 * abs(y[k]), k
    for n in pa:
        assert float((pa[n] - pb[n]).abs().max()) <= 1e-12 * scale, n
        assert float((ea[n] - eb[n]).abs().max()) <= 1e-12 * scale, n


@pytest.mark.parametrize("source", ["generator", "masks"])
def test_remat_qm9_steps_match_and_leave_the_generator_alone(source):
    """Two QM9 steps with every dropout site on: remat=True equals
    remat=False to 1e-12, from a generator (which ends in the same state)
    or from injected masks (each iterator used up, no mask more); the
    rematted block runs twice a step (the forward and one recompute)."""
    batch, max_edges = _qm9_batch()
    steps = pt.make_qm9_steps
    if source == "generator":
        gens = [torch.Generator().manual_seed(5) for _ in range(2)]
        res = [_run_steps(_qm9_model(max_edges, remat=r), batch, steps, [g, g])
               for r, g in zip((False, True), gens)]
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
    else:
        masks = _recorded_masks(_qm9_model(max_edges), batch, steps, 7)
        its = [[iter(m) for m in masks] for _ in range(2)]
        res = [_run_steps(_qm9_model(max_edges, remat=r), batch, steps, it)
               for r, it in zip((False, True), its)]
        assert all(next(i, None) is None for it in its for i in it)
    _same(res[1], res[0])
    assert (res[0][3], res[1][3]) == (2, 4)


@pytest.mark.parametrize("source", ["generator", "masks"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_md17_force_step_matches(route, source):
    """One MD17 force training step (a double backward through the
    rematted blocks; the force pass under ``skip_leg_grads("W", "Wr")``,
    the parameter pass under ``skip_leg_grads("sh")``) with every dropout
    site on, on the fused and the folded route: remat=True equals
    remat=False to 1e-12 with the generator in the same state afterwards;
    the rematted block runs three times (the forward, the recompute of the
    force pass, the recompute of the parameter pass)."""
    batch, max_edges = _md17_batch()

    def model(remat):
        return TModel(**MD17, **DROPOUT, **ROUTES[route], max_edges=max_edges, seed=2,
                      remat=remat).double()

    steps = pt.make_md17_steps
    if source == "generator":
        gens = [torch.Generator().manual_seed(3) for _ in range(2)]
        res = [_run_steps(model(r), batch, steps, [g]) for r, g in zip((False, True), gens)]
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
    else:
        masks = _recorded_masks(model(False), batch, steps, 11, n_steps=1)
        its = [[iter(m) for m in masks] for _ in range(2)]
        res = [_run_steps(model(r), batch, steps, it) for r, it in zip((False, True), its)]
        assert all(next(i, None) is None for it in its for i in it)
    _same(res[1], res[0])
    assert (res[0][3], res[1][3]) == (1, 3)


def test_remat_is_off_by_default_and_skipped_without_grad():
    batch, max_edges = _qm9_batch()
    assert TModel(**QM9).remat is False
    m = _qm9_model(max_edges, remat=True).eval()
    runs = []
    m.block_0.register_forward_pre_hook(lambda *_: runs.append(1))
    with torch.no_grad():
        a = m(batch)
        b = _qm9_model(max_edges).eval()(batch)
    assert torch.equal(a, b) and len(runs) == 1


# ------------------------------------------------------------ checkpoints

def _jax_tree(model):
    return {"params": params_to_jax(model)}


def test_jax_npz_loads_into_the_port(tmp_path):
    """JAX's ``save_params`` of a tree -> the port's ``load_params``: the
    same bits as ``params_from_jax`` of that tree, and the same forward."""
    batch, max_edges = _qm9_batch()
    tree = _jax_tree(_qm9_model(max_edges, seed=4))
    jckpt.save_params(str(tmp_path / "best_val.npz"), tree)
    a, b = _qm9_model(max_edges), _qm9_model(max_edges)
    assert load_params(str(tmp_path / "best_val.npz"), a) == len(dict(a.named_parameters()))
    params_from_jax(b, tree)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(a.eval()(batch), b.eval()(batch))


def test_port_npz_loads_into_jax(tmp_path):
    """The port's ``save_params`` (of a module, and of an EMA copy through
    ``params_to_jax``) -> JAX's ``load_params`` with a ``jax.eval_shape``
    template of JAX's init: the same arrays, under the same keys."""
    batch, max_edges = _qm9_batch()
    model = _qm9_model(max_edges, seed=4)
    jcfg = {k: JIrreps(v) if k.startswith("irreps") else v for k, v in QM9.items()}
    jm = JModel(**jcfg, **DROPOUT, nonlinear_message=True, max_edges=max_edges)
    jbatch = next(iter(JLoader(qm9_like_dataset(4, seed=0), 4, batch.pos.shape[0],
                               shuffle=False)))
    template = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b, deterministic=True),
                              jbatch)
    ema = {n: p.detach() * 0.5 for n, p in model.named_parameters()}
    for src, want in ((model, _jax_tree(model)),
                      ({"params": params_to_jax(model, ema)},
                       {"params": params_to_jax(model, ema)})):
        save_params(str(tmp_path / "w.npz"), src)
        got = jckpt.load_params(str(tmp_path / "w.npz"), template)
        flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert len(flat_got) == len(flat_want)
        for path, arr in flat_got:
            assert np.array_equal(arr, flat_want[path]), path


def test_load_params_raises_as_jax(tmp_path):
    """A missing key raises KeyError and a wrong shape ValueError, in both
    packages, on the same files."""
    batch, max_edges = _qm9_batch()
    model = _qm9_model(max_edges)
    tree = _jax_tree(model)
    flat = {"/".join(str(k.key) for k in p): a
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    missing = dict(flat)
    del missing["params/block_0/ga/alpha_dot"]
    np.savez(tmp_path / "missing.npz", **missing)
    bad = dict(flat)
    bad["params/head_lin2/w0"] = np.zeros((3, 1))
    np.savez(tmp_path / "bad.npz", **bad)
    for loader, target in ((load_params, model), (jckpt.load_params, tree)):
        with pytest.raises(KeyError, match="block_0/ga/alpha_dot"):
            loader(str(tmp_path / "missing.npz"), target)
        with pytest.raises(ValueError, match="shape mismatch for params/head_lin2/w0"):
            loader(str(tmp_path / "bad.npz"), target)


def test_checkpoint_manager_prunes_and_keeps_metadata(tmp_path):
    """``max_to_keep`` removes the oldest steps, ``latest_step`` names the
    newest complete one (a leftover temporary file of a cut save is
    ignored), metadata comes back as it went in, and an empty directory
    restores (None, None)."""
    batch, max_edges = _qm9_batch()
    model = _qm9_model(max_edges)
    state = pt.TrainState.create(model, pt.create_optimizer(pt.cosine_warmup_schedule(LR, 1, 5)))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    assert mgr.latest_step() is None and mgr.restore(state) == (None, None)
    for step in range(1, 6):
        state.step = step
        mgr.save(step, state, {"epoch": step, "best_val": 0.5 / step, "tag": ["a", step]})
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3.pt", "4.pt", "5.pt"]
    (tmp_path / "ckpt" / ".7.pt.tmp").write_bytes(b"a save cut midway")
    assert mgr.latest_step() == 5
    restored, meta = mgr.restore(state)
    assert restored.step == 5 and meta == {"epoch": 5, "best_val": 0.1, "tag": ["a", 5]}
    _, meta = mgr.restore(state, step=3)
    assert meta["epoch"] == 3
    mgr.close()


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_checkpoint_resume_reproduces_the_uninterrupted_step(tmp_path, opt_name):
    """Steps 1-2, save, step 3; a fresh model and state (other weights)
    restored from step 2 then step 3: the same bits in the parameters, the
    optimizer state, the EMA and the step.  Dropout from a generator per
    step, remat on, a binding clip."""
    batch, max_edges = _qm9_batch()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)

    def setup(seed):
        model = _qm9_model(max_edges, seed=seed, remat=True)
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD,
                                  grad_clip_norm=0.05, opt_name=opt_name)
        step, _ = pt.make_qm9_steps(model, opt)
        return model, step, pt.TrainState.create(model, opt)

    def gen(i):
        return torch.Generator().manual_seed(100 + i)

    model, step, state = setup(1)
    for i in (1, 2):
        state, m = step(state, batch, gen(i))
    mgr.save(2, state, {"epoch": 0})
    state, m3 = step(state, batch, gen(3))

    model_b, step_b, state_b = setup(9)
    state_b, meta = mgr.restore(state_b)
    assert meta == {"epoch": 0} and state_b.step == 2
    state_b, m3b = step_b(state_b, batch, gen(3))
    assert state_b.step == state.step == 3
    assert {k: float(v) for k, v in m3b.items()} == {k: float(v) for k, v in m3.items()}
    for (n, p), q in zip(model.named_parameters(), model_b.parameters()):
        assert torch.equal(p, q), n
    for n in state.ema:
        assert torch.equal(state.ema[n], state_b.ema[n]), n
    flat = jax.tree_util.tree_flatten_with_path(state.opt_state)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(state_b.opt_state)[0])
    assert len(flat) == len(flat_b) > 0
    for path, v in flat:
        w = flat_b[path]
        assert (torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w), path


# ------------------------------------------------------------ entrypoints

def test_qm9_entrypoint_reference_compat_against_jax():
    """The QM9 entrypoint with ``task_mean``, ``task_std``, ``atomref`` and
    ``irreps_in`` (at reduced irreps, fp64): the forward equals JAX's
    entrypoint's to 1e-9 of the largest prediction, ``atomref`` adds its
    per-graph sums, and the two statistics are kept on the model."""
    irreps = dict(irreps_node_embedding="8x0e+4x1e+2x2e", irreps_head="4x0e+2x1e+2x2e",
                  irreps_mlp_mid="8x0e+4x1e+2x2e")
    atomref = np.linspace(-2.0, 3.0, 5).reshape(5, 1)
    batch, max_edges = _qm9_batch()
    kw = dict(num_basis=16, max_edges=max_edges, task_mean=0.3, task_std=1.7, atomref=atomref,
              irreps_in="5x0e", **irreps)
    make = pt.model_entrypoint("graph_attention_transformer_nonlinear_l2")
    tm = make(**kw, device="cpu").double().eval()
    assert (tm.task_mean, tm.task_std) == (0.3, 1.7)
    jm = j_entry("graph_attention_transformer_nonlinear_l2")(**kw)
    jbatch = next(iter(JLoader(qm9_like_dataset(4, seed=0), 4, batch.pos.shape[0],
                               shuffle=False)))
    jbatch = dataclasses.replace(jbatch, pos=np.asarray(jbatch.pos, np.float64))
    fwd = jax.jit(lambda p, b: jm.apply(p, b, deterministic=True))
    want = np.asarray(fwd.lower(_jax_tree(tm), jbatch).compile(
        {"xla_backend_optimization_level": 0})(_jax_tree(tm), jbatch))
    got = tm(batch.to(dtype=torch.float64)).detach().numpy()
    assert _rel(got, want) <= 1e-9
    plain = make(**{**kw, "atomref": None}, device="cpu").double().eval()
    ref = np.zeros(4)
    species, graph, real = (batch.species.numpy(), batch.batch.numpy(), batch.node_mask.numpy())
    np.add.at(ref, graph[real], atomref[species[real], 0])
    assert _rel(got - plain(batch.to(dtype=torch.float64)).detach().numpy(), ref) <= 1e-12


def test_md17_entrypoint_keeps_the_statistics_and_drops_atomref():
    make = pt.model_entrypoint("graph_attention_transformer_nonlinear_exp_l3_md17")
    m = make(max_edges=128, task_mean=-1.5, task_std=2.5, atomref=np.ones(64), irreps_in="64x0e",
             device="cpu")
    assert (m.task_mean, m.task_std, m.atomref) == (-1.5, 2.5, None)
