"""The port's QM9 training step against the JAX package's.

Schedule, weight-decay mask, AdamW update and EMA each against their JAX /
optax counterparts; then three full training steps (forward in training
mode, backward through the plain versions of every kernel, AdamW, EMA) of
a reduced flagship (2 blocks on 16x0e+8x1e+4x2e, 4 graphs) from one set of
weights, the JAX model's own ``init``.  ``alpha_drop=0`` keeps both sides
deterministic (the dropout masks themselves are held to JAX in
``test_torch_nn.py``).  Tolerances, relative to the largest JAX value:
fp64 1e-9 (the same arithmetic in another order through two blocks and
three updates), fp32 1e-4 (float32 sums in another order),
``compute_dtype='bfloat16'`` 2e-2 (the two packages round features to bf16
at different points).  One exception, in fp32 and bf16: Adam divides each
gradient element by its own magnitude, so an element whose exact gradient is
zero (about a tenth of the reduced model's: paths of the last block that
feed only l > 0 outputs, which its scalar head never reads) moves by the
sign of rounding noise times the learning rate, differently in the two
packages.  Those elements, found from a float64 gradient, are held only to
the largest steps Adam can take.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.data import qm9_like_dataset  # noqa: E402
from equiformer_tpu.graph.batching import collate_dense as j_collate  # noqa: E402
from equiformer_tpu.models import model_entrypoint as j_entry  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.train import engine as jeng, optim as jopt, state as jstate  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate_dense as t_collate  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.train import ema_update, no_weight_decay_mask  # noqa: E402
from equiformer_tpu_torch.utils import ema_from_jax, params_from_jax, torch_name  # noqa: E402

REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
    fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
    num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=512, nodes_per_graph=30,
)
# a schedule that warms up and decays within the three steps, so each step
# runs at another learning rate; EMA decay low enough that the EMA moves
LR, WARMUP, TOTAL, WD, EMA = 2e-2, 2, 6, 5e-3, 0.5
MEAN, STD = 0.3, 1.7
STEPS = 3
CASES = {"fp64": (np.float64, torch.float64, None, 1e-9),
         "fp32": (np.float32, torch.float32, None, 1e-4),
         "bf16": (np.float32, torch.float32, "bfloat16", 2e-2)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _jax_batch(data, npdt):
    jb = j_collate(data, 30)
    return jb.__class__(**{**jb.__dict__, "pos": np.asarray(jb.pos, npdt),
                           "y": np.asarray(jb.y, npdt)})


def _jax_init(jmodel, data):
    tree = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, deterministic=True))(
        _jax_batch(data, np.float32))
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """{port parameter name: array} of a flax parameter tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    return {torch_name(tuple(k.key for k in path)): np.asarray(a) for path, a in flat}


def _flip(name, a):
    """flax Dense kernels are [in, out], torch Linear weights [out, in]."""
    return a.T if name.endswith(".weight") and a.ndim == 2 else a


def _port_array(name, t):
    return _flip(name, t.detach().numpy())


@pytest.fixture(scope="module")
def reduced():
    jcfg = {k: JIrreps(v) if k.startswith("irreps") else v for k, v in REDUCED.items()}
    data = qm9_like_dataset(4, seed=0)
    tree = _jax_init(JModel(**jcfg, nonlinear_message=True, higher_order_grads=False,
                            alpha_drop=0.0), data)
    return jcfg, tree, data


@pytest.fixture(scope="module")
def dead(reduced):
    """{name: bool array}: elements whose float64 gradient of the first
    step's loss is zero up to rounding (1e-12 of the largest)."""
    _, tree, data = reduced
    tm = TModel(**REDUCED, higher_order_grads=False, alpha_drop=0.0).double()
    params_from_jax(tm, tree)
    b = t_collate(data, 30).to(dtype=torch.float64)
    err = tm.train()(b) - (b.y - MEAN) / STD
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(torch.abs(err).mean(), list(params.values()))
    top = max(float(g.abs().max()) for g in grads)
    return {n: _flip(n, (g.abs() < 1e-12 * top).numpy()) for n, g in zip(params, grads)}


@pytest.mark.parametrize("cfg", [(5e-4, 100, 100000), (LR, WARMUP, TOTAL), (1e-3, 0, 5)])
def test_cosine_warmup_schedule_matches(cfg):
    """Equal to JAX's float32 schedule at steps 0..N within 1e-6 relative:
    the two libraries' float32 cos may differ by an ulp, and 1 + cos
    amplifies that near the end of the decay."""
    j = jopt.cosine_warmup_schedule(*cfg)
    t = pt.cosine_warmup_schedule(*cfg)
    for step in list(range(12)) + [cfg[1], cfg[2] - 1, cfg[2], cfg[2] + 7]:
        want = float(j(step))
        assert abs(t(step) - want) <= 1e-6 * abs(want), step


def test_no_weight_decay_mask_matches_leaf_by_leaf():
    data = qm9_like_dataset(2, seed=0)
    jm = j_entry("graph_attention_transformer_nonlinear_l2")(max_edges=1024, nodes_per_graph=30)
    tree = _jax_init(jm, data)
    jmask = jopt.no_weight_decay_mask(tree)
    flat = jax.tree_util.tree_flatten_with_path(jmask["params"])[0]
    tm = pt.model_entrypoint("graph_attention_transformer_nonlinear_l2")(max_edges=1024,
                                                                         device="cpu")
    mask = no_weight_decay_mask(tm)
    assert len(flat) == len(mask) == 276
    for path, decay in flat:
        assert mask[torch_name(tuple(k.key for k in path))] == bool(decay), path
    assert 0 < sum(mask.values()) < 276


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape), tree)


def test_adamw_updates_match_optax_fp64(reduced):
    """Three AdamW updates on the same gradients equal optax.adamw with the
    JAX package's mask to 1e-12 relative (fp64)."""
    jcfg, tree, _ = reduced
    p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    opt = jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD)
    tm = TModel(**REDUCED, higher_order_grads=False, alpha_drop=0.0).double()
    params_from_jax(tm, p64)
    topt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD)
    tstate = topt.init(tm)
    jp, jstate_ = p64, opt.init(p64)
    params = dict(tm.named_parameters())
    for step in range(3):
        g = _random_like(p64, step)
        upd, jstate_ = opt.update(g, jstate_, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        grads = _leaves(g)
        topt.update(params, [torch.from_numpy(_flip(n, grads[n]).copy()) for n in params],
                    tstate)
    want = _leaves(jp)
    for n, p in params.items():
        assert _rel(_port_array(n, p), want[n]) < 1e-12, n


def test_ema_update_matches(reduced):
    _, tree, _ = reduced
    a = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)
    b = _random_like(a, 7)
    want = _leaves(jopt.ema_update(a, b, 0.999))
    ema = {n: torch.from_numpy(v.copy()) for n, v in _leaves(a).items()}
    ema_update(ema, {n: torch.from_numpy(v) for n, v in _leaves(b).items()}, 0.999)
    for n in ema:
        assert _rel(ema[n].numpy(), want[n]) < 1e-15


def test_ema_from_jax_fills_the_ema_copy_only(reduced):
    _, tree, _ = reduced
    tm = TModel(**REDUCED, higher_order_grads=False)
    params_from_jax(tm, tree)
    state = pt.TrainState.create(tm, pt.create_optimizer(pt.cosine_warmup_schedule(LR, 1, 2)))
    other = _random_like(tree, 8)
    assert ema_from_jax(state, other) == len(state.ema)
    want, params = _leaves(other), _leaves(tree)
    for n, p in state.params.items():
        assert np.allclose(_flip(n, state.ema[n].numpy()), want[n], rtol=1e-6)
        assert np.array_equal(_flip(n, p.detach().numpy()), params[n].astype(np.float32))
        assert state.ema[n].data_ptr() != p.data_ptr()


@pytest.mark.parametrize("case", list(CASES))
def test_training_steps_match_make_qm9_steps(reduced, dead, case):
    npdt, tdt, compute, tol = CASES[case]
    jcfg, tree, data = reduced
    jm = JModel(**jcfg, nonlinear_message=True, higher_order_grads=False, alpha_drop=0.0,
                compute_dtype=compute)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, npdt), tree)
    opt = jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD)
    j_step, _ = jeng.make_qm9_steps(jm, opt, task_mean=MEAN, task_std=STD, ema_decay=EMA)
    j_step = jax.jit(j_step)
    jst = jstate.TrainState.create(p, opt)
    jb = _jax_batch(data, npdt)

    tm = TModel(**REDUCED, higher_order_grads=False, alpha_drop=0.0, compute_dtype=compute).to(tdt)
    params_from_jax(tm, p)
    topt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD)
    tst = pt.TrainState.create(tm, topt)
    t_step, _ = pt.make_qm9_steps(tm, topt, task_mean=MEAN, task_std=STD, ema_decay=EMA)
    tb = t_collate(data, 30).to(dtype=tdt)
    for i in range(STEPS):
        jst, jm_ = j_step(jst, jb, jax.random.PRNGKey(i))
        tst, tm_ = t_step(tst, tb, None)
        for k in ("loss", "mae", "grad_norm"):
            assert _rel(float(tm_[k]), float(jm_[k])) < tol, (i, k)
    assert tst.step == int(jst.step) == STEPS
    want_p, want_e = _leaves(jst.params), _leaves(jst.ema_params)
    got_p = {n: _port_array(n, t) for n, t in tst.params.items()}
    got_e = {n: _port_array(n, t) for n, t in tst.ema.items()}
    assert set(got_p) == set(want_p)
    # the largest deviation of any parameter, relative to the largest JAX
    # parameter; elements with a zero exact gradient (see the module doc),
    # in fp32 and bf16, only within the two packages moving apart by Adam's
    # per-element bound lr (1 - b1) / sqrt(1 - b2) (+ decay) at each step
    scale = max(np.abs(v).max() for v in want_p.values())
    adam_max = 2 * sum(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL)(i) for i in range(STEPS)) * (
        0.1 / 0.001 ** 0.5 + WD * scale)
    n_dead = sum(int(m.sum()) for m in dead.values())
    assert 0 < n_dead < 0.2 * sum(m.size for m in dead.values())
    for got, want in ((got_p, want_p), (got_e, want_e)):
        for n in got:
            d = np.abs(got[n] - want[n])
            live = np.ones_like(d, bool) if case == "fp64" else ~dead[n]
            assert d[live].max(initial=0.0) < tol * scale, n
            assert d.max() <= adam_max, n
    # three steps move the parameters by ~1.4e-2 of their scale: far above
    # the fp64 / fp32 bounds; in bf16 the per-step loss, MAE and gradient
    # norm carry the comparison and the parameter bound is a sanity check
    init = _leaves(p)
    if case != "bf16":
        assert max(np.abs(want_p[n] - init[n]).max() for n in init) > 100 * tol * scale


def test_train_step_draws_or_replays_dropout_masks(reduced):
    """Alpha dropout on: the same generator seed, or the same injected
    masks, give the same step; another seed gives another loss."""
    _, tree, data = reduced
    batch = t_collate(data, 30)

    def one_step(rng):
        tm = TModel(**REDUCED, higher_order_grads=False, alpha_drop=0.2)
        params_from_jax(tm, tree)
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL))
        step, _ = pt.make_qm9_steps(tm, opt)
        return step(pt.TrainState.create(tm, opt), batch, rng)[1]

    a = one_step(torch.Generator().manual_seed(1))
    b = one_step(torch.Generator().manual_seed(1))
    c = one_step(torch.Generator().manual_seed(2))
    assert float(a["loss"]) == float(b["loss"]) != float(c["loss"])
    keep = [torch.rand(512, 4, generator=torch.Generator().manual_seed(9 + i)) < 0.8
            for i in range(2)]
    d = one_step(iter(keep))
    e = one_step(iter([k.clone() for k in keep]))
    assert float(d["grad_norm"]) == float(e["grad_norm"])


def test_model_entrypoint_builds_on_the_card_or_raises():
    make = pt.model_entrypoint("graph_attention_transformer_nonlinear_l2")
    if torch.cuda.is_available():
        assert next(make(max_edges=256).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(max_edges=256)
    assert next(make(max_edges=256, device="cpu").parameters()).device.type == "cpu"
