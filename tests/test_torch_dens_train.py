"""Three ``make_dens_steps`` of the port against the JAX package's, on the
reduced L3 DeNS model of ``tests/test_torch_dens.py`` (its sizes, batches,
noise and helpers, imported from there), each step fed JAX's noise draw.

Tolerances as there: fp64 1e-9 relative to the largest JAX value (the
parameters and the EMA against max |param|); the fp32 steps, which need a
second compilation of the L3 grad-of-grad, are in the slow tier.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from equiformer_tpu.train import engine as jeng, state as jstate  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from test_torch_jax_ref import fast_jit  # noqa: E402
from test_torch_dens import (  # noqa: E402,F401  (sizes: the module fixture)
    DP_WEIGHT, DTYPES, FP32_FACTOR, FP64_TOL, LR, METRICS, STEPS, TOTAL, WARMUP, WD,
    _leaves, _noised, _optimizers, _port_leaves, _rel, _step_kwargs, _to_torch,
    sizes,
)


@pytest.fixture(scope="module")
def jax_steps(sizes):
    """(size, dt) -> (the three noised batches, per-step metrics, final
    parameters, final EMA) of three steps of one jitted JAX DeNS train_step
    from PRNGKey(i)."""
    done = {}

    def run(key, dt):
        if (key, dt) not in done:
            size = sizes(key)
            npdt = DTYPES[dt][0]
            opt, _ = _optimizers()
            step, _ = jeng.make_dens_steps(size.jm, opt, **_step_kwargs())
            step = fast_jit(step) if dt == "fp64" else jax.jit(step)
            st = jstate.TrainState.create(
                jax.tree_util.tree_map(lambda a: np.asarray(a, npdt), size.tree), opt)
            jb, noised, metrics = size.batch(npdt), [], []
            for i in range(STEPS):
                rng = jax.random.PRNGKey(i)
                noised.append(_noised(jb, jax.random.split(rng)[0]))  # the step's own draw
                st, m = step(st, jb, rng, np.asarray(DP_WEIGHT, npdt))
                metrics.append({k: float(m[k]) for k in METRICS})
            done[key, dt] = (noised, metrics, _leaves(st.params), _leaves(st.ema_params))
        return done[key, dt]

    return run


def _port_steps(size, noised, dt):
    tdt = DTYPES[dt][1]
    tm = size.model(tdt)
    _, opt = _optimizers()
    step, _ = pt.make_dens_steps(tm, opt, **_step_kwargs())
    st, metrics = pt.TrainState.create(tm, opt), []
    for jb in noised:
        st, m = step.noised(st, _to_torch(jb, tdt), DP_WEIGHT)
        assert all(v.dim() == 0 and not v.requires_grad for v in m.values())
        metrics.append({k: float(m[k]) for k in METRICS})
    assert st.step == len(noised)
    return metrics, _port_leaves(st.params), _port_leaves(st.ema)


def test_dens_training_steps_match_make_dens_steps_fp64(sizes, jax_steps):
    """Three steps of make_dens_steps in fp64 at the L3 size (the L3 SH and
    force encoding, the wide head's gradients), each fed JAX's noise draw:
    loss, loss_e, loss_f, loss_dp and the gradient norm of every step within
    1e-9; the parameters and the EMA within 1e-9 of max |param|; every
    draw noised some atoms and left others clean, and the steps moved the
    parameters."""
    size = sizes("l3")
    noised, jmet, jp, je = jax_steps("l3", "fp64")
    for jb in noised:
        nm = np.asarray(jb.extras["noise_mask"])
        assert 0 < nm.sum() < np.asarray(jb.node_mask).sum()
    tmet, tp, te = _port_steps(size, noised, "fp64")
    for i in range(STEPS):
        for k in METRICS:
            assert _rel(tmet[i][k], jmet[i][k]) < FP64_TOL, (i, k)
        assert tmet[i]["loss_dp"] > 0 and tmet[i]["loss_f"] > 0
    assert set(tp) == set(jp)
    scale = max(np.abs(v).max() for v in jp.values())
    for got, want in ((tp, jp), (te, je)):
        assert max(np.abs(got[n] - want[n]).max() for n in got) < FP64_TOL * scale
    init = _leaves(size.tree)
    assert max(np.abs(jp[n] - init[n]).max() for n in init) > 1e4 * FP64_TOL * scale


@pytest.mark.slow
def test_dens_training_steps_match_make_dens_steps_fp32(sizes, jax_steps):
    """Three fp32 steps fed JAX's fp32 noise draws: each metric within
    FP32_FACTOR times the JAX package's own fp32 distance to its fp64 value
    (plus 1e-5), the parameters with a nonzero fp64 gradient likewise
    against max |param|, the others within Adam's largest step."""
    size = sizes("l3")
    n64, j64, jp64, _ = jax_steps("l3", "fp64")
    n32, j32, jp32, _ = jax_steps("l3", "fp32")
    tmet, tp, _ = _port_steps(size, n32, "fp32")
    for i in range(STEPS):
        for k in METRICS:
            bound = FP32_FACTOR * _rel(j32[i][k], j64[i][k]) + 1e-5
            assert _rel(tmet[i][k], j64[i][k]) <= bound, (i, k)
    # the first step's fp64 gradient says which elements Adam moves by noise
    tm = size.model(torch.float64)
    rec = _Recorder(_optimizers()[1])
    step, _ = pt.make_dens_steps(tm, rec, **_step_kwargs())
    step.noised(pt.TrainState.create(tm, rec), _to_torch(n64[0], torch.float64), DP_WEIGHT)
    grads = {n: g.numpy() for n, g in zip(dict(tm.named_parameters()), rec.grads)}
    top = max(np.abs(g).max() for g in grads.values())
    dead = {n: np.abs(g) < 1e-12 * top for n, g in grads.items()}
    assert sum(int(m.sum()) for m in dead.values()) < 0.3 * sum(m.size for m in dead.values())
    scale = max(np.abs(v).max() for v in jp64.values())
    adam_max = 2 * sum(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL)(i) for i in range(STEPS)) * (
        0.1 / 0.001 ** 0.5 + WD * scale)
    jax_dist = max(np.abs(jp32[n] - jp64[n])[~dead[n]].max(initial=0.0) for n in tp)
    for n in tp:
        d = np.abs(tp[n].astype(np.float64) - jp64[n])
        assert d[~dead[n]].max(initial=0.0) <= FP32_FACTOR * jax_dist + 1e-6 * scale, n
        assert d.max() <= adam_max, n


class _Recorder:
    """An optimizer that keeps a copy of the gradients it is handed."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, model):
        return self.opt.init(model)

    def update(self, params, grads, state):
        self.grads = [g.detach().clone() for g in grads]
        self.opt.update(params, grads, state)
