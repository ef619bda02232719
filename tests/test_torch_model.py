"""The ported QM9 inference slice against the JAX package.

A reduced flagship (2 blocks on 16x0e+8x1e+4x2e, 4 graphs; heads wide
enough that the attention takes the fused-combine route) runs through both
packages on one set of weights: the JAX model's own ``init``, loaded into
the port with ``params_from_jax``.  Tolerances on the predictions: fp64 1e-9
relative, fp32 1e-4 relative (float32 sums in another order through two
blocks), ``compute_dtype='bfloat16'`` 2e-2 relative (see that test).  The
full-width flagship case is marked slow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import optax  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.data import qm9_like_dataset  # noqa: E402
from equiformer_tpu.graph.batching import collate_dense as j_collate  # noqa: E402
from equiformer_tpu.models import model_entrypoint as j_entry  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.train.engine import make_qm9_steps  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate_dense as t_collate  # noqa: E402
from equiformer_tpu_torch.kernels import (  # noqa: E402
    attn_combine,
    csr_segment_sum,
    dtp_lin_bwd,
    dtp_lin_fwd,
    reset_launch_counts,
)
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax, torch_name  # noqa: E402

REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
    fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
    num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=512, nodes_per_graph=30,
)
DTYPES = {"fp64": (np.float64, torch.float64, 1e-9), "fp32": (np.float32, torch.float32, 1e-4)}
FLAGSHIP_PARAMS = 3_531_715
FLAGSHIP_LEAVES = 276
# port vs JAX, both in bf16, measured 4.6e-3 relative on the reduced flagship
BF16_TOL = 2e-2
# a bf16 forward lies ~5e-3 from the fp32 one; one that ignored compute_dtype
# would lie ~1e-7 from it
BF16_MIN_SHIFT = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _jax_batch(data, npdt):
    jb = j_collate(data, 30)
    return jb.__class__(**{**jb.__dict__, "pos": np.asarray(jb.pos, npdt),
                           "y": np.asarray(jb.y, npdt)})


def _jax_init(jmodel, data):
    """The JAX model's own parameter tree, as numpy arrays."""
    tree = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, deterministic=True))(
        _jax_batch(data, np.float32))
    return jax.tree_util.tree_map(np.asarray, tree)


def _reduced(num_graphs=4):
    jcfg = {k: JIrreps(v) if k.startswith("irreps") else v for k, v in REDUCED.items()}
    jm = JModel(**jcfg, nonlinear_message=True, higher_order_grads=False)
    data = qm9_like_dataset(num_graphs, seed=0)
    tree = _jax_init(jm, data)
    tm = TModel(**REDUCED, higher_order_grads=False, seed=2).eval()
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    return jm, tm, tree, data


@pytest.fixture(scope="module")
def reduced():
    return _reduced()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_reduced_flagship_forward_matches_jax(reduced, dt):
    npdt, tdt, tol = DTYPES[dt]
    jm, tm, tree, data = reduced
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, npdt), tree)
    j = np.asarray(jax.jit(lambda p, b: jm.apply(p, b, deterministic=True))(
        p, _jax_batch(data, npdt)))
    t = tm.to(tdt)(t_collate(data, 30).to(dtype=tdt)).detach().numpy()
    assert t.shape == (4,) and t.dtype == npdt
    assert _rel(t, j) < tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_evaluate_matches_eval_step(reduced, dt):
    npdt, tdt, tol = DTYPES[dt]
    jm, tm, tree, data = reduced
    mean, std = 0.5, 2.0
    _, eval_step = make_qm9_steps(jm, optax.sgd(0.1), task_mean=mean, task_std=std)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, npdt), tree)
    j = jax.jit(eval_step)(p, _jax_batch(data, npdt))
    t = pt.evaluate(tm.to(tdt), t_collate(data, 30).to(dtype=tdt), mean, std)
    assert _rel(float(t["mae_sum"]), float(j["mae_sum"])) < tol
    assert float(t["count"]) == float(j["count"]) == 4.0


def test_reduced_flagship_bfloat16_matches_jax(reduced):
    """compute_dtype='bfloat16' in both packages, fp32 weights and positions.
    The two round features to bf16 at different points (the einsum TP, the
    layer norm, the attention sums), so they agree only to bf16 level:
    BF16_TOL.  The run must also really be in bf16: its blocks emit bf16 and
    its predictions move off the fp32 ones by more than BF16_MIN_SHIFT."""
    jm, tm, tree, data = reduced
    j = np.asarray(jax.jit(lambda p, b: jm.clone(compute_dtype="bfloat16").apply(
        p, b, deterministic=True))(tree, _jax_batch(data, np.float32)))
    tm16 = TModel(**REDUCED, higher_order_grads=False, compute_dtype="bfloat16", seed=3).eval()
    params_from_jax(tm16, tree)
    emitted = []
    tm16.block_0.register_forward_hook(lambda m, i, o: emitted.append(o.dtype))
    t = tm16(t_collate(data, 30)).detach().numpy()
    t32 = tm.float()(t_collate(data, 30)).detach().numpy()
    assert emitted == [torch.bfloat16]
    assert t.shape == (4,) and t.dtype == np.float32
    assert _rel(t, j) < BF16_TOL
    assert _rel(t, t32) > BF16_MIN_SHIFT


def test_cpu_forward_launches_no_kernel_and_eval_only(reduced):
    """CPU tensors never launch a kernel, in eval or in training mode; the
    training mode's alpha dropout needs an explicit generator."""
    _, tm, _, data = reduced
    reset_launch_counts()
    out = tm.float()(t_collate(data, 30))
    assert bool(out.isfinite().all())
    tm.train()
    try:
        with pytest.raises(ValueError):
            tm(t_collate(data, 30))  # alpha_drop 0.2 and no generator
        loss = tm(t_collate(data, 30), rng=torch.Generator().manual_seed(0)).sum()
        loss.backward()
    finally:
        tm.eval()
        tm.zero_grad(set_to_none=True)
    assert bool(loss.isfinite())
    assert (dtp_lin_fwd.launches, dtp_lin_bwd.launches, csr_segment_sum.launches,
            attn_combine.launches) == (0, 0, 0, 0)


def test_flagship_parameter_count_and_leaves():
    tm = pt.model_entrypoint("graph_attention_transformer_nonlinear_l2")(max_edges=1024,
                                                                     nodes_per_graph=30,
                                                                     device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == FLAGSHIP_PARAMS
    jm = j_entry("graph_attention_transformer_nonlinear_l2")(max_edges=1024, nodes_per_graph=30)
    tree = _jax_init(jm, qm9_like_dataset(2, seed=0))
    leaves = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    assert len(leaves) == FLAGSHIP_LEAVES
    assert sum(a.size for _, a in leaves) == FLAGSHIP_PARAMS
    assert params_from_jax(tm, tree) == FLAGSHIP_LEAVES
    params = dict(tm.named_parameters())
    for path, a in leaves:
        keys = tuple(k.key for k in path)
        want = a.T if keys[-1] == "kernel" else a
        assert np.array_equal(params[torch_name(keys)].detach().numpy(), want), keys


@pytest.mark.slow
@pytest.mark.parametrize("dt", list(DTYPES))
def test_full_width_flagship_matches_jax(dt):
    npdt, tdt, tol = DTYPES[dt]
    data = qm9_like_dataset(2, seed=3)
    jm = j_entry("graph_attention_transformer_nonlinear_l2")(max_edges=1024, nodes_per_graph=30)
    tree = _jax_init(jm, data)
    tm = pt.model_entrypoint("graph_attention_transformer_nonlinear_l2")(max_edges=1024, seed=5,
                                                                     nodes_per_graph=30,
                                                                     device="cpu")
    params_from_jax(tm, tree)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, npdt), tree)
    j = np.asarray(jax.jit(lambda p, b: jm.apply(p, b, deterministic=True))(
        p, _jax_batch(data, npdt)))
    t = tm.eval().to(tdt)(t_collate(data, 30).to(dtype=tdt)).detach().numpy()
    assert _rel(t, j) < tol
