"""The ported MD17 energy + force evaluation against the JAX package.

A reduced force model (L3 SH, 2 blocks on 16x0e+8x1e+8x2e+4x3e, 4
md17-like molecules of 21 atoms; the exp and the bessel basis) runs through
both packages on one set of weights: the JAX model's own ``init`` with
``higher_order_grads=True``, loaded into the port with ``params_from_jax``.
On the CPU the JAX package takes its einsum / XLA path (no Pallas) and the
port its plain versions.  Tolerances on energies and forces, relative to the
largest value: fp64 1e-9.  In fp32 the forces of both packages lie far from
their fp64 values, because the radial bases' derivatives cancel (narrow
exp-normal gaussians, high-frequency Bessel sines): measured 3.3e-4 (exp)
and 6.5e-3 (bessel) for the JAX package itself.  So an fp32 result of the
port is held to the fp64 one within FP32_FACTOR times the JAX package's own
fp32 error (plus 1e-6); a bf16 result within BF16_FACTOR times JAX's own
bf16 error (~3e-2).  The full-width ``exp_l3`` case and the tree check
of the other MD17 entrypoints are marked slow.
"""

import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import optax  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.data import md17 as j_md17  # noqa: E402
from equiformer_tpu.data.synthetic import md17_like_dataset as j_md17_like  # noqa: E402
from equiformer_tpu.graph.batching import collate_dense as j_collate  # noqa: E402
from equiformer_tpu.models import model_entrypoint as j_entry  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.models.md17_models import energy_and_forces as j_energy_and_forces  # noqa: E402
from equiformer_tpu.train.engine import make_md17_steps  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.core.rotations import random_rotation, transform, wigner_D  # noqa: E402
from equiformer_tpu_torch.data import GraphLoader, load_md17, md17_like_dataset  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate_dense as t_collate  # noqa: E402
from equiformer_tpu_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from equiformer_tpu_torch.models import md17_models  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax  # noqa: E402

SLOTS, GRAPHS = 21, 4
REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+8x2e+4x3e", num_layers=2, irreps_sh="1x0e+1x1e+1x2e+1x3e",
    number_of_basis=32, fc_neurons=(16, 16), irreps_feature="32x0e",
    irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4, irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e",
    alpha_drop=0.0, max_atom_type=64, avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
    avg_degree=md17_models._AVG_DEGREE_MD17, max_edges=1536, nodes_per_graph=SLOTS,
)
DTYPES = {"fp64": (np.float64, torch.float64), "fp32": (np.float32, torch.float32)}
FP64_TOL = 1e-9
FP32_FACTOR = 3.0  # measured 1.0 (exp) and 2.3 (bessel)
# port bf16 error / JAX bf16 error vs fp64, energies and forces: measured
# 1.2 and 1.9 (exp), 1.0 and 0.7 (bessel)
BF16_FACTOR = 3.0
BF16_MIN_SHIFT = 1e-4
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
MD17_ENTRYPOINTS = [f"graph_attention_transformer_nonlinear_{v}_md17" for v in (
    "l2", "l2_e3", "bessel_l2", "exp_l2", "exp_l3", "exp_l3_e3", "bessel_l3", "bessel_l3_e3")]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _jax_batch(data, npdt):
    jb = j_collate(data, SLOTS, with_forces=True)
    return dataclasses.replace(jb, pos=np.asarray(jb.pos, npdt), y=np.asarray(jb.y, npdt),
                               forces=np.asarray(jb.forces, npdt))


def _torch_batch(data, tdt):
    return t_collate(data, SLOTS, with_forces=True).to(dtype=tdt)


def _cast(tree, npdt):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, npdt), tree)


@functools.lru_cache(maxsize=None)
def _reduced(basis):
    jcfg = {k: JIrreps(v) if k.startswith("irreps") else v for k, v in REDUCED.items()}
    jm = JModel(**jcfg, basis_type=basis, nonlinear_message=True, higher_order_grads=True)
    data = md17_like_dataset(GRAPHS, seed=0)
    tree = jax.jit(lambda b: jm.init(jax.random.PRNGKey(1), b, deterministic=True))(
        _jax_batch(data, np.float32))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tm = TModel(**REDUCED, basis_type=basis, seed=4)
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    return jm, tm.eval(), tree, data


@functools.lru_cache(maxsize=None)
def _jax_ref(basis, dt):
    """JAX's (energy, forces) of the reduced model in ``dt``."""
    jm, _, tree, data = _reduced(basis)
    npdt = DTYPES[dt][0]
    out = jax.jit(lambda p, b: j_energy_and_forces(jm, p, b))(
        _cast(tree, npdt), _jax_batch(data, npdt))
    return tuple(np.asarray(a) for a in out)


def _close(got, ref, dt):
    """fp64: within FP64_TOL of JAX's fp64; fp32: within FP32_FACTOR times
    JAX's own fp32 error of JAX's fp64."""
    if dt == "fp64":
        return _rel(got, ref["fp64"]) < FP64_TOL
    return _rel(got, ref["fp64"]) <= FP32_FACTOR * _rel(ref["fp32"], ref["fp64"]) + 1e-6


@pytest.fixture(scope="module")
def reduced_exp():
    return _reduced("exp")


def _port_ef(tm, data, tdt):
    return pt.energy_and_forces(tm.to(tdt), _torch_batch(data, tdt))


@pytest.mark.parametrize("basis, dt", [("exp", "fp64"), ("exp", "fp32"), ("bessel", "fp64"),
                                       pytest.param("bessel", "fp32", marks=pytest.mark.slow)])
def test_reduced_energy_and_forces_match_jax(basis, dt):
    _, tm, _, data = _reduced(basis)
    ref = {d: _jax_ref(basis, d) for d in (("fp64",) if dt == "fp64" else DTYPES)}
    te, tf = _port_ef(tm, data, DTYPES[dt][1])
    assert te.shape == (GRAPHS,) and tf.shape == (GRAPHS * SLOTS, 3)
    assert tf.dtype == DTYPES[dt][1]
    assert _close(te.numpy(), {k: v[0] for k, v in ref.items()}, dt)
    assert _close(tf.numpy(), {k: v[1] for k, v in ref.items()}, dt)
    assert float(tf.abs().max()) > 0.0


@pytest.mark.parametrize("basis", ["exp", pytest.param("bessel", marks=pytest.mark.slow)])
def test_reduced_bfloat16_energy_and_forces_match_jax(basis):
    """compute_dtype='bfloat16' in both packages, fp32 weights and positions.
    JAX's own bf16 forces lie 3.3e-2 (exp) and 2.8e-2 (bessel) of the
    largest force from its fp64 ones: bf16 features meet the bases'
    cancelling derivatives.  The two packages round at different points, so
    each is held to the fp64 values, the port within BF16_FACTOR times JAX's
    own bf16 error.  The run must be in bf16: it moves off JAX's fp32
    results by more than BF16_MIN_SHIFT."""
    jm, _, tree, data = _reduced(basis)
    ref = {"fp64": _jax_ref(basis, "fp64"), "fp32": _jax_ref(basis, "fp32")}
    jb = jax.jit(lambda p, b: j_energy_and_forces(jm.clone(compute_dtype="bfloat16"), p, b))(
        _cast(tree, np.float32), _jax_batch(data, np.float32))
    tm16 = TModel(**REDUCED, basis_type=basis, compute_dtype="bfloat16", seed=4).eval()
    params_from_jax(tm16, tree)
    got = pt.energy_and_forces(tm16, _torch_batch(data, torch.float32))
    for i, t in enumerate(got):
        assert t.dtype == torch.float32
        jerr = _rel(jb[i], ref["fp64"][i])
        assert _rel(t.numpy(), ref["fp64"][i]) <= BF16_FACTOR * jerr
        assert _rel(t.numpy(), ref["fp32"][i]) > BF16_MIN_SHIFT


def test_forces_are_equivariant(reduced_exp):
    """Rotated fp64 positions give the same energies and rotated forces,
    within 1e-9 of the largest value: the force path is built from
    equivariant pieces."""
    _, tm, _, data = reduced_exp
    R = random_rotation(np.random.default_rng(11))
    batch = _torch_batch(data, torch.float64)
    e, f = pt.energy_and_forces(tm.double(), batch)
    rotated = dataclasses.replace(batch, pos=batch.pos @ torch.from_numpy(R).T)
    er, fr = pt.energy_and_forces(tm, rotated)
    assert _rel(er.numpy(), e.numpy()) < 1e-9
    assert _rel(fr.numpy(), f.numpy() @ R.T) < 1e-9


def test_forces_are_the_finite_difference_of_the_energy(reduced_exp):
    """-dE/dpos against central differences of the summed energy (fp64
    positions moved by 1e-5 A: 1e-6 of max |F|) on a few coordinates of the
    first molecule; the slots of a padded graph get zero forces."""
    _, tm, _, data = reduced_exp
    batch = _torch_batch(data, torch.float64)
    e, f = pt.energy_and_forces(tm.double(), batch)
    padded = t_collate(data, SLOTS, graph_capacity=GRAPHS + 1).to(dtype=torch.float64)
    fp = pt.energy_and_forces(tm, padded)[1]
    assert torch.equal(fp[GRAPHS * SLOTS :], torch.zeros(SLOTS, 3, dtype=torch.float64))
    assert _rel(fp[: GRAPHS * SLOTS].numpy(), f.numpy()) < 1e-12
    h = 1e-5
    for atom, c in [(0, 0), (3, 1), (7, 2), (20, 0)]:
        sums = []
        for sign in (1.0, -1.0):
            pos = batch.pos.clone()
            pos[atom, c] += sign * h
            sums.append(float(pt.energy_and_forces(
                tm, dataclasses.replace(batch, pos=pos))[0].sum()))
        fd = -(sums[0] - sums[1]) / (2 * h)
        assert abs(fd - float(f[atom, c])) < 1e-6 * float(f.abs().max())


def test_evaluate_md17_matches_eval_step(reduced_exp):
    """The MAE sums of make_md17_steps' eval_step (fp64, 1e-9)."""
    jm, tm, tree, data = reduced_exp
    mean, std = 0.5, 2.0
    _, eval_step = make_md17_steps(jm, optax.sgd(0.1), task_mean=mean, task_std=std)
    j = jax.jit(eval_step)(_cast(tree, np.float64), _jax_batch(data, np.float64))
    with torch.no_grad():  # evaluate_md17 differentiates whatever the caller's mode
        t = pt.evaluate_md17(tm.double(), _torch_batch(data, torch.float64), mean, std)
    for k in ("mae_e_sum", "mae_f_sum"):
        assert _rel(float(t[k]), float(j[k])) < FP64_TOL
    assert float(t["count_e"]) == float(j["count_e"]) == GRAPHS
    assert float(t["count_f"]) == float(j["count_f"]) == 3 * GRAPHS * len(data[0]["pos"])
    assert not t["forces"].requires_grad and not t["energy"].requires_grad


def test_cpu_force_evaluation_launches_no_kernel(reduced_exp):
    """On the CPU every wrapper takes its plain version: an evaluation, and
    the force pass of training (``create_graph=True``, tested against the JAX
    package in ``tests/test_torch_md17_train.py``), leave every launch count
    at zero."""
    _, tm, _, data = reduced_exp
    batch = _torch_batch(data, torch.float32)
    reset_launch_counts()
    pt.evaluate_md17(tm.float(), batch)
    _, forces = pt.energy_and_forces(tm, batch, create_graph=True)
    assert forces.requires_grad
    assert set(launch_counts().values()) == {0}


def test_md17_like_data_and_collation_match_jax():
    data = md17_like_dataset(5, seed=3)
    jdata = j_md17_like(5, seed=3)
    for a, b in zip(data, jdata):
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    jb = j_collate(jdata, SLOTS, graph_capacity=6, with_forces=True)
    tb = t_collate(data, SLOTS, graph_capacity=6, with_forces=True)
    for k in ("pos", "species", "batch", "node_mask", "graph_mask", "y", "forces"):
        assert np.array_equal(getattr(tb, k).numpy(), np.asarray(getattr(jb, k))), k
    assert t_collate(data, SLOTS).forces is None
    loader = GraphLoader(data, 2, dense_slots=SLOTS, shuffle=False, with_forces=True)
    first = next(iter(loader))
    assert first.to("cpu").forces.shape == (2 * SLOTS, 3)
    assert np.array_equal(first.forces.numpy(), tb.forces.numpy()[: 2 * SLOTS])


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_load_md17_fixture_matches_jax(tmp_path, split):
    """The committed 30-frame aspirin file through both loaders (copies of
    the fixture, since the loaders cache their split beside the data)."""
    roots = []
    for name in ("jax", "torch"):
        roots.append(tmp_path / name)
        shutil.copytree(os.path.join(FIX, "md17_raw"), roots[-1])
    jg, jmean, jstd = j_md17.load_md17(str(roots[0]), "aspirin", split, n_train=20, n_val=5)
    tg, tmean, tstd = load_md17(str(roots[1]), "aspirin", split, n_train=20, n_val=5)
    assert (tmean, tstd) == (jmean, jstd)
    assert len(tg) == len(jg) == {"train": 20, "valid": 5, "test": 5}[split]
    for a, b in zip(tg, jg):
        for k in ("pos", "species", "y", "forces"):
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    again, _, _ = load_md17(str(roots[1]), "aspirin", split, n_train=20, n_val=5)  # cached split
    assert all(np.array_equal(a["pos"], b["pos"]) for a, b in zip(again, tg))


def test_rotations_match_jax():
    from equiformer_tpu.core import rotations as jrot

    R = random_rotation(np.random.default_rng(4))
    assert np.array_equal(R, jrot.random_rotation(np.random.default_rng(4)))
    for l in range(4):
        assert np.allclose(wigner_D(l, R), jrot.wigner_D(l, R), atol=1e-10)
    irr = "4x0e+2x1e+2x2e+1x3e"
    x = np.random.default_rng(5).normal(size=(3, 4 + 6 + 10 + 7))
    assert np.allclose(transform(irr, x, R), jrot.transform(JIrreps(irr), x, R), atol=1e-10)


def _jax_tree_shapes(name):
    jm = j_entry(name)(max_edges=512, nodes_per_graph=SLOTS)
    b = _jax_batch(md17_like_dataset(2, seed=0), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), b, deterministic=True))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("name", [n if n.endswith("exp_l3_md17") else
                                  pytest.param(n, marks=pytest.mark.slow)
                                  for n in MD17_ENTRYPOINTS])
def test_md17_entrypoint_loads_its_jax_tree(name):
    """Every registered MD17 entrypoint takes its JAX tree with no leaf
    unused and no parameter unset (the headline exp_l3 in the fast tier)."""
    tree = _jax_tree_shapes(name)
    tm = pt.model_entrypoint(name)(max_edges=512, nodes_per_graph=SLOTS, device="cpu")
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))


@pytest.mark.slow
def test_full_width_exp_l3_energy_and_forces_match_jax():
    name = "graph_attention_transformer_nonlinear_exp_l3_md17"
    data = md17_like_dataset(2, seed=2)
    jm = j_entry(name)(max_edges=1024, nodes_per_graph=SLOTS)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(0), b, deterministic=True))(
        _jax_batch(data, np.float32)))
    tm = pt.model_entrypoint(name)(max_edges=1024, nodes_per_graph=SLOTS, device="cpu")
    params_from_jax(tm, tree)
    f = jax.jit(lambda p, b: j_energy_and_forces(jm, p, b))
    ref = {dt: tuple(np.asarray(a) for a in f(_cast(tree, npdt), _jax_batch(data, npdt)))
           for dt, (npdt, _) in DTYPES.items()}
    for dt, (_, tdt) in DTYPES.items():
        te, tf = pt.energy_and_forces(tm.eval().to(tdt), _torch_batch(data, tdt))
        assert _close(te.numpy(), {k: v[0] for k, v in ref.items()}, dt)
        assert _close(tf.numpy(), {k: v[1] for k, v in ref.items()}, dt)
