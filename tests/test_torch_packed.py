"""The port's packed graph layout against the JAX package's.

The packed layout is the JAX models' default (``nodes_per_graph=0``) and
what both CLIs load: ``collate`` packs the graphs' atoms one after another
into a node capacity, ``radius_graph`` builds the [N, N] adjacency, and the
src side of every gather's backward, which has no reverse twin there, sums
through the src-sort plan (``graph.radius_graph.src_sort_plan``) where JAX
scatters without sorting.  Inputs come from numpy seeds; capacities follow
the CLIs' formulas (``cli/train_qm9.py:58-59``, ``cli/train_md17.py:83-84``)
at the reduced batch sizes.

Tolerances: index arrays exactly; the gathers and their gradients 1e-12
relative; the models and steps (the reduced sizes of ``tests/test_torch_model.py``,
the MD17 force model on its irreps, and ``test_torch_dens.py``'s TINY_L2,
the force models at one block, fp64) 1e-9 of the largest JAX value; the port's two layouts on the same molecules and
weights 1e-12.  The weights are the port's seeded init written into a flax
tree (checked leaf by leaf against the JAX model's ``init`` traced by
``jax.eval_shape``), so no JAX init is compiled; each JAX function is
compiled once (``fast_jit``), the MD17 forces and step in one.
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.data import GraphLoader as JLoader  # noqa: E402
from equiformer_tpu.graph import batching as jb, linear_prims as jlp, segment as js  # noqa: E402
from equiformer_tpu.models import dens as jdens  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.models.md17_models import energy_and_forces as j_energy_and_forces  # noqa: E402
from equiformer_tpu.train import engine as jeng, optim as jopt, state as jstate  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.data import GraphLoader as TLoader  # noqa: E402
from equiformer_tpu_torch.data import md17_like_dataset, qm9_like_dataset  # noqa: E402
from equiformer_tpu_torch.graph import batching as tb, linear_prims as tlp  # noqa: E402
from equiformer_tpu_torch.graph import radius_graph as tr, segment as ts  # noqa: E402
from equiformer_tpu_torch.graph.batching import GraphsTuple  # noqa: E402
from equiformer_tpu_torch.models import md17_models  # noqa: E402
from equiformer_tpu_torch.models.dens import EquiformerDeNS  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.utils import flax_paths, params_from_jax, torch_name  # noqa: E402
from test_torch_jax_ref import fast_jit  # noqa: E402

# the JAX package's graph/__init__ re-exports a function named radius_graph
jr = importlib.import_module("equiformer_tpu.graph.radius_graph")

QM9 = dict(
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
    fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
    num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", higher_order_grads=False, alpha_drop=0.0,
)
# the force model at the reduced QM9 irreps (SH to l=2, as the exp_l2 MD17
# entrypoints) and one block, the DeNS model at one block: the grad-of-grad's
# JAX compile is most of this file's time (~100 s for MD17 at L3, ~40 s at
# L2), and one block runs every gather of the layout
MD17 = dict(
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=1, number_of_basis=32, basis_type="exp",
    fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e", num_heads=4,
    irreps_mlp_mid="24x0e+12x1e+6x2e", alpha_drop=0.0, max_atom_type=64,
    avg_num_nodes=md17_models._AVG_NUM_NODES_MD17, avg_degree=md17_models._AVG_DEGREE_MD17,
)
DENS = dict(  # tests/test_torch_dens.py's TINY_L2, one block
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=1, irreps_sh="1x0e+1x1e+1x2e",
    max_radius=3.0, number_of_basis=8, basis_type="exp", fc_neurons=(8, 8),
    irreps_feature="32x0e+16x1e+8x2e", irreps_head="4x0e+2x1e+1x2e", num_heads=2,
    irreps_pre_attn="16x0e+8x1e+4x2e", irreps_mlp_mid="16x0e+8x1e+4x2e", alpha_drop=0.0,
    proj_drop=0.0, max_atom_type=10,
)
LR, WARMUP, TOTAL, EMA = 2e-3, 2, 6, 0.5
MEAN, STD = 0.3, 1.7
TOL = 1e-9
GATHER_TOL = 1e-12

# two torch threads a worker under pytest-xdist (see tests/test_torch_md17_train.py)
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _round128(n):
    return -(-n // 128) * 128


def _f64(b):
    """A JAX batch with float64 floats."""
    cv = lambda a: None if a is None else (  # noqa: E731
        np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else a)
    return dataclasses.replace(b, pos=cv(b.pos), y=cv(b.y), forces=cv(b.forces),
                               extras={k: cv(v) for k, v in b.extras.items()})


def _to_torch(b) -> GraphsTuple:
    """The port's batch of a JAX batch: indices int64, floats float64."""
    def cv(a):
        if a is None:
            return None
        t = torch.from_numpy(np.array(a))
        return t.double() if t.is_floating_point() else t.long() if t.dtype == torch.int32 else t

    return GraphsTuple(pos=cv(b.pos), species=cv(b.species), batch=cv(b.batch),
                       node_mask=cv(b.node_mask), graph_mask=cv(b.graph_mask), y=cv(b.y),
                       forces=cv(b.forces), extras={k: cv(v) for k, v in b.extras.items()})


def _tree_of(module, jm, jbatch):
    """The flax tree of the port ``module``'s seeded weights (float64),
    with the leaf paths and shapes of ``jm.init`` traced by eval_shape."""
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b, deterministic=True),
                            jbatch)
    tree = {}
    for name, path in flax_paths(module).items():
        a = module.get_parameter(name).detach().double().numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.T if path[-1] == "kernel" else a
    want = {tuple(k.key for k in p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    got = {tuple(k.key for k in p): v.shape
           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want
    return {"params": tree}


def _leaves(tree):
    """{port parameter name: array in the port's layout} of a flax tree."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
        name = torch_name(tuple(k.key for k in path))
        a = np.asarray(a)
        out[name] = a.T if name.endswith(".weight") and a.ndim == 2 else a
    return out


def _port_leaves(named):
    return {n: t.detach().numpy().copy() for n, t in named.items()}


def _params_close(got, want):
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    assert max(np.abs(got[n] - want[n]).max() for n in got) < TOL * scale


def _optimizers(wd):
    return (jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=wd),
            pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=wd))


# ------------------------------------------------------------ batching

def _graphs_with_extras(n, seed):
    rng = np.random.default_rng(seed)
    data = md17_like_dataset(n, num_atoms=9, seed=seed)
    for g in data:
        g["charge"] = rng.normal(size=(9,)).astype(np.float32)
        g["tag"] = rng.integers(0, 3, size=(9, 2)).astype(np.int32)
        g["cell"] = rng.normal(size=(3, 3)).astype(np.float64)
    return data


@pytest.mark.parametrize("case", ["full", "partial", "plain"])
def test_collate_matches_jax(case):
    """``collate`` gives JAX's arrays, the extras' too (species and batch in
    int64 where JAX's are int32), for a full batch, a partial one (3 graphs
    in 5 slots: the padding nodes on graph 4) and one without extras."""
    data = _graphs_with_extras(5, seed=2)
    kw = dict(with_forces=True, extra_node_keys=("charge", "tag"), extra_graph_keys=("cell",))
    if case == "partial":
        data, kw["graph_capacity"] = data[:3], 5
    if case == "plain":
        data, kw = qm9_like_dataset(4, seed=1), {}
    j = jb.collate(data, 128, **kw)
    t = tb.collate(data, 128, **kw)
    for k in ("pos", "species", "batch", "node_mask", "graph_mask", "y", "forces"):
        a, b = getattr(j, k), getattr(t, k)
        if a is None:
            assert b is None
            continue
        assert np.array_equal(a, b.numpy()), k
    assert t.species.dtype == t.batch.dtype == torch.int64
    assert set(t.extras) == set(j.extras)
    for k, v in j.extras.items():
        assert t.extras[k].numpy().dtype == v.dtype and np.array_equal(t.extras[k].numpy(), v), k
    if case == "partial":
        assert bool((t.batch[int(t.node_mask.sum()):] == 4).all())
    with pytest.raises(ValueError):
        tb.collate(data, 8, **kw)


@pytest.mark.parametrize("args", [(3840, 17.0), (256, 22.0, 1.0), (100, 3.3, 1.2), (0, 5.0)])
def test_edge_capacity_for_matches_jax(args):
    assert tb.edge_capacity_for(*args) == jb.edge_capacity_for(*args)


@pytest.mark.parametrize("shuffle, drop_last", [(False, True), (True, True), (True, False)],
                         ids=["ordered", "shuffled", "last-partial"])
def test_loader_packed_matches_jax(shuffle, drop_last):
    """The packed ``GraphLoader`` yields JAX's batches: the default node
    capacity (batch size x the largest molecule), the shuffle order by seed
    and epoch, and with ``drop_last=False`` the last partial batch padded
    to the batch size."""
    data = qm9_like_dataset(11, seed=4)
    jl = JLoader(data, 4, shuffle=shuffle, seed=3, drop_last=drop_last, use_native=False)
    tl = TLoader(data, 4, shuffle=shuffle, seed=3, drop_last=drop_last)
    assert tl.node_capacity == jl.node_capacity and len(tl) == len(jl) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs
        n = 0
        for a, b in zip(jl, tl):
            for k in ("pos", "species", "batch", "node_mask", "graph_mask", "y"):
                assert np.array_equal(getattr(a, k), getattr(b, k).numpy()), k
            n += 1
        assert n == len(tl)
    if not drop_last:
        assert b.graph_mask.tolist() == [True, True, True, False]


# ------------------------------------------------------------ the graph

def _packed_qm9(n=4, seed=1, node_cap=128):
    data = qm9_like_dataset(n, seed=seed)
    return data, jb.collate(data, node_cap, n), tb.collate(data, node_cap, n)


@pytest.mark.parametrize("max_edges", [2176, 400], ids=["fits", "truncates"])
def test_radius_graph_matches_jax_and_sorts_src(max_edges):
    """src, dst and mask equal JAX's element by element, padding (N-1, N-1)
    and truncation included; the src-sort plan is a stable sort of src over
    every slot, so each node's edges as src come in increasing dst."""
    _, j, t = _packed_qm9()
    e_j = jr.radius_graph(jnp.asarray(j.pos), jnp.asarray(j.batch), jnp.asarray(j.node_mask),
                          5.0, max_edges)
    e_t = tr.radius_graph(t.pos, t.batch, t.node_mask, 5.0, max_edges)
    for k in ("src", "dst", "mask"):
        assert np.array_equal(np.asarray(getattr(e_j, k)), getattr(e_t, k).numpy()), k
    n_real = int(e_t.mask.sum())
    if max_edges == 400:
        assert n_real == 400
    else:
        assert 400 < n_real < max_edges
        assert bool((e_t.src[n_real:] == 127).all() and (e_t.dst[n_real:] == 127).all())
    plan = tr.src_sort_plan(e_t)
    E = max_edges
    assert torch.equal(plan.order[plan.order_inv], torch.arange(E))
    assert torch.equal(plan.ids, e_t.src[plan.order])
    assert bool((plan.ids[1:] >= plan.ids[:-1]).all())
    same = plan.ids[1:] == plan.ids[:-1]
    assert bool((plan.order[1:][same] > plan.order[:-1][same]).all())  # stable
    assert bool((e_t.dst[plan.order][1:][same] >= e_t.dst[plan.order][:-1][same]).all())


def _truncated_graph():
    """A packed fp64 batch and its graph truncated at 300 edges, on both sides."""
    _, j, t = _packed_qm9()
    t = t.to(dtype=torch.float64)
    e_t = tr.radius_graph(t.pos, t.batch, t.node_mask, 5.0, 300)
    e_t = e_t._replace(src_plan=tr.src_sort_plan(e_t))
    e_j = jr.EdgeList(*(jnp.asarray(x.numpy()) for x in (e_t.src, e_t.dst, e_t.mask)))
    return t, e_t, e_j


def _grads_to_second_order(j_fn, t_fn, x):
    """(value, gradient, gradient of <gradient, v>) of a scalar function in
    both packages at ``x``."""
    v = np.random.default_rng(9).normal(size=x.shape)
    j_g = jax.grad(j_fn)
    j_out = (j_fn(x), j_g(x), jax.grad(lambda a: jnp.sum(j_g(a) * v))(x))
    xt = torch.tensor(x, requires_grad=True)
    val = t_fn(xt)
    (g,) = torch.autograd.grad(val, xt, create_graph=True)
    (gg,) = torch.autograd.grad((g * torch.from_numpy(v)).sum(), xt)
    return j_out, (val.detach(), g.detach(), gg)


def test_gather_add_through_the_src_plan_matches_jax(monkeypatch):
    """``gather_add`` with the src-sort plan at a truncating ``max_edges``
    against JAX's ``gather_add(rev=None)`` (its unsorted scatter): values and
    both gradients, and the grad-of-grad of its src side through
    ``take_rows`` against JAX's ``take_rows`` without a sort, within 1e-12;
    every backward sums over non-decreasing ids."""
    t, e_t, e_j = _truncated_graph()
    rng = np.random.default_rng(3)
    N, E = t.pos.shape[0], e_t.src.shape[0]
    xs, xd, w = rng.normal(size=(N, 130)), rng.normal(size=(N, 130)), rng.normal(size=(E, 130))
    m = e_t.mask.numpy()[:, None]
    ids_seen = []
    real = tlp.segsum_rows
    monkeypatch.setattr(tlp, "segsum_rows", lambda v, ids, *a, **k: (
        ids_seen.append(ids), real(v, ids, *a, **k))[1])

    def j_fn(a, b):
        return jnp.sum(jnp.tanh(js.gather_add(a, b, e_j.src, e_j.dst, N)) * w * m)

    j_val, j_grads = j_fn(xs, xd), jax.grad(j_fn, argnums=(0, 1))(xs, xd)
    a, b = (torch.tensor(x, requires_grad=True) for x in (xs, xd))
    val = (torch.tanh(ts.gather_add(a, b, e_t.src, e_t.dst, N, src_plan=e_t.src_plan))
           * torch.from_numpy(w * m)).sum()
    grads = torch.autograd.grad(val, (a, b))
    assert _rel(val.detach(), j_val) < GATHER_TOL
    for g, jg in zip(grads, j_grads):
        assert _rel(g, jg) < GATHER_TOL

    j_out, t_out = _grads_to_second_order(
        lambda x: jnp.sum(jnp.sin(jlp.take_rows(x, e_j.src)) * w * m),
        lambda x: (torch.sin(ts.take_src(x, e_t.src, e_t.dst, src_plan=e_t.src_plan))
                   * torch.from_numpy(w * m)).sum(), xs)
    for got, want in zip(t_out, j_out):
        assert _rel(got, want) < GATHER_TOL
    assert len(ids_seen) >= 4 and all(bool((i[1:] >= i[:-1]).all()) for i in ids_seen)
    with pytest.raises(ValueError, match="src_plan"):
        ts.gather_add(a, b, e_t.src, e_t.dst, N)


def test_edge_vectors_through_the_src_plan_match_jax():
    """``edge_vectors`` on the packed graph (no twins) at a truncating
    ``max_edges`` against JAX's: vectors, lengths, the position gradient and
    its grad-of-grad within 1e-12; without a plan or twins it raises."""
    t, e_t, e_j = _truncated_graph()
    rng = np.random.default_rng(5)
    E = e_t.src.shape[0]
    u, w = rng.normal(size=(E, 3)), rng.normal(size=(E,))
    jv, jl_ = jr.edge_vectors(jnp.asarray(t.pos.numpy()), e_j)
    tv, tl_ = tr.edge_vectors(t.pos, e_t)
    assert _rel(tv, jv) < GATHER_TOL and _rel(tl_, jl_) < GATHER_TOL

    def j_fn(p):
        v, ln = jr.edge_vectors(p, e_j)
        return jnp.sum(jnp.sin(ln) * w) + jnp.sum(v * v * u)

    def t_fn(p):
        v, ln = tr.edge_vectors(p, e_t)
        return (torch.sin(ln) * torch.from_numpy(w)).sum() + (v * v * torch.from_numpy(u)).sum()

    for got, want in zip(*reversed(_grads_to_second_order(j_fn, t_fn, t.pos.numpy()))):
        assert _rel(got, want) < GATHER_TOL
    with pytest.raises(ValueError, match="rev"):
        tr.edge_vectors(t.pos, e_t._replace(src_plan=None))


# ------------------------------------------------------------ the models

class _Case:
    """One reduced model in both layouts: the JAX model and its packed
    fp64 batch, the port's seeded weights as a flax tree."""

    def __init__(self, kind):
        if kind == "qm9":
            self.n, atoms, self.data = 4, 30, qm9_like_dataset(4, seed=0)
            node_cap, self.max_edges = tb.cli_capacities(4, 30, 17)
            self.kw, self.jcls, self.tcls = QM9, JModel, TModel
            jextra, forces = dict(nonlinear_message=True), False
        elif kind == "md17":
            self.n, atoms, self.data = 4, 21, md17_like_dataset(4, seed=0)
            node_cap, self.max_edges = tb.cli_capacities(4, 21, 22)
            self.kw, self.jcls, self.tcls = MD17, JModel, TModel
            jextra, forces = dict(nonlinear_message=True, higher_order_grads=True), True
        else:
            self.n, atoms, self.data = 2, 9, md17_like_dataset(2, num_atoms=9, seed=21)
            node_cap, self.max_edges = tb.cli_capacities(2, 9, 10)
            self.kw, self.jcls, self.tcls = DENS, jdens.EquiformerDeNS, EquiformerDeNS
            jextra, forces = {}, True
        self.atoms, self.node_cap, self.forces = atoms, node_cap, forces
        jcfg = {k: JIrreps(v) if k.startswith("irreps") else v for k, v in self.kw.items()}
        self.jm = self.jcls(**jcfg, **jextra, max_edges=self.max_edges)
        self.jbatch = _f64(jb.collate(self.data, node_cap, self.n, with_forces=forces))
        self.tree = _tree_of(self.model(seed=1), self.jm, self.jbatch)
        self._jax = {}

    def model(self, nodes_per_graph=0, seed=4, max_edges=None):
        return self.tcls(**self.kw, max_edges=max_edges or self.max_edges,
                         nodes_per_graph=nodes_per_graph, seed=seed).double()

    def loaded(self, nodes_per_graph=0, max_edges=None):
        tm = self.model(nodes_per_graph, max_edges=max_edges)
        assert params_from_jax(tm, self.tree) == len(jax.tree_util.tree_leaves(self.tree))
        return tm

    def batch(self, packed=True):
        if packed:
            return tb.collate(self.data, self.node_cap, self.n, with_forces=self.forces).to(
                dtype=torch.float64)
        return tb.collate_dense(self.data, self.atoms, self.n, with_forces=self.forces).to(
            dtype=torch.float64)

    def jax(self, what, fn):
        if what not in self._jax:
            self._jax[what] = jax.tree_util.tree_map(np.asarray, fn())
        return self._jax[what]


@pytest.fixture(scope="module")
def cases():
    made = {}

    def get(kind):
        if kind not in made:
            made[kind] = _Case(kind)
        return made[kind]

    return get


def test_packed_qm9_forward_matches_jax(cases):
    c = cases("qm9")
    fwd = lambda p, b: c.jm.apply(p, b, deterministic=True)  # noqa: E731
    j = c.jax("forward", lambda: fast_jit(fwd)(c.tree, c.jbatch))
    t = c.loaded().eval()(c.batch()).detach().numpy()
    assert t.shape == (4,) and _rel(t, j) < TOL


def test_packed_qm9_training_steps_match_make_qm9_steps(cases):
    """Three ``make_qm9_steps`` steps on the packed layout, as
    ``tests/test_torch_train.py::test_training_steps_match_make_qm9_steps``
    in fp64: loss, MAE and gradient norm of each step, the parameters and
    the EMA within 1e-9."""
    c = cases("qm9")
    jopt_, topt = _optimizers(5e-3)

    def run_jax():
        step, _ = jeng.make_qm9_steps(c.jm, jopt_, task_mean=MEAN, task_std=STD, ema_decay=EMA)
        st, metrics = jstate.TrainState.create(c.tree, jopt_), []
        step = fast_jit(step)
        for i in range(3):
            st, m = step(st, c.jbatch, jax.random.PRNGKey(i))
            metrics.append({k: float(m[k]) for k in ("loss", "mae", "grad_norm")})
        return metrics, _leaves(st.params), _leaves(st.ema_params)

    jmet, jp, je = c.jax("steps", run_jax)
    tm = c.loaded()
    step, _ = pt.make_qm9_steps(tm, topt, task_mean=MEAN, task_std=STD, ema_decay=EMA)
    st, b = pt.TrainState.create(tm, topt), c.batch()
    for i in range(3):
        st, m = step(st, b, None)
        for k in ("loss", "mae", "grad_norm"):
            assert _rel(float(m[k]), jmet[i][k]) < TOL, (i, k)
    _params_close(_port_leaves(st.params), jp)
    _params_close(_port_leaves(st.ema), je)


def test_packed_md17_forces_and_training_step_match_jax(cases):
    """Energies and forces of the reduced exp-basis force model on the
    packed layout (44 padding nodes of 128), and one ``make_md17_steps``
    step (the grad-of-grad through the src-sort plan at every order), fp64
    within 1e-9; JAX computes both in one compiled function."""
    c = cases("md17")
    jopt_, topt = _optimizers(1e-6)
    keys = ("loss", "loss_e", "loss_f", "mae_e", "mae_f", "grad_norm")
    kw = dict(task_mean=0.5, task_std=2.0, energy_weight=1.0, force_weight=80.0, ema_decay=EMA)

    def run_jax():
        step, _ = jeng.make_md17_steps(c.jm, jopt_, **kw)
        args = (jstate.TrainState.create(c.tree, jopt_), c.jbatch, jax.random.PRNGKey(0))
        both = lambda st, b, k: (j_energy_and_forces(c.jm, st.params, b), step(st, b, k))  # noqa: E731
        (e, f), (st, m) = fast_jit(both)(*args)
        return e, f, {k: float(m[k]) for k in keys}, _leaves(st.params)

    je, jf, jmet, jp = c.jax("forces and step", run_jax)
    te, tf = pt.energy_and_forces(c.loaded().eval(), c.batch())
    assert tf.shape == (128, 3) and _rel(te, je) < TOL and _rel(tf, jf) < TOL
    assert float(tf[84:].abs().max()) == 0.0
    tm = c.loaded()
    step, _ = pt.make_md17_steps(tm, topt, **kw)
    st, m = step(pt.TrainState.create(tm, topt), c.batch())
    for k in keys:
        assert _rel(float(m[k]), jmet[k]) < TOL, k
    _params_close(_port_leaves(st.params), jp)


def test_packed_dens_training_step_matches_make_dens_steps(cases):
    """One ``make_dens_steps`` step of the TINY_L2 DeNS model on the packed
    layout (``max_edges`` the MD17 CLI's formula), fed JAX's noise draw
    (the step's own key split), fp64 within 1e-9; the noise picks and
    masks by ``graph_pick[batch] & node_mask`` on packed rows."""
    c = cases("dens")
    kw = dict(task_mean=0.5, task_std=2.0, energy_weight=1.0, force_weight=80.0,
              denoising_pos_std=0.05, denoising_pos_prob=0.5, corrupt_ratio=0.5, ema_decay=EMA)
    keys = ("loss", "loss_e", "loss_f", "loss_dp", "grad_norm")
    jopt_, topt = _optimizers(1e-6)
    rng = jax.random.PRNGKey(2)

    def run_jax():
        step, _ = jeng.make_dens_steps(c.jm, jopt_, **kw)
        args = (jstate.TrainState.create(c.tree, jopt_), c.jbatch, rng, np.asarray(5.0))
        st, m = fast_jit(step)(*args)
        return {k: float(m[k]) for k in keys}, _leaves(st.params)

    jmet, jp = c.jax("step", run_jax)
    noised = jdens.add_masked_gaussian_noise(c.jbatch, jax.random.split(rng)[0], std=0.05,
                                             prob=0.5, corrupt_ratio=0.5)
    nm = np.asarray(noised.extras["noise_mask"])
    assert 0 < nm.sum() < 18 and not nm[18:].any()
    tm = c.loaded()
    step, _ = pt.make_dens_steps(tm, topt, **kw)
    st, m = step.noised(pt.TrainState.create(tm, topt), _to_torch(noised), 5.0)
    for k in keys:
        assert _rel(float(m[k]), jmet[k]) < TOL, k
    _params_close(_port_leaves(st.params), jp)


@pytest.mark.parametrize("kind", ["qm9", "md17", "dens"])
def test_layouts_agree_on_the_same_molecules(cases, kind):
    """The port's packed and fixed-slot layouts on the same molecules and
    weights: the real edges come in the same order in both, so predictions
    (QM9) or energies and forces (MD17; DeNS on clean atoms) agree within
    1e-12, the forces row by row through the node offsets."""
    c = cases(kind)
    dense_edges = _round128(c.n * c.atoms * c.atoms)
    packed, dense = c.loaded(0).eval(), c.loaded(c.atoms, dense_edges).eval()
    if kind == "qm9":
        a, b = packed(c.batch()).detach(), dense(c.batch(False)).detach()
        assert _rel(a, b) < GATHER_TOL
        return
    fn = pt.energy_and_forces if kind == "md17" else pt.dens_outputs
    (ea, fa), (eb, fb) = fn(packed, c.batch()), fn(dense, c.batch(False))
    bp, bd = c.batch(), c.batch(False)
    assert _rel(ea, eb) < GATHER_TOL
    assert _rel(fa[bp.node_mask], fb[bd.node_mask]) < GATHER_TOL


def test_params_from_jax_serves_both_layouts(cases):
    """The parameter tree does not depend on the layout: JAX's init traces
    to the same leaves with ``nodes_per_graph`` 0 and 30, and one tree
    loads into the port's packed and fixed-slot models alike."""
    c = cases("qm9")
    jcfg = {k: JIrreps(v) if k.startswith("irreps") else v for k, v in QM9.items()}
    dense_batch = _f64(jb.collate_dense(c.data, 30))
    shapes = [jax.eval_shape(lambda b, m=m: m.init(jax.random.PRNGKey(0), b, deterministic=True),
                             bt)
              for m, bt in ((c.jm, c.jbatch),
                            (JModel(**jcfg, nonlinear_message=True, max_edges=512,
                                    nodes_per_graph=30), dense_batch))]
    flat = [{tuple(k.key for k in p): v.shape
             for p, v in jax.tree_util.tree_flatten_with_path(s)[0]} for s in shapes]
    assert flat[0] == flat[1]
    a, b = c.loaded(0), c.loaded(30)
    for (n, p), (m, q) in zip(a.named_parameters(), b.named_parameters()):
        assert n == m and torch.equal(p, q)


def test_defaults_take_the_packed_layout():
    """``GraphAttentionTransformer`` and ``EquiformerDeNS`` default to the
    packed layout, as JAX's do, and build there."""
    import inspect

    for t, j in ((TModel, JModel), (EquiformerDeNS, jdens.EquiformerDeNS)):
        assert inspect.signature(t).parameters["nodes_per_graph"].default == 0
        assert j.__dataclass_fields__["nodes_per_graph"].default == 0
    data = qm9_like_dataset(3, seed=6)
    tm = TModel(**QM9, max_edges=1024).eval()
    out = tm(next(iter(TLoader(data, 3, shuffle=False))))
    assert out.shape == (3,) and bool(out.isfinite().all())
    assert EquiformerDeNS().nodes_per_graph == 0
