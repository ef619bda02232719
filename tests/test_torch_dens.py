"""The port's DeNS model and training step against the JAX package's.

Two reduced sizes, each in the fixed-slot layout: ``TINY_L2`` (the
configuration of ``tests/test_dens.py::_tiny_dens``, 2 molecules of 9
atoms) and ``REDUCED_L3`` (L3 SH and inputs, 2 blocks on
16x0e+8x1e+8x2e+4x3e, a wide ``irreps_feature`` of 32x0e+16x1e+16x2e+8x3e,
4 md17-like molecules of 21 atoms).  The weights are the port's seeded
init (``EquiformerDeNS(seed=1)``), written into a flax tree by
``flax_paths`` (its leaf paths and shapes checked against the JAX model's
``init``, traced by ``jax.eval_shape``): the JAX model applies that tree,
and each port model under test loads it back with ``params_from_jax``.
``jax.random`` and ``torch.Generator`` draw other numbers, so the
comparisons take the noised batch from JAX's ``add_masked_gaussian_noise``
(a fixed key) and feed it to both packages: to the port's model,
``dens_outputs`` and ``make_dens_steps``' ``train_step.noised``, and to the
JAX model and the JAX ``train_step`` whose noise key splits to the same
one.  The port's own noise function is tested on its semantics and its
repeatability.

Tolerances: fp64 1e-9 relative to the largest JAX value (the parameters and
the EMA against max |param|).  fp32 three-step metrics and parameters are
held to the fp64 ones within FP32_FACTOR times the JAX package's own fp32
distance, as in ``tests/test_torch_md17_train.py`` (fp32 forces are noisy
in both packages; Adam moves an element whose exact gradient is zero by the
sign of rounding noise, so those are held only to Adam's largest step).
Each JAX function is jitted once per size and model and computed once per
batch (``_Size._jax``, ``jax_steps``); tracing and compiling them (the L3
training step's grad-of-grad alone ~75 s) take most of the file's time.
The fp32 steps, which need a second compilation, and the full-width aspirin
L3 step are in the slow tier.
"""

import dataclasses
import importlib.util
import inspect
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.core.rotations import random_rotation  # noqa: E402
from equiformer_tpu.graph.radius_graph import EdgeList as JEdgeList  # noqa: E402
from equiformer_tpu.graph.batching import collate_dense as j_collate  # noqa: E402
from equiformer_tpu.models import dens as jdens  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttention as JGraphAttention  # noqa: E402
from equiformer_tpu.train import engine as jeng, optim as jopt, state as jstate  # noqa: E402
from equiformer_tpu.utils.config import load_config  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.core import Irreps  # noqa: E402
from equiformer_tpu_torch.core.rotations import wigner_D  # noqa: E402
from equiformer_tpu_torch.core.spherical import spherical_harmonics_for_irreps  # noqa: E402
from equiformer_tpu_torch.data import md17_like_dataset  # noqa: E402
from equiformer_tpu_torch.graph.batching import GraphsTuple  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate_dense as t_collate  # noqa: E402
from equiformer_tpu_torch.graph.radius_graph import (  # noqa: E402
    edge_vectors,
    radius_graph_dense,
    reverse_edge_perm_dense,
)
from equiformer_tpu_torch.graph.segment import active_edge_bound  # noqa: E402
from equiformer_tpu_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from equiformer_tpu_torch.models.dens import EquiformerDeNS  # noqa: E402
from equiformer_tpu_torch.models.equiformer import (  # noqa: E402
    GraphAttention,
    GraphAttentionTransformer,
)
from equiformer_tpu_torch.nn.linear import init_parameters  # noqa: E402
from equiformer_tpu_torch.utils import flax_paths, params_from_jax, torch_name  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY_L2 = dict(
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, irreps_sh="1x0e+1x1e+1x2e",
    max_radius=3.0, number_of_basis=8, basis_type="exp", fc_neurons=(8, 8),
    irreps_feature="32x0e+16x1e+8x2e", irreps_head="4x0e+2x1e+1x2e", num_heads=2,
    irreps_pre_attn="16x0e+8x1e+4x2e", irreps_mlp_mid="16x0e+8x1e+4x2e", alpha_drop=0.0,
    proj_drop=0.0, max_atom_type=10, max_edges=1024, nodes_per_graph=9,
)
REDUCED_L3 = dict(
    irreps_equivariant_inputs="1x0e+1x1e+1x2e+1x3e", irreps_node_embedding="16x0e+8x1e+8x2e+4x3e",
    num_layers=2, irreps_sh="1x0e+1x1e+1x2e+1x3e", number_of_basis=32, basis_type="exp",
    fc_neurons=(16, 16), irreps_feature="32x0e+16x1e+16x2e+8x3e",
    irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4, irreps_pre_attn="16x0e+8x1e+8x2e+4x3e",
    irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e", max_edges=1536, nodes_per_graph=21,
)
# (config, molecules, atoms a molecule, dataset seed)
SIZES = {"l2": (TINY_L2, 2, 9, 21), "l3": (REDUCED_L3, 4, 21, 0)}
# the recipe's noise (bench.py --task dens) but prob 0.5: the reduced
# batches of 2-4 molecules then have noised and clean atoms
STD, PROB, CORRUPT, DP_WEIGHT = 0.05, 0.5, 0.5, 5.0
LR, WARMUP, TOTAL, WD, EMA = 2e-3, 2, 6, 1e-6, 0.5
MEAN, E_WEIGHT, F_WEIGHT = 0.5, 1.0, 80.0
STEPS = 3
METRICS = ("loss", "loss_e", "loss_f", "loss_dp", "grad_norm")
DTYPES = {"fp64": (np.float64, torch.float64), "fp32": (np.float32, torch.float32)}
FP64_TOL = 1e-9
FP32_FACTOR = 3.0

# Under pytest-xdist every worker imports every test file; two torch threads
# a worker keep the grad-of-grad's small einsums from oversubscribing the
# cores (see tests/test_torch_md17_train.py).
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _jcfg(cfg):
    return {k: JIrreps(v) if k.startswith("irreps") else v for k, v in cfg.items()}


def _jax_batch(data, slots, npdt):
    jb = j_collate(data, slots, with_forces=True)
    return dataclasses.replace(jb, pos=np.asarray(jb.pos, npdt), y=np.asarray(jb.y, npdt),
                               forces=np.asarray(jb.forces, npdt))


def _to_torch(jb, tdt) -> GraphsTuple:
    """The port's batch of a JAX batch: floats in ``tdt``, indices int64,
    masks bool, extras likewise."""
    def cv(a):
        t = torch.from_numpy(np.array(a))
        return t.to(tdt) if t.is_floating_point() else t.long() if t.dtype == torch.int32 else t

    return GraphsTuple(pos=cv(jb.pos), species=cv(jb.species), batch=cv(jb.batch),
                       node_mask=cv(jb.node_mask), graph_mask=cv(jb.graph_mask), y=cv(jb.y),
                       forces=cv(jb.forces), extras={k: cv(v) for k, v in jb.extras.items()})


def _noised(jb, key, prob=PROB, corrupt=CORRUPT):
    return jdens.add_masked_gaussian_noise(jb, key, std=STD, prob=prob, corrupt_ratio=corrupt)


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


def _tree_of(module, shapes):
    """The flax parameter tree of the port ``module``'s seeded weights
    (float32), checked against ``shapes``, the JAX module's ``init`` traced
    by ``jax.eval_shape``: the same leaf paths and shapes.  Tracing takes
    seconds where compiling the init takes ten or more."""
    tree = {}
    for name, path in flax_paths(module).items():
        a = module.get_parameter(name).detach().numpy().astype(np.float32)
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


class _Size:
    def __init__(self, key):
        cfg, graphs, slots, seed = SIZES[key]
        self.cfg, self.slots = cfg, slots
        self.data = md17_like_dataset(graphs, num_atoms=slots, seed=seed)
        self.jm = jdens.EquiformerDeNS(**_jcfg(cfg))
        shapes = jax.eval_shape(lambda b: self.jm.init(jax.random.PRNGKey(1), b,
                                                       deterministic=True), self.batch(np.float32))
        self.tree = _tree_of(EquiformerDeNS(**cfg, seed=1), shapes)
        self._jitted, self._results = {}, {}

    def batch(self, npdt):
        return _jax_batch(self.data, self.slots, npdt)

    def model(self, tdt, **kw):
        tm = EquiformerDeNS(**self.cfg, **kw, seed=4).to(tdt)
        assert params_from_jax(tm, self.tree) == len(jax.tree_util.tree_leaves(self.tree))
        return tm

    def noised(self):
        """The fp64 batch noised by JAX's draw from PRNGKey(7)."""
        return _noised(self.batch(np.float64), jax.random.PRNGKey(7))

    def batch_of(self, mode):
        """The fp64 batch of ``mode``: "clean" (no extras), "noised" or
        "no_force_encoding" (the ablation, on the noised batch)."""
        return self.batch(np.float64) if mode == "clean" else self.noised()

    def jax_result(self, what, mode):
        """JAX's ``what`` ("forward": the model's (energy, denoise);
        "outputs": ``dens_outputs``) on the batch of ``mode``, from one
        jitted function per model, each computed once."""
        if (what, mode) not in self._results:
            encode = mode != "no_force_encoding"
            if (what, encode) not in self._jitted:
                jm = jdens.EquiformerDeNS(**_jcfg(self.cfg), use_force_encoding=encode)
                fn = ((lambda p, b: jm.apply(p, b, deterministic=True)) if what == "forward"
                      else (lambda p, b: jdens.dens_outputs(jm, p, b)))
                self._jitted[what, encode] = jax.jit(fn)
            self._results[what, mode] = jax.tree_util.tree_map(
                np.asarray, self._jitted[what, encode](self.tree, self.batch_of(mode)))
        return self._results[what, mode]


@pytest.fixture(scope="module")
def sizes():
    made = {}

    def get(key):
        if key not in made:
            made[key] = _Size(key)
        return made[key]

    return get


def _optimizers():
    return (jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD),
            pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=WD))


def _step_kwargs():
    return dict(task_mean=MEAN, task_std=2.0, energy_weight=E_WEIGHT, force_weight=F_WEIGHT,
                denoising_pos_std=STD, denoising_pos_prob=PROB, corrupt_ratio=CORRUPT,
                ema_decay=EMA)


# ---------------------------------------------------------------- pieces

@pytest.mark.parametrize("irreps", ["512x0e+256x1e+256x2e+128x3e", "4x1e+3x0e+2x0o+1x0e",
                                    "2x1o+1x2e"])
def test_filter_scalars_even_matches_jax(irreps):
    assert str(Irreps(irreps).filter_scalars_even()) == str(JIrreps(irreps).filter_scalars_even())


def test_extras_through_collation_to_and_replace():
    """collate_dense packs extra node and graph keys as JAX's does (zero on
    the padding, each key's own dtype); ``to`` moves them and recasts only
    the float ones; ``dataclasses.replace`` and a batch without extras keep
    a dict of their own."""
    data = md17_like_dataset(3, num_atoms=7, seed=5)
    rng = np.random.default_rng(5)
    for g in data:
        g["charge"] = rng.standard_normal((g["pos"].shape[0], 2)).astype(np.float32)
        g["tag"] = rng.random(g["pos"].shape[0]) < 0.5
        g["cell"] = rng.standard_normal(3).astype(np.float32)
    kw = dict(with_forces=True, extra_node_keys=("charge", "tag"), extra_graph_keys=("cell",))
    tb, jb = t_collate(data, 9, graph_capacity=4, **kw), j_collate(data, 9, graph_capacity=4, **kw)
    assert set(tb.extras) == set(jb.extras) == {"charge", "tag", "cell"}
    for k, v in jb.extras.items():
        assert np.array_equal(tb.extras[k].numpy(), np.asarray(v)), k
    moved = tb.to(dtype=torch.float64)
    assert moved.extras["charge"].dtype == torch.float64
    assert moved.extras["tag"].dtype == torch.bool and moved.extras["cell"].dtype == torch.float64
    assert torch.equal(moved.extras["tag"], tb.extras["tag"])
    again = dataclasses.replace(moved, pos=moved.pos + 1)
    assert again.extras is moved.extras
    plain = t_collate(data, 9, with_forces=True)
    assert plain.extras == {} and plain.to(dtype=torch.float64).extras == {}
    assert GraphsTuple(plain.pos, plain.species, plain.batch, plain.node_mask,
                       plain.graph_mask).extras is not plain.extras


# ------------------------------------------------------- irreps_pre_attn

def _ga_inputs(size, npdt, tdt):
    """Node features, edges, SH and scalars of one batch, in numpy (the
    JAX side) and torch (the port's)."""
    tb = _to_torch(size.batch(npdt), tdt)
    G = tb.graph_mask.shape[0]
    edges = radius_graph_dense(tb.pos, tb.node_mask, G, 5.0, size.cfg["max_edges"])
    edges = edges._replace(rev=reverse_edge_perm_dense(edges, G, size.slots))
    vec, _ = edge_vectors(tb.pos, edges)
    sh = spherical_harmonics_for_irreps(Irreps(size.cfg["irreps_sh"]), vec)
    rng = np.random.default_rng(11)
    d_in = Irreps(size.cfg["irreps_feature"]).dim
    x = rng.standard_normal((tb.pos.shape[0], d_in)).astype(npdt)
    scal = rng.standard_normal((edges.dst.shape[0], 16)).astype(npdt)
    jedges = JEdgeList(*(np.asarray(t.numpy()) for t in edges[:len(JEdgeList._fields)]))
    return x, sh.numpy(), scal, edges, jedges


GA = dict(irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4)


def test_graph_attention_with_pre_attn_matches_jax(sizes):
    """GraphAttention from the wide features through irreps_pre_attn to
    1x1e (the denoising head; the trunk's blocks are held with the model),
    fp64: the output,
    the gradients of a random projection of it with respect to every
    parameter and to the node features, the SH and the edge scalars, within
    1e-9.  None keeps the input irreps: the same bits as pre = the input."""
    size, out = sizes("l3"), "1x1e"
    x, sh, scal, edges, jedges = _ga_inputs(size, np.float64, torch.float64)
    feat, pre, irr_sh = (size.cfg[k] for k in ("irreps_feature", "irreps_pre_attn", "irreps_sh"))
    jga = JGraphAttention(irreps_node_input=JIrreps(feat), irreps_node_attr=JIrreps("1x0e"),
                          irreps_edge_attr=JIrreps(irr_sh), irreps_node_output=JIrreps(out),
                          fc_neurons=(16, 16, 16), irreps_head=JIrreps(GA["irreps_head"]),
                          num_heads=4, irreps_pre_attn=JIrreps(pre), nonlinear_message=True,
                          alpha_drop=0.0, proj_drop=0.0)
    attr = np.ones((x.shape[0], 1))
    port_ga = GraphAttention(feat, irr_sh, out, (16, 16, 16), GA["irreps_head"], 4, 0.0, 0.0,
                             irreps_pre_attn=pre)
    init_parameters(port_ga, 3)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), _tree_of(
        port_ga, jax.eval_shape(lambda x, sh, scal: jga.init(jax.random.PRNGKey(3), x, attr,
                                                             jedges, sh, scal), x, sh, scal)))
    cot = np.random.default_rng(12).standard_normal((x.shape[0], JIrreps(out).dim))

    def jout_and_grads(params, x, sh, scal):
        out, vjp = jax.vjp(lambda p, x, sh, scal: jga.apply(p, x, attr, jedges, sh, scal),
                           params, x, sh, scal)
        return out, vjp(jnp.asarray(cot))

    jout, jgrads = jax.jit(jout_and_grads)(tree, x, sh, scal)
    jout = np.asarray(jout)

    tga = GraphAttention(feat, irr_sh, out, (16, 16, 16), GA["irreps_head"], 4, 0.0, 0.0,
                         irreps_pre_attn=pre).double()
    assert params_from_jax(tga, tree) == len(jax.tree_util.tree_leaves(tree))
    assert tga.merge_src.irreps_out == Irreps(pre) and tga.merge_src.irreps_in == Irreps(feat)
    ins = [torch.tensor(a, requires_grad=True) for a in (x, sh, scal)]
    n = active_edge_bound(edges.mask)
    tout = tga(ins[0], edges, ins[1], ins[2], n)
    assert _rel(tout.detach().numpy(), jout) < FP64_TOL
    params = dict(tga.named_parameters())
    tgrads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(),
                                 list(params.values()) + ins)
    jp = _leaves(jgrads[0])
    for name, g in zip(params, tgrads):
        assert _rel(g.numpy(), jp[name]) < FP64_TOL, name
    for g, jg in zip(tgrads[len(params):], jgrads[1:]):
        assert _rel(g.numpy(), np.asarray(jg)) < FP64_TOL

    # GraphAttentionTransformer passes the option down to its blocks
    gat = GraphAttentionTransformer(irreps_node_embedding=REDUCED_L3["irreps_node_embedding"],
                                    num_layers=2, irreps_pre_attn="8x0e+4x1e+4x2e+2x3e",
                                    irreps_sh=irr_sh, nodes_per_graph=21)
    assert all(b.ga.merge_dst.irreps_out == Irreps("8x0e+4x1e+4x2e+2x3e")
               for b in (gat.block_0, gat.block_1))

    # None: the input irreps, bit for bit
    same = GraphAttention(feat, irr_sh, out, (16, 16, 16), GA["irreps_head"], 4, 0.0, 0.0,
                          irreps_pre_attn=feat).double()
    none = GraphAttention(feat, irr_sh, out, (16, 16, 16), GA["irreps_head"], 4, 0.0, 0.0).double()
    init_parameters(same, 5)
    none.load_state_dict(same.state_dict())
    with torch.no_grad():
        assert torch.equal(same(ins[0], edges, ins[1], ins[2], n),
                           none(ins[0], edges, ins[1], ins[2], n))


# ------------------------------------------------------------- the model

MODES = ("noised", "clean", "no_force_encoding")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("key", ["l2", "l3"])
def test_dens_model_matches_jax(sizes, key, mode):
    """(energy, denoising vectors) of EquiformerDeNS in fp64 within 1e-9 of
    JAX's: on a JAX-noised batch (the force encoding live), on a batch
    without extras (no force encoding), and with use_force_encoding=False on
    the noised batch (the ablation: no encoding, the denoised graphs'
    energies masked)."""
    size = sizes(key)
    jb = size.batch_of(mode)
    if mode != "clean":
        nm = np.asarray(jb.extras["noise_mask"])
        assert 0 < nm.sum() < np.asarray(jb.node_mask).sum()
    kw = {"use_force_encoding": False} if mode == "no_force_encoding" else {}
    je, jd = size.jax_result("forward", mode)
    te, td = size.model(torch.float64, **kw)(_to_torch(jb, torch.float64))
    assert te.dtype == td.dtype == torch.float64
    assert _rel(te.detach().numpy(), je) < FP64_TOL
    assert _rel(td.detach().numpy(), jd) < FP64_TOL


def test_force_encoding_is_zero_and_finite_on_clean_atoms(sizes):
    """Clean atoms carry a zero force (and padded slots a zero one): their
    encoding is exactly 0 and no NaN reaches the features, the outputs or
    any parameter or position gradient of the training loss, in fp32 and
    bf16 (the SH of a zero vector: JAX's double where)."""
    size = sizes("l3")
    jb = _noised(size.batch(np.float32), jax.random.PRNGKey(8))
    for dt in ("float32", "bfloat16"):
        tm = size.model(torch.float32, compute_dtype=dt)
        b = _to_torch(jb, torch.float32)
        enc = tm.force_encoding(b)
        nm = b.extras["noise_mask"]
        assert float(enc[~nm].abs().max()) == 0.0 and float(enc[nm].abs().max()) > 0
        assert bool(enc.isfinite().all())
        step, _ = pt.make_dens_steps(tm, _optimizers()[1], **_step_kwargs())
        st, m = step.noised(pt.TrainState.create(tm, _optimizers()[1]), b, DP_WEIGHT)
        assert all(bool(torch.isfinite(v)) for v in m.values()), (dt, m)
        assert all(bool(p.isfinite().all()) for p in tm.parameters())


def test_dens_outputs_match_jax_and_rotate(sizes):
    """dens_outputs in fp64: the energies and the mixed outputs (the
    denoising prediction on the noised atoms, -dE/dpos elsewhere) within
    1e-9 of JAX's, also with the encoding off (zero on the denoised
    graphs); rotating the positions, forces and noise leaves the energies
    and rotates the outputs (1e-9 of their largest value): the forces as
    vectors, the denoising prediction as the 1x1e irrep it is, in the SH
    component order (y, z, x), as in JAX."""
    size = sizes("l2")
    tb = _to_torch(size.noised(), torch.float64)
    tm = size.model(torch.float64)
    for mode in ("noised", "no_force_encoding"):
        je, jo = size.jax_result("outputs", mode)
        kw = {"use_force_encoding": False} if mode == "no_force_encoding" else {}
        te, to = pt.dens_outputs(size.model(torch.float64, **kw), tb)
        assert not te.requires_grad and not to.requires_grad
        assert _rel(te.numpy(), je) < FP64_TOL and _rel(to.numpy(), jo) < FP64_TOL, mode
    te, to = pt.dens_outputs(tm, tb)
    R = torch.from_numpy(random_rotation(np.random.default_rng(3)))
    rot = dataclasses.replace(tb, pos=tb.pos @ R.T, forces=tb.forces @ R.T, extras={
        **tb.extras, "force": tb.extras["force"] @ R.T, "noise_vec": tb.extras["noise_vec"] @ R.T})
    re_, ro = pt.dens_outputs(tm, rot)
    nm = tb.extras["noise_mask"]
    want = torch.where(nm[:, None], to @ torch.from_numpy(wigner_D(1, R.numpy())).T, to @ R.T)
    assert _rel(re_.numpy(), te.numpy()) < FP64_TOL
    assert _rel(ro.numpy(), want.numpy()) < FP64_TOL


# ------------------------------------------------------------ training

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
            step = jax.jit(step)
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


def test_dens_eval_step_matches_jax(sizes):
    """eval_step on a batch without noise: the MAE sums and counts of the
    energies and forces within 1e-9 of JAX's eval_step (fp64)."""
    size = sizes("l2")
    jb = size.batch(np.float64)
    opt, topt = _optimizers()
    _, jeval = jeng.make_dens_steps(size.jm, opt, **_step_kwargs())
    _, teval = pt.make_dens_steps(size.model(torch.float64), topt, **_step_kwargs())
    want = jax.jit(jeval)(size.tree, jb)
    got = teval(size.model(torch.float64), _to_torch(jb, torch.float64))
    for k in ("mae_e_sum", "count_e", "mae_f_sum", "count_f"):
        assert _rel(float(got[k]), float(want[k])) < FP64_TOL, k


@pytest.mark.parametrize("case", ["none_noised", "all_noised"])
def test_empty_masks_give_zero_terms_and_finite_gradients(sizes, case):
    """A draw that noises no atom gives loss_dp exactly 0, one that noises
    every real atom loss_f exactly 0 (the eps guard of the L2-MAE), with
    finite metrics and parameters after the step (fp64)."""
    size = sizes("l2")
    prob = 0.0 if case == "none_noised" else 1.0
    jb = _noised(size.batch(np.float64), jax.random.PRNGKey(5), prob=prob, corrupt=None)
    nm, real = np.asarray(jb.extras["noise_mask"]), np.asarray(jb.node_mask)
    assert nm.sum() == (0 if prob == 0.0 else real.sum())
    _, opt = _optimizers()
    tm = size.model(torch.float64)
    step, _ = pt.make_dens_steps(tm, opt, **_step_kwargs())
    _, m = step.noised(pt.TrainState.create(tm, opt), _to_torch(jb, torch.float64), DP_WEIGHT)
    zero = "loss_dp" if case == "none_noised" else "loss_f"
    assert float(m[zero]) == 0.0
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert all(bool(p.isfinite().all()) for p in tm.parameters())


def test_two_noised_steps_from_one_state_are_bitwise_equal(sizes):
    """The step with its noise drawn from a generator: two copies of one
    state and one seed give the same bits (fp32), and no kernel launches on
    the CPU; another seed draws other noise."""
    size = sizes("l2")
    tb = _to_torch(size.batch(np.float32), torch.float32)
    reset_launch_counts()
    runs = []
    for seed in (0, 0, 1):
        tm = size.model(torch.float32)
        _, opt = _optimizers()
        step, _ = pt.make_dens_steps(tm, opt, **_step_kwargs())
        _, m = step(pt.TrainState.create(tm, opt), tb, torch.Generator().manual_seed(seed),
                    DP_WEIGHT)
        runs.append(({k: float(v) for k, v in m.items()}, _port_leaves(dict(
            tm.named_parameters()))))
    assert runs[0][0] == runs[1][0]
    assert all(np.array_equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])
    assert runs[0][0] != runs[2][0]
    assert set(launch_counts().values()) == {0}


# -------------------------------------------------------------- noise

def test_noise_semantics_and_repeatability():
    """add_masked_gaussian_noise: with prob 1 and no corrupt ratio every
    real atom is noised and only those move; the force extra is the target
    on the noised atoms and zero elsewhere; the corrupt ratio draws a subset
    of the picked graphs' atoms; the same seed gives the same bits; the
    draws' rates and the noise's spread match the requested ones."""
    data = md17_like_dataset(64, num_atoms=21, seed=3)
    b = t_collate(data, 21, graph_capacity=66, with_forces=True).to(dtype=torch.float64)
    full = pt.add_masked_gaussian_noise(b, torch.Generator().manual_seed(0), 0.1, 1.0)
    nm = full.extras["noise_mask"]
    assert torch.equal(nm, b.node_mask) and torch.equal(full.extras["denoising_pos_mask"], nm)
    moved = (full.pos - b.pos).abs().sum(-1) > 0
    assert torch.equal(moved, nm)
    draw = lambda seed: pt.add_masked_gaussian_noise(  # noqa: E731
        b, torch.Generator().manual_seed(seed), 0.05, 0.25, 0.25)
    one, again, other = draw(7), draw(7), draw(8)
    for k in ("force", "noise_mask", "denoising_pos_mask", "noise_vec"):
        assert torch.equal(one.extras[k], again.extras[k]), k
    assert torch.equal(one.pos, again.pos) and not torch.equal(one.pos, other.pos)
    nm, dpm = one.extras["noise_mask"], one.extras["denoising_pos_mask"]
    assert bool((nm <= dpm).all()) and bool((dpm <= b.node_mask).all())
    f = one.extras["force"]
    assert float(f[~nm].abs().max()) == 0.0 and torch.equal(f[nm], b.forces[nm])
    picked = dpm.reshape(66, 21).any(1)
    assert not bool(picked[64:].any())  # padded graph slots have no atom to pick
    assert abs(float(picked[:64].double().mean()) - 0.25) < 0.15
    assert abs(float(nm.sum()) / max(float(dpm.sum()), 1.0) - 0.25) < 0.1
    assert abs(float(one.extras["noise_vec"].std()) - 0.05) < 0.005
    assert torch.equal(one.pos[~nm], b.pos[~nm])


# ------------------------------------------------------- entry points

def test_entrypoint_defaults_and_parameter_leaves(sizes):
    """equiformer_md17_dens takes JAX's defaults, and builds with them (the
    packed layout), on the CPU only when asked; params_from_jax maps
    every leaf of the flax tree, the same count on both sides;
    make_dens_steps has JAX's defaults, without pmean_axis."""
    jsig = inspect.signature(jdens.EquiformerDeNS).parameters
    tsig = inspect.signature(EquiformerDeNS).parameters
    for k, p in tsig.items():
        if k != "seed":
            want = jsig[k].default
            assert str(p.default) == str(want) if k.startswith("irreps") else p.default == want, k
    assert EquiformerDeNS().nodes_per_graph == 0
    jsteps = inspect.signature(jeng.make_dens_steps).parameters
    tsteps = inspect.signature(pt.make_dens_steps).parameters
    assert set(jsteps) - set(tsteps) == {"pmean_axis"}
    for k in tsteps:
        if k not in ("model", "optimizer"):
            assert tsteps[k].default == jsteps[k].default, k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pt.model_entrypoint("equiformer_md17_dens")(nodes_per_graph=9)
    for key in ("l2", "l3"):
        size = sizes(key)
        tm = pt.model_entrypoint("equiformer_md17_dens")(**size.cfg, device="cpu")
        n_leaves = len(jax.tree_util.tree_leaves(size.tree))
        assert params_from_jax(tm, size.tree) == n_leaves == len(list(tm.parameters()))
        assert {n.split(".")[0] for n, _ in tm.named_parameters()} == {
            "atom_embed", "edge_deg_embed", "force_embed", "norm", "energy_lin1",
            "energy_lin2", "denoising_pos_head", *(f"block_{i}" for i in range(2))}


def test_chip_smoke_dens_configuration_is_the_recipe():
    """The aspirin L3 recipe that chip_smoke.py's DeNS phases and
    tools/profile_eval.py --dens build (models.dens.ASPIRIN_L3 and
    ASPIRIN_L3_TRAIN) is configs/md17_dens/equiformer_dens_l3.yml (read by
    the JAX package's load_config), with bench.py --task dens' training
    settings; every_pair_edges holds every ordered pair of a batch's atoms,
    3456 at chip_smoke.py's batch (bench.py's --loose-edges rule)."""
    from equiformer_tpu_torch.models.dens import ASPIRIN_L3, ASPIRIN_L3_TRAIN, every_pair_edges

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ycfg = load_config(str(ROOT / "configs/md17_dens/equiformer_dens_l3.yml"))["model"]
    norm = lambda cfg: {k: (str(Irreps(v)) if k.startswith("irreps") else  # noqa: E731
                            tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()}
    assert norm(ASPIRIN_L3) == norm(ycfg)
    train = dict(energy_weight=1.0, force_weight=80.0, denoising_pos_std=0.05,
                 denoising_pos_prob=0.25, corrupt_ratio=0.25, ema_decay=0.999)
    assert ASPIRIN_L3_TRAIN == dict(steps=train, schedule=(2e-4, 100, 100000),
                                    weight_decay=1e-6, dp_weight=5.0)
    assert (cs.MD17_BATCH, cs.MD17_SLOTS) == (8, 21)
    assert every_pair_edges(cs.MD17_BATCH, cs.MD17_SLOTS) == 3456
    assert every_pair_edges(2, 21) == 896 and every_pair_edges(1, 9) == 128


@pytest.mark.slow
def test_full_width_aspirin_l3_dens_step_matches_jax():
    """One fp64 step of the aspirin L3 recipe's model at full width (its
    depth cut to 2 blocks: the first and the last, out to the 3456-dim
    irreps_feature) on 2 molecules, fed JAX's noise, against JAX, and
    params_from_jax's leaf count at full width: every leaf of both trees
    (the other blocks repeat the first one's leaves)."""
    from equiformer_tpu_torch.models.dens import ASPIRIN_L3, ASPIRIN_L3_TRAIN, every_pair_edges

    cfg = dict(ASPIRIN_L3, num_layers=2, max_edges=every_pair_edges(2, 21), nodes_per_graph=21)
    data = md17_like_dataset(2, num_atoms=21, seed=2)
    jm = jdens.EquiformerDeNS(**_jcfg(cfg))
    tm = pt.model_entrypoint("equiformer_md17_dens")(**cfg, device="cpu", seed=1)
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(1), b, deterministic=True),
                            _jax_batch(data, 21, np.float32))
    tree = _tree_of(tm, shapes)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    kw = dict(ASPIRIN_L3_TRAIN["steps"], denoising_pos_prob=1.0)
    schedule, wd = ASPIRIN_L3_TRAIN["schedule"], ASPIRIN_L3_TRAIN["weight_decay"]
    jo = jopt.create_optimizer(jopt.cosine_warmup_schedule(*schedule), weight_decay=wd)
    to = pt.create_optimizer(pt.cosine_warmup_schedule(*schedule), weight_decay=wd)
    jstep, _ = jeng.make_dens_steps(jm, jo, **kw)
    jb = _jax_batch(data, 21, np.float64)
    rng = jax.random.PRNGKey(4)
    noised = jdens.add_masked_gaussian_noise(jb, jax.random.split(rng)[0], std=kw[
        "denoising_pos_std"], prob=1.0, corrupt_ratio=kw["corrupt_ratio"])
    dp = ASPIRIN_L3_TRAIN["dp_weight"]
    jst, jmet = jax.jit(jstep)(jstate.TrainState.create(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree), jo), jb, rng,
        np.float64(dp))
    tm = tm.double()
    assert params_from_jax(tm, tree) == n_leaves == len(list(tm.parameters()))
    tstep, _ = pt.make_dens_steps(tm, to, **kw)
    tst, tmet = tstep.noised(pt.TrainState.create(tm, to), _to_torch(noised, torch.float64), dp)
    for k in METRICS:
        assert _rel(float(tmet[k]), float(jmet[k])) < FP64_TOL, k
    assert float(tmet["loss_dp"]) > 0 and float(tmet["loss_f"]) > 0
    jp = _leaves(jst.params)
    scale = max(np.abs(v).max() for v in jp.values())
    tp = _port_leaves(tst.params)
    assert max(np.abs(tp[n] - jp[n]).max() for n in tp) < FP64_TOL * scale
