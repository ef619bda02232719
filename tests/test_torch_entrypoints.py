"""The port's QM9 entrypoints (e3, bessel) and the MD17 attention head
against the JAX package.

* Configuration: each new entrypoint's arguments equal the fields of JAX's
  module of the same name, compared without an init (the port's model
  class is replaced by a recorder); a field the port does not take must
  hold the one value the port implements.
* Forward: a reduced QM9 model in fp64 (1 block, a packed batch of 4
  molecules) with odd-parity irreps (the e3 entrypoint's pattern) on the
  bessel basis, on JAX's own ``init`` weights carried across by
  ``params_from_jax``: predictions within 1e-9 of the largest.
* Attention head: a reduced force model (1 block, SH to l=2, 4 molecules
  of 9 atoms) with ``use_attn_head`` in fp64:
  energies, forces and the parameter gradient of an energy + force loss
  within 1e-9 of the largest (per leaf, relative to the leaf's largest).
  The ``attn_head`` subtree goes through ``params_from_jax`` and back
  through ``params_to_jax`` with the same values.
JAX functions are compiled without XLA's backend passes (``fast_jit``).
"""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.graph.batching import collate as j_collate  # noqa: E402
from equiformer_tpu.models import md17_models as j_md17_models  # noqa: E402
from equiformer_tpu.models import qm9_models as j_qm9_models  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.models.md17_models import energy_and_forces as j_energy_and_forces  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.data import md17_like_dataset, qm9_like_dataset  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate as t_collate  # noqa: E402
from equiformer_tpu_torch.models import md17_models, qm9_models  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax, params_to_jax  # noqa: E402
from test_torch_jax_ref import fast_jit  # noqa: E402

TOL = 1e-9
GRAPHS = 4
NEW_QM9 = ["graph_attention_transformer_nonlinear_l2",
           "graph_attention_transformer_nonlinear_l2_e3",
           "graph_attention_transformer_nonlinear_bessel_l2",
           "graph_attention_transformer_nonlinear_bessel_l2_drop01",
           "graph_attention_transformer_nonlinear_bessel_l2_drop00"]
# the options the port implements in one way only
PORT_FIXED = dict(irreps_node_attr="1x0e", rescale_degree=False, nonlinear_message=True,
                  norm_layer="layer", attn_type="mlp")
# the e3 entrypoint's irreps pattern (odd parity, odd SH at l=1) on the
# bessel basis: one reduced model covers both new QM9 variants
QM9_E3_BESSEL = dict(
    irreps_node_embedding="8x0e+4x0o+4x1e+4x1o+2x2e+2x2o", num_layers=1,
    irreps_sh="1x0e+1x1o+1x2e", number_of_basis=16, basis_type="bessel", fc_neurons=(8, 8),
    irreps_feature="16x0e", irreps_head="4x0e+2x0o+2x1e+2x1o+1x2e+1x2o", num_heads=2,
    irreps_mlp_mid="12x0e+6x0o+6x1e+6x1o+3x2e+3x2o", alpha_drop=0.2, max_atom_type=5,
    max_edges=1280,
)
ATTN = dict(
    irreps_node_embedding="8x0e+4x1e+2x2e", num_layers=1, irreps_sh="1x0e+1x1e+1x2e",
    number_of_basis=16, basis_type="exp", fc_neurons=(8, 8), irreps_feature="16x0e",
    irreps_head="4x0e+2x1e+1x2e", num_heads=2, irreps_mlp_mid="12x0e+6x1e+3x2e",
    alpha_drop=0.0, max_atom_type=64, avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
    avg_degree=md17_models._AVG_DEGREE_MD17, max_edges=768, use_attn_head=True,
)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_batch(data, nodes, npdt=np.float64):
    b = j_collate(data, nodes, with_forces="forces" in data[0])
    kw = dict(pos=np.asarray(b.pos, npdt), y=np.asarray(b.y, npdt))
    if b.forces is not None:
        kw["forces"] = np.asarray(b.forces, npdt)
    return dataclasses.replace(b, **kw)


def _pair(cfg, data, nodes, **jextra):
    """(JAX module, its init tree, the port model on those weights)."""
    jcfg = {k: JIrreps(v) if k.startswith("irreps") else v for k, v in cfg.items()}
    jm = JModel(**jcfg, nonlinear_message=True, **jextra)
    tree = fast_jit(lambda b: jm.init(jax.random.PRNGKey(1), b, deterministic=True))(
        _jax_batch(data, nodes, np.float32))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tm = TModel(**cfg, higher_order_grads=jextra.get("higher_order_grads", True), seed=3)
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    return jm, tree, tm.to(torch.float64).eval()


# ------------------------------------------------------------ configuration

class _Recorder:
    def __init__(self, **kw):
        self.kw = kw

    def to(self, device):
        return self


def _port_config(module, monkeypatch, name):
    monkeypatch.setattr(module, "GraphAttentionTransformer", _Recorder)
    kw = pt.model_entrypoint(name)(device="cpu").kw
    defaults = {k: p.default for k, p in inspect.signature(TModel).parameters.items()}
    return kw, defaults


def _norm(v):
    if isinstance(v, (JIrreps, pt.core.irreps.Irreps)):
        return str(v)
    if isinstance(v, str) and "x" in v and v[0].isdigit():
        return str(JIrreps(v))
    return tuple(v) if isinstance(v, list) else v


@pytest.mark.parametrize("name", NEW_QM9 + ["graph_attention_transformer_nonlinear_attn_exp_l3_md17"])
def test_entrypoint_config_equals_jax(name, monkeypatch):
    jax_module = (j_md17_models if name.endswith("_md17") else j_qm9_models)
    port_module = md17_models if name.endswith("_md17") else qm9_models
    jm = getattr(jax_module, name)()
    kw, defaults = _port_config(port_module, monkeypatch, name)
    for f in dataclasses.fields(jm):
        if f.name in ("parent", "name"):
            continue
        want = _norm(getattr(jm, f.name))
        if f.name in defaults:
            got = _norm(kw.get(f.name, defaults[f.name]))
        else:
            assert f.name in PORT_FIXED, f"{name}: JAX field {f.name} has no port counterpart"
            got = _norm(PORT_FIXED[f.name])
        assert got == want, (name, f.name, got, want)
    assert set(kw) <= set(defaults)


# ------------------------------------------------------------ forwards

def test_reduced_qm9_e3_bessel_forward_matches_jax_fp64():
    data = qm9_like_dataset(GRAPHS, seed=3)
    nodes = 128
    jm, tree, tm = _pair(QM9_E3_BESSEL, data, nodes, higher_order_grads=False)
    jb = _jax_batch(data, nodes)
    ref = np.asarray(fast_jit(lambda p, b: jm.apply(p, b, deterministic=True))(_f64(tree), jb))
    tb = t_collate(data, nodes).to(dtype=torch.float64)
    got = tm(tb).detach().numpy()
    assert got.shape == (GRAPHS,) and np.all(np.isfinite(got))
    assert _rel(got, ref) < TOL
    # odd parity really is present at the sep_act site
    assert "0o" in str(tm.block_0.ga.sep_act.dtp.irreps_out)


def test_attention_head_forces_and_gradient_match_jax_fp64():
    data = md17_like_dataset(GRAPHS, num_atoms=9, seed=5)
    nodes = 128
    jm, tree, tm = _pair(ATTN, data, nodes, higher_order_grads=True)
    assert "attn_head" in tree["params"] and not hasattr(tm, "head_lin1")
    back = params_to_jax(tm)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree["params"]["attn_head"]):
        node = back["attn_head"]
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, leaf)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(GRAPHS,))
    b = rng.normal(size=(nodes, 3))

    def loss(p, batch):
        e, f = j_energy_and_forces(jm, p, batch)
        return 0.2 * jnp.sum(e * a) + 0.8 * jnp.sum(f * b), (e, f)

    jb = _jax_batch(data, nodes)
    fn = jax.value_and_grad(loss, has_aux=True)
    (_, (je, jf)), jg = fast_jit(fn)(_f64(tree), jb)

    tb = t_collate(data, nodes, with_forces=True).to(dtype=torch.float64)
    te, tf = pt.energy_and_forces(tm, tb, create_graph=True)
    tl = 0.2 * torch.sum(te * torch.from_numpy(a)) + 0.8 * torch.sum(tf * torch.from_numpy(b))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(tl, [p for _, p in tm.named_parameters()])
    assert _rel(te.detach().numpy(), je) < TOL
    assert _rel(tf.detach().numpy(), jf) < TOL
    tg = params_to_jax(tm, dict(zip(names, grads)))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg["params"]))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tg))
    assert len(flat_t) == len(flat_j)
    head = 0
    for path, jleaf in flat_j.items():
        tkey = tuple(jax.tree_util.DictKey(k.key) for k in path)
        tleaf = next(v for p, v in flat_t.items() if tuple(x.key for x in p)
                     == tuple(x.key for x in tkey))
        assert _rel(tleaf, jleaf) < TOL, path
        head += path[0].key == "attn_head"
    assert head > 0
