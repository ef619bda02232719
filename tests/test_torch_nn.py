"""The port's nn modules against the JAX package's flax modules.

Each case builds the flax module and its port counterpart, takes the flax
module's own ``init`` tree, adds seeded numpy noise to every leaf (so
zero-init biases are exercised), loads that tree into the port module with
``params_from_jax``, then compares outputs on the same numpy inputs.  Tolerances: fp64 1e-12 relative, fp32 1e-5 relative
(float32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import equiformer_tpu.nn as jnn  # noqa: E402
from equiformer_tpu.core import Irreps as JIrreps  # noqa: E402
from equiformer_tpu.nn import attention_utils as jattn  # noqa: E402
import equiformer_tpu_torch.nn as tnn  # noqa: E402
from equiformer_tpu_torch.core import Irreps  # noqa: E402
from equiformer_tpu_torch.nn import attention_utils as tattn  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax  # noqa: E402

DTYPES = {"fp64": (np.float64, torch.float64, 1e-12), "fp32": (np.float32, torch.float32, 1e-5)}
IRR = "8x0e+4x1e+2x2e"
SH = "1x0e+1x1e+1x2e"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _pair(jmod, tmod, jargs, npdt, tdt, seed=0):
    """Share one set of weights: flax init + noise -> tree -> port."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float64) + 0.1 * rng.normal(size=a.shape)).astype(npdt),
        jmod.init(jax.random.PRNGKey(seed), *jargs))
    tmod = tmod.to(tdt)
    assert params_from_jax(tmod, tree) == len(jax.tree_util.tree_leaves(tree))
    return tree, tmod


def _np(rng, shape, npdt, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(npdt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("io", [(IRR, "6x0e+3x1e+2x2e"), ("4x1e+3x0e", "4x0e+4x1e+1x2e"),
                                ("5x0e", IRR)], ids=["mix", "unmatched", "embed"])
def test_irreps_linear_matches(io, dt):
    npdt, tdt, tol = DTYPES[dt]
    x = _np(np.random.default_rng(0), (7, Irreps(io[0]).dim), npdt)
    jm = jnn.IrrepsLinear(JIrreps(io[0]), JIrreps(io[1]))
    tree, tm = _pair(jm, tnn.IrrepsLinear(io[0], io[1]), (jnp.asarray(x),), npdt, tdt)
    j = np.asarray(jm.apply(tree, jnp.asarray(x)))
    assert _rel(tm(torch.from_numpy(x)).detach().numpy(), j) < tol


def test_normalize2mom_constants_equal():
    from equiformer_tpu.nn import activation as ja
    from equiformer_tpu_torch.nn import activation as ta

    for name in ("silu", "sigmoid", "smooth_leaky_relu:0.2"):
        assert ja._moment_and_parity(name) == ta._moment_and_parity(name)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("irreps", ["224x0e+64x1e+32x2e", "12x0e+3x1o+2x0o", "6x0e"])
def test_gate_and_activation_match(irreps, dt):
    npdt, _, tol = DTYPES[dt]
    jg, jin = jnn.gate_for(JIrreps(irreps))
    tg, tin = tnn.gate_for(Irreps(irreps))
    assert str(jin) == str(tin)
    x = _np(np.random.default_rng(1), (5, tin.dim), npdt, 2.0)
    assert _rel(tg(torch.from_numpy(x)).numpy(), np.asarray(jg(jnp.asarray(x)))) < tol
    f_j = jnn.normalized_activation("smooth_leaky_relu:0.2")
    f_t = tnn.normalized_activation("smooth_leaky_relu:0.2")
    assert _rel(f_t(torch.from_numpy(x)).numpy(), np.asarray(f_j(jnp.asarray(x)))) < tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_equivariant_layer_norm_matches(dt):
    npdt, tdt, tol = DTYPES[dt]
    x = _np(np.random.default_rng(2), (6, Irreps(IRR).dim), npdt, 3.0)
    jm = jnn.EquivariantLayerNorm(JIrreps(IRR))
    tree, tm = _pair(jm, tnn.EquivariantLayerNorm(IRR), (jnp.asarray(x),), npdt, tdt)
    j = np.asarray(jm.apply(tree, jnp.asarray(x)))
    assert _rel(tm(torch.from_numpy(x)).detach().numpy(), j) < tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_radial_basis_and_profile_match(dt):
    npdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(3)
    d = rng.uniform(0.0, 5.0, size=(9,)).astype(npdt)
    jr = jnn.GaussianRadialBasis(num_basis=16, cutoff=5.0)
    tree, tr = _pair(jr, tnn.GaussianRadialBasis(16, 5.0), (jnp.asarray(d),), npdt, tdt)
    j = np.asarray(jr.apply(tree, jnp.asarray(d)))
    assert _rel(tr(torch.from_numpy(d)).detach().numpy(), j) < tol

    h = _np(rng, (9, 16), npdt)
    jp = jnn.RadialProfile(features=(8, 8, 30))
    tree, tp = _pair(jp, tnn.RadialProfile(16, (8, 8, 30)), (jnp.asarray(h),), npdt, tdt)
    j = np.asarray(jp.apply(tree, jnp.asarray(h)))
    assert _rel(tp(torch.from_numpy(h)).detach().numpy(), j) < tol


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("gate", [False, True], ids=["fctp", "swish-gate"])
def test_fctp_matches(gate, dt):
    npdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(4)
    x = _np(rng, (6, Irreps(IRR).dim), npdt)
    attr = np.ones((6, 1), npdt)
    out = "6x0e+3x1e+2x2e"
    if gate:
        jm = jnn.FCTPSwishGate(JIrreps(IRR), JIrreps("1x0e"), JIrreps(out))
        tm = tnn.FCTPSwishGate(IRR, "1x0e", out)
    else:
        jm = jnn.FCTP(JIrreps(IRR), JIrreps("1x0e"), JIrreps(out))
        tm = tnn.FCTP(IRR, "1x0e", out)
    args = (jnp.asarray(x), jnp.asarray(attr))
    tree, tm = _pair(jm, tm, args, npdt, tdt)
    j = np.asarray(jm.apply(tree, *args))
    assert _rel(tm(torch.from_numpy(x), torch.from_numpy(attr)).detach().numpy(), j) < tol


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("internal", [False, True], ids=["radial-weights", "shared-weights"])
def test_separable_fctp_matches(internal, dt):
    npdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(5)
    E = 12
    x = _np(rng, (E, Irreps(IRR).dim), npdt)
    sh = _np(rng, (E, 9), npdt)
    rbf = _np(rng, (E, 16), npdt)
    if internal:
        kw = dict(fc_neurons=None, use_activation=False, internal_weights=True)
        out = "16x0e+8x1e+4x2e"
        jargs = (jnp.asarray(x), jnp.asarray(sh))
    else:
        kw = dict(fc_neurons=(16, 8), use_activation=True, internal_weights=False)
        out = IRR
        jargs = (jnp.asarray(x), jnp.asarray(sh), jnp.asarray(rbf))
    jm = jnn.SeparableFCTP(JIrreps(IRR), JIrreps(SH), JIrreps(out), **kw)
    tree, tm = _pair(jm, tnn.SeparableFCTP(IRR, SH, out, **kw), jargs, npdt, tdt)
    j = np.asarray(jax.jit(jm.apply)(tree, *jargs))
    t = tm(torch.from_numpy(x), torch.from_numpy(sh),
           None if internal else torch.from_numpy(rbf)).detach().numpy()
    assert _rel(t, j) < tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_node_and_edge_degree_embedding_match(dt):
    npdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(6)
    N, E = 10, 24
    species = rng.integers(0, 5, size=N)
    jn = jnn.NodeEmbedding(JIrreps(IRR), 5)
    tree, tn = _pair(jn, tnn.NodeEmbedding(IRR, 5), (jnp.asarray(species), jnp.float64),
                     npdt, tdt)
    j_emb, _ = jn.apply(tree, jnp.asarray(species), dtype=npdt)
    t_emb, _ = tn(torch.from_numpy(species), tdt)
    assert _rel(t_emb.detach().numpy(), j_emb) < tol

    sh = _np(rng, (E, 9), npdt)
    rbf = _np(rng, (E, 16), npdt)
    dst = np.sort(rng.integers(0, N, size=E))
    src = rng.integers(0, N, size=E)
    mask = np.arange(E) < 20
    je = jnn.EdgeDegreeEmbedding(JIrreps(IRR), JIrreps(SH), (16, 8), 3.0,
                                 higher_order_grads=False)
    jargs = (jnp.asarray(sh), jnp.asarray(rbf), jnp.asarray(src), jnp.asarray(dst),
             jnp.asarray(mask), N)
    tree, te = _pair(je, tnn.EdgeDegreeEmbedding(IRR, SH, (16, 8), 3.0), jargs, npdt, tdt)
    j = np.asarray(jax.jit(lambda t, *a: je.apply(t, *a, N))(tree, *jargs[:-1]))
    t = te(torch.from_numpy(sh), torch.from_numpy(rbf), torch.from_numpy(dst),
           torch.from_numpy(mask), N).detach().numpy()
    assert _rel(t, j) < tol


@pytest.mark.parametrize("head", ["32x0e+16x1e+8x2e", "4x0e+2x1o"])
def test_heads_reshapes_match(head):
    H = 4
    assert str(jattn.heads_irreps(JIrreps(head), H)) == str(tattn.heads_irreps(Irreps(head), H))
    irr = tattn.heads_irreps(Irreps(head), H)
    x = np.random.default_rng(7).normal(size=(5, irr.dim))
    j = np.asarray(jattn.vec2heads(JIrreps(head), H, jnp.asarray(x)))
    t = tattn.vec2heads(Irreps(head), H, torch.from_numpy(x))
    assert np.array_equal(t.numpy(), j)
    assert np.array_equal(tattn.heads2vec(Irreps(head), t).numpy(), x)


# ---------------------------------------------------------------- dropout
# jax.random and torch draw different bits, so each JAX dropout module runs
# with its own rng, its keep mask is read off its output (the input has no
# zeros), and the port module replays that mask: the outputs must then be
# equal to float32 rounding (1e-6 relative).

def _irrep_copies(irreps, y):
    """[N, num_irreps] value of each irrep copy's first component."""
    return np.concatenate([b[:, 0, :] for b in
                           (y[:, s].reshape(len(y), ir.dim, mul)
                            for s, (mul, ir) in zip(irreps.slices(), irreps))], axis=1)


@pytest.mark.parametrize("kind", ["equivariant", "scalars", "drop-path"])
def test_dropout_with_the_jax_mask_matches(kind):
    from equiformer_tpu.nn import dropout as jd
    from equiformer_tpu_torch.nn import dropout as td

    irr, p, N, G = "6x0e+3x1e+2x2e+2x0e", 0.3, 12, 6
    x = (np.random.default_rng(8).uniform(0.5, 1.5, size=(N, Irreps(irr).dim))
         * np.sign(np.random.default_rng(9).normal(size=(N, Irreps(irr).dim)))).astype(np.float32)
    batch = np.repeat(np.arange(G), N // G)
    key = {"dropout": jax.random.PRNGKey(3)}
    if kind == "equivariant":
        y = np.asarray(jd.EquivariantDropout(JIrreps(irr), p).apply(
            {}, jnp.asarray(x), deterministic=False, rngs=key))
        masks = [torch.from_numpy(_irrep_copies(Irreps(irr), y) != 0)]
        mod, args = td.EquivariantDropout(irr, p), ()
    elif kind == "scalars":
        y = np.asarray(jd.EquivariantScalarsDropout(JIrreps(irr), p).apply(
            {}, jnp.asarray(x), deterministic=False, rngs=key))
        masks = [torch.from_numpy(y[:, s] != 0) for s, (_, ir) in
                 zip(Irreps(irr).slices(), Irreps(irr)) if ir.is_scalar()]
        mod, args = td.EquivariantScalarsDropout(irr, p), ()
    else:
        y = np.asarray(jd.GraphDropPath(p).apply(
            {}, jnp.asarray(x), jnp.asarray(batch), G, deterministic=False, rngs=key))
        masks = [torch.from_numpy(np.array([y[batch == g].any() for g in range(G)]))]
        mod, args = td.GraphDropPath(p), (torch.from_numpy(batch), G)
    assert 0 < sum(int((~m).sum()) for m in masks)  # something was dropped
    t = mod.train()(torch.from_numpy(x), *args, rng=iter(masks)).numpy()
    assert _rel(t, y) < 1e-6
    assert np.array_equal(mod.eval()(torch.from_numpy(x), *args).numpy(), x)


def test_drawn_dropout_masks_keep_rate_and_scale():
    from equiformer_tpu_torch.nn.dropout import dropout_multiplier

    p, n = 0.2, 200_000
    m = dropout_multiplier(torch.Generator().manual_seed(0), (n,), p, torch.float32, "cpu")
    assert torch.unique(m).tolist() == pytest.approx([0.0, 1 / 0.8])
    kept = float((m > 0).float().mean())
    assert abs(kept - 0.8) < 4 * (0.8 * 0.2 / n) ** 0.5  # binomial 4 sigma
    assert abs(float(m.mean()) - 1.0) < 5e-3  # mask / keep has mean 1
    again = dropout_multiplier(torch.Generator().manual_seed(0), (n,), p, torch.float32, "cpu")
    assert torch.equal(m, again)


@pytest.mark.parametrize("H, D", [(4, 40), (2, 12)], ids=["fused", "composed"])
def test_softmax_dropout_combine_applies_the_alpha_dropout(H, D):
    """Training mode multiplies the softmax weights by keep mask / keep (an
    injected mask here) on both routes; eval mode and rate 0 do not."""
    rng = np.random.default_rng(10)
    E, N = 60, 9
    dst = torch.from_numpy(np.sort(rng.integers(0, N, size=E)))
    mask = torch.from_numpy(rng.random(E) < 0.9)
    alpha = torch.from_numpy(rng.normal(size=(E, H)))
    value = torch.from_numpy(rng.normal(size=(E, H, D)))
    keep = torch.from_numpy(rng.random((E, H)) < 0.8)
    got = tattn.softmax_dropout_combine(alpha, value, dst, mask, N, 0.2, True, iter([keep]))
    p = tnn.attention_utils.attn_combine_plain(alpha, value, dst, N, mask, keep / 0.8)
    assert _rel(got.numpy(), p.numpy()) < 1e-12
    plain = tattn.softmax_dropout_combine(alpha, value, dst, mask, N)
    assert torch.equal(tattn.softmax_dropout_combine(alpha, value, dst, mask, N, 0.2, False),
                       plain)
    assert _rel(got.numpy(), plain.numpy()) > 1e-3
