"""The radial fold (K7) of the port's fused DTP + linear op against the JAX package.

With the fold, the radial MLP's final linear layer runs inside the fused op:
its per-edge operand is the MLP's last hidden activation ``h`` and the
kernels build ``w = h @ Wr + offset`` on chip (``radial_fold`` /
``radial_fold_ho``, JAX's ``EQUIFORMER_TPU_FOLD_RADIAL`` /
``EQUIFORMER_TPU_FOLD_RADIAL_HO``).  On the CPU the JAX package never folds
(``_pallas_enabled()`` is TPU-only); its own tests hold the folded Pallas
kernel to the XLA composition ``w = h @ Wr + offset; TP.apply(...,
scale_weights=True); heads`` (``tests/test_dtp_lin_rad.py``), which is the
target here, in fp64 within 1e-9 relative.  The CUDA kernels cannot run
here; their tables can, and walking them the way the kernels do gives the
plain versions (fp64 operands, the tables' fp32 CG coefficients: 1e-6).
The kernels themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import equiformer_tpu.nn as jnn  # noqa: E402
from equiformer_tpu.core import Irreps as JIrreps, depthwise_tp as j_dtp  # noqa: E402
import equiformer_tpu_torch.nn as tnn  # noqa: E402
from equiformer_tpu_torch.core import Irreps, depthwise_tp  # noqa: E402
from equiformer_tpu_torch.kernels import (  # noqa: E402
    DTPLinPlan,
    _build,
    dtp_lin,
    dtp_lin_ho,
    dtp_lin_rad_bwd3_plain,
    dtp_lin_rad_bwd_plain,
    dtp_lin_rad_plain,
)
from equiformer_tpu_torch.kernels.dtp_lin import radial_dWrs_plain  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax, torch_name  # noqa: E402
from equiformer_tpu_torch.kernels.dtp_lin import (  # noqa: E402
    K1_TWO_BLOCKS_SMEM,
    fold_gather,
    k2_packed_W,
    k1_smem_bytes,
    k1_tile,
    k1_x_global,
)
from tests.test_torch_kernels import (  # noqa: E402
    _emulate_k1,
    _emulate_k2_launch1,
    _group_rows,
    _k2_dsh_slots,
    _k7_dWrs,
    _k7_packs,
    _k7_wr_partials,
    _sum_rows,
    _unpack_k2,
    _emulate_k7b,
    _emulate_k7lw,
    _emulate_k7wr,
)

# the module (the package's name dtp_lin_ho is the function)
kho = importlib.import_module("equiformer_tpu_torch.kernels.dtp_lin_ho")

IRR = "8x0e+4x1e+2x2e"
SH = "1x0e+1x1e+1x2e"
LIN_OUT = "14x0e+4x1e+2x2e"
ALPHA_OUT = "6x0e"
HD = 16  # the radial hidden width of the JAX package's own fold tests
E, N_REAL = 70, 53
# heads -> one head, two heads (sep_act), a plan with w columns no head reads
HEADS = {"one-head": [LIN_OUT], "two-head": [LIN_OUT, ALPHA_OUT],
         "dead-w-cols": ["5x0e+3x1e"]}
TOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _case(heads, seed=0):
    """fp64 numpy operands of one plan: x, sh, h, Wr, offset, head weights."""
    rng = np.random.default_rng(seed)
    tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    head_ws = []
    for hirr in heads:
        ws = []
        for mul_out, ir_out in Irreps(hirr):
            fan = sum(m for m, ir in tp.irreps_out if ir == ir_out)
            ws.append(rng.normal(size=(fan, mul_out)) if fan else None)
        head_ws.append(ws)
    return dict(x=rng.normal(size=(E, tp.irreps_in1.dim)), sh=rng.normal(size=(E, 9)),
                h=rng.normal(size=(E, HD)), Wr=0.3 * rng.normal(size=(HD, tp.weight_numel)),
                off=0.1 * rng.normal(size=(tp.weight_numel,)), head_ws=head_ws)


def _plan(heads):
    return DTPLinPlan(depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR)), heads, radial_fold=HD)


def _jax_composed(heads, n_real):
    """The JAX composition w = h @ Wr + offset; TP; heads, rows at or past
    ``n_real`` zeroed, as a function of jnp operands."""
    tp = j_dtp(JIrreps(IRR), JIrreps(SH), JIrreps(IRR))
    slices = tp.irreps_out.slices()
    rows = (jnp.arange(E) < n_real)[:, None]

    def f(x, sh, h, Wr, off, head_ws):
        z = tp.apply(x, sh, h @ Wr + off, scale_weights=True)
        outs = []
        for hirr, ws in zip(heads, head_ws):
            pieces = []
            for oi, (mul_out, ir_out) in enumerate(JIrreps(hirr)):
                blocks = [z[:, slices[i]].reshape(E, ir.dim, m)
                          for i, (m, ir) in enumerate(tp.irreps_out) if ir == ir_out]
                if ws[oi] is None:
                    pieces.append(jnp.zeros((E, ir_out.dim * mul_out)))
                    continue
                o = jnp.einsum("eiu,uw->eiw", jnp.concatenate(blocks, axis=-1), ws[oi])
                pieces.append(o.reshape(E, -1))
            outs.append(jnp.where(rows, jnp.concatenate(pieces, axis=-1), 0.0))
        return outs

    return f


def _port_out(op, plan, c, leaves, n_real):
    """The port's folded op on torch leaves {x, sh, h, Wr, off, head_ws};
    returns the per-head outputs."""
    W = plan.pack_weights(leaves["head_ws"])
    Wrs = plan.pack_radial(leaves["Wr"], leaves["off"])
    out = op(plan, leaves["x"], leaves["sh"], (leaves["h"], Wrs), W,
             torch.tensor(n_real, dtype=torch.int32))
    return plan.split_output(out)


def _leaves(c, grad=()):
    out = {k: _t(c[k]).requires_grad_(k in grad) for k in ("x", "sh", "h", "Wr", "off")}
    out["head_ws"] = [[None if a is None else _t(a).requires_grad_("head_ws" in grad)
                       for a in ws] for ws in c["head_ws"]]
    return out


# ----------------------------------------------------------------- modules
def _pair(jmod, tmod, jargs, seed=0):
    """flax init + seeded noise -> one tree, loaded into the port module (fp64)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64)
                                  + 0.1 * rng.normal(size=a.shape),
                                  jmod.init(jax.random.PRNGKey(seed), *jargs))
    tmod = tmod.double()
    assert params_from_jax(tmod, tree) == len(jax.tree_util.tree_leaves(tree))
    return tree, tmod


def _flip(name, a):
    """flax Dense kernels are [in, out], torch Linear weights [out, in]."""
    return a.T if name.endswith(".weight") and np.ndim(a) == 2 else a


def _grad_leaves(gtree):
    flat = jax.tree_util.tree_flatten_with_path(gtree["params"])[0]
    return {torch_name(tuple(k.key for k in path)): np.asarray(a) for path, a in flat}


def test_radial_profile_fold_final_matches_jax():
    """``RadialProfile(fold_final=True)`` (and the ``ScalarMLP`` under it)
    returns the JAX module's (h, Wr, offset) on the same parameters, and
    ``h @ Wr + offset`` is the unfolded output."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9, 16))
    jp = jnn.RadialProfile(features=(8, 8, 30))
    tree, tp_ = _pair(jp, tnn.RadialProfile(16, (8, 8, 30)), (jnp.asarray(x),))
    jh, jWr, joff = jp.apply(tree, jnp.asarray(x), fold_final=True)
    h, Wr, off = tp_(_t(x), fold_final=True)
    assert h.shape == (9, 8) and Wr.shape == (8, 30) and off.shape == (30,)
    for got, want in ((h, jh), (Wr, jWr), (off, joff)):
        assert _rel(got.detach().numpy(), want) < 1e-12
    full = tp_(_t(x)).detach().numpy()
    assert _rel((h @ Wr + off).detach().numpy(), full) < 1e-12
    assert _rel(full, jp.apply(tree, jnp.asarray(x))) < 1e-12
    # the parameters and their gradients are the same on either path
    g1 = torch.autograd.grad((tp_(_t(x)) ** 2).sum(), list(tp_.parameters()))
    h, Wr, off = tp_(_t(x), fold_final=True)
    g2 = torch.autograd.grad(((h @ Wr + off) ** 2).sum(), list(tp_.parameters()))
    assert max(float((a - b).abs().max()) for a, b in zip(g1, g2)) < 1e-12


def test_separable_fctp_fold_matches_jax_first_order():
    """``SeparableFCTP(radial_fold=True)`` (the first-order op: K7-F / K7-B
    plain versions) against JAX's unfolded module on the same parameters:
    the output and every parameter gradient, and the input gradients."""
    rng = np.random.default_rng(5)
    Ee = 12
    x, sh, rbf = rng.normal(size=(Ee, Irreps(IRR).dim)), rng.normal(size=(Ee, 9)), \
        rng.normal(size=(Ee, 16))
    kw = dict(fc_neurons=(16, 8), use_activation=True, internal_weights=False)
    jm = jnn.SeparableFCTP(JIrreps(IRR), JIrreps(SH), JIrreps(IRR), **kw, higher_order_grads=False)
    jargs = (jnp.asarray(x), jnp.asarray(sh), jnp.asarray(rbf))
    tree, tm = _pair(jm, tnn.SeparableFCTP(IRR, SH, IRR, **kw, higher_order_grads=False,
                                           radial_fold=True), jargs)
    assert tm.plan.radial_fold == 8
    c = rng.normal(size=(Ee, Irreps(IRR).dim))
    loss = lambda p, x, r: jnp.sum(jm.apply(p, x, jnp.asarray(sh), r) * c)  # noqa: E731
    jgp, jgx, jgr = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(tree, jargs[0], jargs[2])
    tx, tr = _t(x).requires_grad_(), _t(rbf).requires_grad_()
    out = tm(tx, _t(sh), tr)
    assert _rel(out.detach().numpy(), jax.jit(jm.apply)(tree, *jargs)) < 1e-12
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad((out * _t(c)).sum(), [tx, tr] + list(params.values()))
    assert _rel(grads[0].numpy(), jgx) < TOL and _rel(grads[1].numpy(), jgr) < TOL
    want = _grad_leaves(jgp)
    assert set(want) == set(params)
    for (n, _), g in zip(params.items(), grads[2:]):
        assert _rel(_flip(n, g.numpy()), want[n]) < TOL, n


@pytest.mark.parametrize("module", ["sep_act", "edge_degree"])
def test_modules_fold_match_jax_force_route(module):
    """With ``higher_order_grads``, ``radial_fold`` and ``radial_fold_ho``
    (K7-F / K7-B3 plain versions): the outputs and the gradients of the
    inputs a force evaluation differentiates (positions reach the node
    features, the SH and the radial basis), on detached parameters."""
    rng = np.random.default_rng(6)
    N, Ee = 10, 24
    sh, rbf = rng.normal(size=(Ee, 9)), rng.normal(size=(Ee, 16))
    fold = dict(radial_fold=True, radial_fold_ho=True)
    if module == "sep_act":
        x = rng.normal(size=(Ee, Irreps(IRR).dim))
        kw = dict(fc_neurons=(16, 8), use_activation=True, internal_weights=False)
        jm = jnn.SeparableFCTP(JIrreps(IRR), JIrreps(SH), JIrreps(IRR), **kw)
        jargs = (jnp.asarray(x), jnp.asarray(sh), jnp.asarray(rbf))
        tree, tm = _pair(jm, tnn.SeparableFCTP(IRR, SH, IRR, **kw, **fold), jargs)
        jf = lambda x, s, r: jm.apply(tree, x, s, r)  # noqa: E731
        tf = lambda x, s, r: tm(x, s, r)  # noqa: E731
        ins = (x, sh, rbf)
    else:
        dst = np.sort(rng.integers(0, N, size=Ee))
        src = rng.integers(0, N, size=Ee)
        mask = np.arange(Ee) < 20
        jm = jnn.EdgeDegreeEmbedding(JIrreps(IRR), JIrreps(SH), (16, 8), 3.0)
        jargs = (jnp.asarray(sh), jnp.asarray(rbf), jnp.asarray(src), jnp.asarray(dst),
                 jnp.asarray(mask), N)
        tree, tm = _pair(jm, tnn.EdgeDegreeEmbedding(IRR, SH, (16, 8), 3.0, **fold), jargs)
        jf = lambda s, r: jm.apply(tree, s, r, *jargs[2:])  # noqa: E731
        tf = lambda s, r: tm(s, r, _t(dst), _t(mask), N)  # noqa: E731
        ins = (sh, rbf)
    assert tm.plan.radial_fold == 8
    for p in tm.parameters():
        p.requires_grad_(False)
    out0 = jax.jit(jf)(*map(jnp.asarray, ins))
    c = rng.normal(size=out0.shape)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jf(*a) * c), argnums=tuple(range(len(ins)))))(
        *map(jnp.asarray, ins))
    tins = [_t(a).requires_grad_() for a in ins]
    out = tf(*tins)
    assert _rel(out.detach().numpy(), out0) < 1e-12
    tg = torch.autograd.grad((out * _t(c)).sum(), tins)
    for got, want in zip(tg, jg):
        assert _rel(got.numpy(), want) < TOL


# ------------------------------------------------------------- fused ops
@pytest.mark.parametrize("case", list(HEADS))
def test_folded_first_order_op_matches_jax_composition(case):
    """``dtp_lin`` with ``(h, [Wr; offset])`` (K7-F forward, K7-B backward,
    their plain versions here) against the JAX composition: the values, and
    dx, dh, dWr, doffset and the head weights' gradients, with ``n_edges``
    below E (padded rows add nothing, the offset's ones column included)."""
    heads = HEADS[case]
    c = _case(heads)
    plan = _plan(heads)
    assert plan.dw_has_dead_cols == (case == "dead-w-cols")
    f = _jax_composed(heads, N_REAL)
    cots = [np.random.default_rng(7).normal(size=(E, Irreps(h).dim)) for h in heads]
    jargs = [jnp.asarray(c[k]) for k in ("x", "sh", "h", "Wr", "off")]
    jhw = [[None if a is None else jnp.asarray(a) for a in ws] for ws in c["head_ws"]]

    def loss(x, sh, h, Wr, off, hw):
        return sum(jnp.sum(o * g) for o, g in zip(f(x, sh, h, Wr, off, hw), cots))

    jouts = jax.jit(f)(*jargs, jhw)
    jg = jax.jit(jax.grad(loss, argnums=(0, 2, 3, 4, 5)))(*jargs, jhw)
    lv = _leaves(c, grad=("x", "h", "Wr", "off", "head_ws"))
    outs = _port_out(dtp_lin, plan, c, lv, N_REAL)
    for o, jo in zip(outs, jouts):
        assert _rel(o.detach().numpy(), jo) < TOL
    hw = [a for ws in lv["head_ws"] for a in ws if a is not None]
    tg = torch.autograd.grad(sum((o * _t(g)).sum() for o, g in zip(outs, cots)),
                             [lv[k] for k in ("x", "h", "Wr", "off")] + hw)
    jhw_g = [a for ws in jg[4] for a in ws if a is not None]
    for got, want in zip(tg, list(jg[:4]) + jhw_g):
        assert _rel(got.numpy(), want) < TOL
    assert float(tg[1][N_REAL:].abs().max()) == 0.0  # dh of padded rows
    if case == "dead-w-cols":  # Wr columns that feed no head get no gradient
        dead = ~plan.radial_cols(torch.device("cpu")).new_zeros(plan.d_w, dtype=torch.bool) \
            .index_fill_(0, plan.radial_cols(torch.device("cpu")), True)
        assert int(dead.sum()) > 0 and float(tg[2][:, dead].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["one-head", "dead-w-cols"])
def test_folded_force_op_matches_jax_composition(case):
    """``dtp_lin_ho`` with ``(h, [Wr; offset])`` (K7-F forward, K7-B3
    backward): the values and dx, dsh, dh of a scalar loss; parameters
    detached, as in a force evaluation.  A ``create_graph=True`` pass and a
    gradient of [Wr; offset] give JAX's second-order and parameter
    gradients (the folded leg kernels K7-L, K7-LW, K7-Wr behind them)."""
    heads = HEADS[case]
    c = _case(heads, seed=1)
    plan = _plan(heads)
    f = _jax_composed(heads, N_REAL)
    cots = [np.random.default_rng(8).normal(size=(E, Irreps(h).dim)) for h in heads]
    jhw = [[None if a is None else jnp.asarray(a) for a in ws] for ws in c["head_ws"]]
    jargs = [jnp.asarray(c[k]) for k in ("x", "sh", "h", "Wr", "off")]

    def loss(x, sh, h):
        return sum(jnp.sum(o * g) for o, g in zip(f(x, sh, h, *jargs[3:], jhw), cots))

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*jargs[:3])
    lv = _leaves(c, grad=("x", "sh", "h"))
    outs = _port_out(dtp_lin_ho, plan, c, lv, N_REAL)
    for o, jo in zip(outs, jax.jit(f)(*jargs, jhw)):
        assert _rel(o.detach().numpy(), jo) < TOL
    tl = sum((o * _t(g)).sum() for o, g in zip(outs, cots))
    tg = torch.autograd.grad(tl, [lv["x"], lv["sh"], lv["h"]], retain_graph=True)
    for got, want in zip(tg, jg):
        assert _rel(got.numpy(), want) < TOL
    # second order: |dx|^2 differentiated with respect to sh and h
    (dx,) = torch.autograd.grad(tl, [lv["x"]], create_graph=True)
    assert _rel(dx.detach().numpy(), jg[0]) < TOL
    second = torch.autograd.grad(dx.square().sum(), [lv["sh"], lv["h"]])
    jsecond = jax.jit(jax.grad(lambda sh, h: jnp.sum(jax.grad(loss, 0)(jargs[0], sh, h) ** 2),
                               argnums=(0, 1)))(*jargs[1:3])
    for got, want in zip(second, jsecond):
        assert _rel(got.numpy(), want) < TOL
    # the parameter gradients: x and [Wr; offset] through its rows
    lw = _leaves(c, grad=("x", "Wr"))
    sum(o.sum() for o in _port_out(dtp_lin_ho, plan, c, lw, N_REAL)).backward()
    jw = jax.jit(jax.grad(lambda x, Wr: sum(jnp.sum(o) for o in f(
        x, jargs[1], jargs[2], Wr, jargs[4], jhw)), argnums=(0, 1)))(jargs[0], jargs[3])
    assert _rel(lw["x"].grad.numpy(), jw[0]) < TOL and _rel(lw["Wr"].grad.numpy(), jw[1]) < TOL


def _jax_vjps(heads, c, at_h, off, cots):
    """jax.vjp of the JAX composition with the heads' cotangents, at h =
    ``at_h`` and the given offset: (dx, dsh, dh, dWr, doffset, the heads'
    weight gradients)."""
    f = _jax_composed(heads, N_REAL)
    jhw = [[None if a is None else jnp.asarray(a) for a in ws] for ws in c["head_ws"]]
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (c["x"], c["sh"], at_h, c["Wr"], off)), jhw)
    return vjp([jnp.asarray(g) for g in cots])


def _flat_cot(plan, head_cots):
    """The heads' cotangents in the fused flat output's layout."""
    probe = torch.zeros(E, plan.d_out, dtype=torch.float64, requires_grad=True)
    return torch.autograd.grad(plan.split_output(probe), probe, [_t(g) for g in head_cots])[0]


@pytest.mark.parametrize("case", list(HEADS))
def test_folded_leg_plains_match_jax_vjps(case):
    """The folded legs' plain versions (K7-L: F_x, F_sh, F_h; K7-B3: the
    three together; K7-LW: F_W, carried back to the heads' weights; K7-Wr:
    F_Wr) against jax.vjp of the
    unfolded composition ``w = h @ Wr + offset; lin(dtp(x, sh, w))``, fp64,
    1e-9, with a nonzero offset and padded rows past n_edges.  With the
    primal h in h's slot the offset row of F_Wr is doffset; with a tangent
    there (the ones-column rule: [Wr; 0] to the other legs, ones=False to
    F_Wr) the legs are JAX's at that h and offset 0, and the offset row is
    0."""
    from equiformer_tpu_torch.kernels import (
        dtp_lin_rad_leg_plain, dtp_lin_rad_legW_plain, dtp_lin_rad_legWr_plain,
    )

    heads = HEADS[case]
    c = _case(heads, seed=11)
    plan = _plan(heads)
    cots = [np.random.default_rng(12).normal(size=(E, Irreps(h).dim)) for h in heads]
    g = _flat_cot(plan, cots)
    n = torch.tensor(N_REAL, dtype=torch.int32)
    tangent = np.random.default_rng(13).normal(size=c["h"].shape)
    lv = _leaves(c, grad=("head_ws",))
    W = plan.pack_weights(lv["head_ws"])
    hws = [a for ws in lv["head_ws"] for a in ws if a is not None]
    x, sh = lv["x"], lv["sh"]
    Wrs = plan.pack_radial(lv["Wr"], lv["off"])
    for at_h, ones in ((c["h"], True), (tangent, False)):
        jdx, jdsh, jdh, jdWr, jdoff, jdws = _jax_vjps(
            heads, c, at_h, c["off"] if ones else np.zeros_like(c["off"]), cots)
        h = _t(at_h)
        Wh = Wrs if ones else torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])
        with torch.no_grad():
            dx = dtp_lin_rad_leg_plain(plan, "x", g, None, sh, h, Wh, W, n)
            dsh = dtp_lin_rad_leg_plain(plan, "sh", g, x, None, h, Wh, W, n)
            dh = dtp_lin_rad_leg_plain(plan, "h", g, x, sh, None, Wh, W, n)
            dWrs = dtp_lin_rad_legWr_plain(plan, g, x, sh, h, W, n, ones)
            b3 = dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wh, W, g, n)  # K7-B3's plain
        dW = dtp_lin_rad_legW_plain(plan, g, x, sh, h, Wh, n)
        for got, want in ((dx, jdx), (dsh, jdsh), (dh, jdh)) + tuple(zip(b3, (jdx, jdsh, jdh))):
            assert _rel(got.numpy(), want) < TOL
            assert float(got[N_REAL:].abs().sum()) == 0.0  # padded rows
        assert _rel(dWrs[:-1].numpy(), jdWr) < TOL
        assert dWrs.dtype == torch.float64 and dWrs.shape == (HD + 1, plan.d_w)
        if ones:
            assert _rel(dWrs[-1].numpy(), jdoff) < TOL
        else:
            assert float(dWrs[-1].abs().max()) == 0.0
        want = [a for ws in jdws for a in ws if a is not None]
        for got, j in zip(torch.autograd.grad(W, hws, dW), want):
            assert _rel(got.numpy(), j) < TOL


def _grad_of_grad_jax(heads, c):
    """JAX's grad of the force-training pattern on the composition: energy
    = sum tanh(out), loss = |dE/dx|^2 + |dE/dsh|^2 + |dE/dh|^2, then
    d loss / d(x, h, Wr, offset, head weights)."""
    f = _jax_composed(heads, N_REAL)

    def energy(x, sh, h, Wr, off, hws):
        return sum(jnp.sum(jnp.tanh(o)) for o in f(x, sh, h, Wr, off, hws))

    def train_loss(x, sh, h, Wr, off, hws):
        fx, fsh, fh = jax.grad(energy, argnums=(0, 1, 2))(x, sh, h, Wr, off, hws)
        return jnp.sum(fx ** 2) + jnp.sum(fsh ** 2) + jnp.sum(fh ** 2)

    jhw = [[None if a is None else jnp.asarray(a) for a in ws] for ws in c["head_ws"]]
    args = [jnp.asarray(c[k]) for k in ("x", "sh", "h", "Wr", "off")]
    return jax.jit(jax.value_and_grad(train_loss, argnums=(0, 2, 3, 4, 5)))(*args, jhw)


@pytest.mark.parametrize("case", list(HEADS))
def test_folded_op_grad_of_grad_matches_jax(case):
    """The counterpart of JAX's ``test_rad_fused_grad_of_grad``: energy =
    sum tanh(out), train_loss = |dE/dx|^2 + |dE/dsh|^2 + |dE/dh|^2 (the
    port's gradients taken with ``create_graph=True``), differentiated with
    respect to x, h, Wr, offset and the head weights, against jax.grad of
    jax.grad of the unfolded composition, fp64, 1e-9, with a nonzero offset
    and padded rows.  The loss on dh sends a cotangent into h's slot: a
    missed ones-column rule moves doffset by sum(dw)."""
    heads = HEADS[case]
    c = _case(heads, seed=14)
    plan = _plan(heads)
    jval, jgrads = _grad_of_grad_jax(heads, c)
    lv = _leaves(c, grad=("x", "sh", "h", "Wr", "off", "head_ws"))
    energy = sum(torch.tanh(o).sum() for o in _port_out(dtp_lin_ho, plan, c, lv, N_REAL))
    fx, fsh, fh = torch.autograd.grad(energy, [lv["x"], lv["sh"], lv["h"]], create_graph=True)
    loss = fx.square().sum() + fsh.square().sum() + fh.square().sum()
    hws = [a for ws in lv["head_ws"] for a in ws if a is not None]
    tg = torch.autograd.grad(loss, [lv[k] for k in ("x", "h", "Wr", "off")] + hws)
    assert abs(float(loss.detach()) - float(jval)) < TOL * abs(float(jval))
    want = list(jgrads[:4]) + [a for ws in jgrads[4] for a in ws if a is not None]
    assert len(want) == len(tg)
    for got, j in zip(tg, want):
        assert _rel(got.numpy(), j) < TOL


def test_folded_op_gradgradcheck():
    """torch.autograd's numeric check of the folded family's first and
    second derivatives in x, sh, h, Wr, offset and W at a tiny size (fp64;
    2x0e+1x1e features, SH to l=1, two heads, hd 4, 3 edges of which 2
    real)."""
    irr = Irreps("2x0e+1x1e")
    plan = DTPLinPlan(depthwise_tp(irr, Irreps("1x0e+1x1e"), irr), ["3x0e+1x1e", "2x0e"],
                      radial_fold=4)
    Ee, n = 3, torch.tensor(2, dtype=torch.int32)
    g = torch.Generator().manual_seed(9)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).requires_grad_()  # noqa: E731
    ins = [rnd(Ee, plan.d_x), rnd(Ee, plan.d_sh), rnd(Ee, 4), rnd(4, plan.d_w), rnd(plan.d_w),
           rnd(plan.w_numel)]
    f = lambda x, sh, h, Wr, off, W: dtp_lin_ho(plan, x, sh, (h, plan.pack_radial(Wr, off)), W,  # noqa: E731
                                                 n)
    assert torch.autograd.gradcheck(f, ins)
    assert torch.autograd.gradgradcheck(f, ins)


def test_folded_passes_call_the_folded_leg_kernels(monkeypatch):
    """Which kernels the two passes of force training call on a folded plan
    (counted at the wrappers): the force pass (W and Wr skipped) one K7-B3;
    the parameter pass (sh skipped) walks the K7-B3 node, whose dx, dsh and
    dh cotangents each go through the leg functions of the other operands
    (K7-F, K7-L, K7-Wr, K7-LW), and the forward node (K7-B3 for x and h,
    K7-Wr, K7-LW).  K7-Wr sees h's ones column 0 only below dh's cotangent
    (the ones-column rule); no unfolded kernel runs."""
    calls = []
    names = ("dtp_lin_rad_fwd", "dtp_lin_rad_bwd3", "dtp_lin_rad_leg", "dtp_lin_rad_legW",
             "dtp_lin_rad_legWr", "dtp_lin_fwd", "dtp_lin_bwd3", "dtp_lin_leg", "dtp_lin_legW")
    for name in names:
        def counting(*a, _f=getattr(kho, name), _n=name, **k):
            tag = {"dtp_lin_rad_leg": lambda: ":" + a[1],
                   "dtp_lin_rad_legWr": lambda: f":ones={a[7]}"}.get(_n, lambda: "")()
            calls.append(_n + tag)
            return _f(*a, **k)
        monkeypatch.setattr(kho, name, counting)
    plan, x, sh, h, Wrs, W, g = _kernel_inputs("two-head")
    x, sh, h, Wrs, W, g = (t.requires_grad_() for t in (x, sh, h, Wrs, W, g))
    out = kho.dtp_lin_ho(plan, x, sh, (h, Wrs), W)
    assert calls == ["dtp_lin_rad_fwd"]
    del calls[:]
    with kho.skip_leg_grads("W", "Wr"):
        dx, dsh, dh = torch.autograd.grad(out, (x, sh, h), g, create_graph=True)
    assert calls == ["dtp_lin_rad_bwd3"]
    del calls[:]
    with kho.skip_leg_grads("sh"):
        torch.autograd.grad(out.sum() + dx.sum() + dsh.sum() + dh.sum(), (g, x, h, Wrs, W))
    assert sorted(calls) == sorted(
        ["dtp_lin_rad_fwd"] * 3 + ["dtp_lin_rad_leg:h"] * 2 + ["dtp_lin_rad_leg:x"] * 2
        + ["dtp_lin_rad_legWr:ones=True"] * 3 + ["dtp_lin_rad_legWr:ones=False"]
        + ["dtp_lin_rad_legW"] * 4 + ["dtp_lin_rad_bwd3"])
    assert not kho._SKIPPED_LEGS


def test_plan_checks_the_fold():
    tp = depthwise_tp(Irreps(IRR), Irreps(SH), Irreps(IRR))
    assert DTPLinPlan(tp, [LIN_OUT], shared_weights=True, radial_fold=HD).radial_fold is None
    with pytest.raises(ValueError):
        DTPLinPlan(tp, [LIN_OUT], radial_fold=6)  # the kernels read h as float4
    plan = _plan([LIN_OUT])
    with pytest.raises(ValueError):
        plan.pack_radial(torch.zeros(HD + 1, plan.d_w), torch.zeros(plan.d_w))
    assert plan.pack_radial(torch.ones(HD, plan.d_w), torch.zeros(plan.d_w)).shape == (
        HD + 1, plan.d_w)


# ------------------------------------------- the kernels' tables in torch
def _emulate_rad_fwd(plan, x, sh, h, Wrs, W_flat, n_edges, tile=16):
    """csrc/dtp_lin.cu's K7-F (``k1::rad_fwd_kernel``): K1's block per (edge
    tile, irrep group) over ``k1_tables(fold=True)``, W and [Wr; offset]
    packed by one gather, the group's w built from h before its first
    component and read by the runs at their local column
    (``_emulate_k1``'s fold).  Returns (out, how often each element was
    written)."""
    return _emulate_k1(plan, x, sh, None, W_flat, n_edges, tile, fold=(h, Wrs))


# the output sets K7-B3 takes (two or three of dx, dsh, dh: one alone is K7-L's)
B3_NEEDS = [("x", "sh", "h"), ("x", "h"), ("sh", "h"), ("x", "sh")]


def _emulate_rad_bwd3(plan, x, sh, h, Wrs, W_flat, g, n_edges, need, n_split):
    """csrc/dtp_lin_bwd.cu's K7-B3 (``k2::rad_bwd3_kernel``): K5a's launch
    with the fold, a block per (16-edge tile, split of ``n_split``) over the
    split's irrep groups, w built from h at a group's first component (the
    offset from [Wr; offset]'s last row), dw kept in the tile and, with "h"
    in ``need``, dh += dw Wr_g^T at its last; the dx, dsh and dh partials
    summed in split order (``_emulate_k2_launch1``'s fold with "bwd3").
    Returns (dx, dsh, dh), None for what ``need`` leaves out."""
    return _emulate_k2_launch1(plan, x, sh, None, W_flat, g, n_edges, leg="bwd3",
                               n_split=n_split, need=need, fold=(h, Wrs))


def _check_bwd3(got, want, need, n_real):
    """K7-B3's outputs against its plain version's, 1e-6 relative (the
    tables' fp32 CG coefficients), rows past ``n_real`` exactly 0."""
    for leg, a, b in zip(("x", "sh", "h"), got, want):
        assert (a is None) == (leg not in need), (need, leg)
        if a is not None:
            assert a.shape == b.shape and _rel(a, b) < 1e-6, (need, leg)
            assert float(a[n_real:].abs().max()) == 0.0


def _kernel_inputs(case, seed=4):
    plan = _plan(HEADS[case])
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    return (plan, rnd(E, plan.d_x), rnd(E, plan.d_sh), rnd(E, HD), rnd(HD + 1, plan.d_w),
            rnd(plan.w_numel), rnd(E, plan.d_out))


@pytest.mark.parametrize("case", list(HEADS))
def test_rad_kernel_tables_drive_the_plain_math(case):
    """K7-F walks K1's block per (edge tile, irrep group) over
    ``k1_tables(fold=True)`` (16- and 32-edge tiles, each output element
    written once, rows past n_edges zero; also with [Wr; 0]), K7-B3
    DTPLinPlan.bwd_tables with each group's w columns in local order, and
    K7-B K2's two launches with the fold (w built from the packed Wr in
    both, dh on chip, dw through the workspace into the d[Wr; offset]
    tiles, every partial element written once per range), K7-B3 K5a's
    launch with the fold (every output set, each tile whole and cut by
    irrep group, also with [Wr; 0]); walking them in torch gives
    dtp_lin_rad_plain, dtp_lin_rad_bwd_plain and dtp_lin_rad_bwd3_plain
    (1e-6: the tables' fp32 CG coefficients)."""
    plan, x, sh, h, Wrs, W, g = _kernel_inputs(case)
    n = torch.tensor(N_REAL, dtype=torch.int32)
    Wr0 = torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])  # a tangent in h's slot
    for tile in (16, 32):
        for Wl in (Wrs, Wr0):
            got, writes = _emulate_rad_fwd(plan, x, sh, h, Wl, W, N_REAL, tile)
            assert bool((writes == 1).all())
            assert _rel(got, dtp_lin_rad_plain(plan, x, sh, h, Wl, W, n)) < 1e-6, tile
            assert float(got[N_REAL:].abs().max()) == 0.0
    got, writes = _emulate_k7b(plan, x, sh, h, Wrs, W, g, N_REAL)
    assert bool((writes == 1).all())
    for a, b in zip(got, dtp_lin_rad_bwd_plain(plan, x, sh, h, Wrs, W, g, n)):
        assert a.shape == b.shape and _rel(a, b) < 1e-6
    for Wl in (Wrs, Wr0):
        want = dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wl, W, g, n)
        for need in B3_NEEDS:
            for n_split in sorted({1, len(plan.groups)}):
                _check_bwd3(_emulate_rad_bwd3(plan, x, sh, h, Wl, W, g, N_REAL, need, n_split),
                            want, need, N_REAL)


def _emulate_rad_leg(plan, leg, x, sh, h, Wrs, W_flat, g, n_edges, n_split, tile=16):
    """K7-L's legs ("x", "sh", "h") as csrc/dtp_lin_bwd.cu runs them
    (``k2::rad_leg_kernel``: K2's launch 1 with the fold) in torch: W and
    [Wr; offset] packed by the wrapper's one gather (``k7_leg_tables``), a
    block per (16-edge tile, split of ``n_split``) over the split's irrep
    groups (``_group_rows``) of ``k2_tables``: at a group's first component
    the x and sh legs build its w from h (its Wr packing unpacked by the
    fragment layout, the offset from Wl's row hd, rounded to h's dtype), the
    h leg zeroes its dw tile; G staged, dz through the packed W, the leg's
    term transposes (dsh through its slots, in term order); at the group's
    last component the h leg adds dh += dw Wr_g^T from the dh packing, the
    span's K steps in two halves added in turn.  Each block writes its fp32
    partial [tile rows, width] once; the partials are summed in split order
    below ``n_edges``, zeros past it (one split: the block's rows are the
    output).  Returns (out, how often each partial element was written by
    the blocks of tiles with real edges)."""
    cpu, hd = torch.device("cpu"), plan.radial_fold
    _, terms, coeffs, *_ = plan.bwd_tables(cpu)
    terms, coeffs = terms.tolist(), coeffs.tolist()
    gk = plan.k2_tables(cpu).gk.tolist()
    kl, rgk = plan.k7_leg_tables(cpu), plan.k7_tables(cpu).rgk.tolist()
    packed = fold_gather(plan, W_flat, Wrs, kl.index)
    Wp, pk = packed[: kl.pk_off], packed[kl.pk_off : kl.wl_off]
    Wl = packed[kl.wl_off :].view(hd + 1, -1)
    E_ = g.shape[0]
    width = {"x": plan.d_x, "sh": plan.d_sh, "h": hd}[leg]
    part = torch.full((n_split, E_, width), float("nan"), dtype=g.dtype)
    writes = torch.zeros((n_split, E_, width), dtype=torch.int64)
    for e0 in range(0, E_, tile):
        n_rows, n_live = min(tile, E_ - e0), max(0, min(tile, E_ - e0, n_edges - e0))
        if n_live == 0:
            continue
        rows = slice(e0, e0 + n_live)
        for s in range(n_split):
            acc = torch.zeros(tile, width, dtype=g.dtype)
            for q in _group_rows(gk, n_split, s):
                fs, cols, out_col, _, tb, te, wp_off, cp, sb, sn, first, last = gk[q]
                ob, od = rgk[q]
                if first:
                    if leg != "h":
                        n_b = -(-sn // 8) * 8 * -(-hd // 16) * 16
                        Wr_g = _unpack_k2(pk[ob : ob + n_b], sn, hd)[:sn, :hd].T
                        s_w = (h[rows] @ Wr_g + Wl[hd, sb : sb + sn]).to(h.dtype)
                    s_dw = torch.zeros(n_live, sn, dtype=g.dtype)
                s_g = torch.zeros(tile, cp, dtype=g.dtype)
                s_g[:n_live, :cols] = g[rows, out_col : out_col + cols]
                dz = s_g @ _unpack_k2(Wp[wp_off : wp_off + -(-fs // 8) * 8 * cp], fs, cols).T
                if leg == "sh":  # the slots, then per (row, column) its terms' slots in order
                    slots = _k2_dsh_slots(terms[tb:te], coeffs[tb:te], x[rows], s_w, dz, n_live)
                    for col in range(plan.d_sh):
                        for j, t in enumerate(terms[tb:te]):
                            if t[1] == col:
                                acc[:n_live, col] += slots[:, j]
                    continue
                for (a, col, _, fc, mul, bl), c in zip(terms[tb:te], coeffs[tb:te]):
                    d = c * sh[rows, col : col + 1] * dz[:n_live, fc : fc + mul]
                    if leg == "x":
                        acc[:n_live, a : a + mul] += d * s_w[:, bl : bl + mul]
                    else:
                        s_dw[:, bl : bl + mul] += d * x[rows, a : a + mul]
                if leg == "h" and last:  # the span's K steps in two halves, added in turn
                    n_d = -(-hd // 8) * 8 * -(-sn // 16) * 16
                    Wr_t = _unpack_k2(pk[od : od + n_d], hd, sn)[:hd, :sn]
                    cut = min(sn, 16 * (-(-sn // 16) // 2))
                    acc[:n_live] += s_dw[:, :cut] @ Wr_t[:, :cut].T
                    acc[:n_live] += s_dw[:, cut:] @ Wr_t[:, cut:].T
            part[s, e0 : e0 + n_rows] = acc[:n_rows]
            writes[s, e0 : e0 + n_rows] += 1
    out = torch.zeros(E_, width, dtype=g.dtype)
    live = min(E_, n_edges)
    for s in range(n_split):  # split order (one split: the block's rows themselves)
        out[:live] += part[s, :live]
    return out, writes[:, :live]


@pytest.mark.parametrize("case", list(HEADS))
def test_rad_leg_kernel_tables_drive_the_plain_math(case):
    """K7-L (x, sh, h legs) walks K2's launch 1 with the fold, a block per
    (tile, irrep group) or per whole tile, each partial written once and the
    partials summed in group order (also with [Wr; 0], a tangent in h's
    slot: the offset comes from the operand), K7-LW K2's launch 2 with each
    step's w rebuilt from h
    (also with [Wr; 0], a tangent in h's slot: the offset comes from the
    operand), K7-Wr (h's ones column 1 and 0) K5b's w leg on K2's launch 1
    and the d[Wr; offset] tiles over its edge ranges; walking them in torch
    gives dtp_lin_rad_leg_plain, dtp_lin_rad_legW_plain and
    dtp_lin_rad_legWr_plain (1e-6: the tables' fp32 CG coefficients), with
    padded rows past n_edges and each dW element written once per range."""
    from equiformer_tpu_torch.kernels import (
        dtp_lin_rad_leg_plain, dtp_lin_rad_legW_plain, dtp_lin_rad_legWr_plain,
    )

    plan, x, sh, h, Wrs, W, g = _kernel_inputs(case, seed=5)
    n = torch.tensor(N_REAL, dtype=torch.int32)
    Wr0 = torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])  # a tangent in h's slot
    for leg in ("x", "sh", "h"):
        ops = {"x": x, "sh": sh, "h": h, leg: None}
        for Wl in (Wrs, Wr0):
            want = dtp_lin_rad_leg_plain(plan, leg, g, ops["x"], ops["sh"], ops["h"], Wl, W, n)
            for n_split in sorted({1, len(plan.groups)}):
                got, writes = _emulate_rad_leg(plan, leg, ops["x"], ops["sh"], ops["h"], Wl, W,
                                               g, N_REAL, n_split)
                assert bool((writes == 1).all())
                assert got.shape == want.shape and _rel(got, want) < 1e-6, (leg, n_split)
    for Wl in (Wrs, torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])):
        want = dtp_lin_rad_legW_plain(plan, g, x, sh, h, Wl, n)
        got, writes = _emulate_k7lw(plan, g, x, sh, h, Wl, N_REAL)
        assert bool((writes == 1).all()) and _rel(got, want) < 1e-6
    for ones in (True, False):
        want = dtp_lin_rad_legWr_plain(plan, g, x, sh, h, W, n, ones)
        got = _emulate_k7wr(plan, g, x, sh, h, W, N_REAL, ones)
        assert got.shape == want.shape and _rel(got, want) < 1e-6
        assert (float(got[-1].abs().max()) == 0.0) == (not ones)


# the fold's full-width plans (hd 64): the QM9 flagship's sep_act (two heads)
# and edge degree, MD17 exp_l3's sep_act
K7_PLANS = {
    "qm9-sep_act": ("128x0e+64x1e+32x2e", SH, ["224x0e+64x1e+32x2e", "128x0e"]),
    "qm9-edge_deg": ("128x0e+64x1e+32x2e", SH, ["128x0e+64x1e+32x2e"]),
    "md17-sep_act": ("128x0e+64x1e+64x2e+32x3e", "1x0e+1x1e+1x2e+1x3e",
                     ["288x0e+64x1e+64x2e+32x3e", "128x0e"]),
}


def _k7_plan(site):
    irr, sh_irr, heads = K7_PLANS[site]
    return DTPLinPlan(depthwise_tp(Irreps(irr), Irreps(sh_irr), Irreps(irr)), heads,
                      radial_fold=64)


# K7-B3's full-width sites: MD17 exp_l3's sep_act and its edge degree (x a
# row-broadcast of the constant feature)
B3_SITES = {"md17-sep_act": False, "md17-edge_deg": True}


@pytest.mark.parametrize("need", B3_NEEDS)
@pytest.mark.parametrize("site", list(B3_SITES))
def test_k7b3_walks_k5a_launch_at_md17_plans(site, need):
    """K7-B3 (k2::rad_bwd3_kernel) as K2's launch 1 runs it with the fold at
    MD17 exp_l3's full-width sites (hd 64), each tile's block cut by irrep
    group as the wrapper launches it: 21 edges of which 13 real (a partial
    tile and a tile past the real edges), every output set, and for the
    three outputs also with [Wr; 0] (a tangent in h's slot: the offset comes
    from the operand), against dtp_lin_rad_bwd3_plain within 1e-6 (fp64
    inputs, the tables' fp32 CG coefficients); rows past n_edges 0."""
    irr, sh_irr = "128x0e+64x1e+64x2e+32x3e", "1x0e+1x1e+1x2e+1x3e"
    heads = K7_PLANS["md17-sep_act"][2] if site == "md17-sep_act" else [irr]
    plan = DTPLinPlan(depthwise_tp(Irreps(irr), Irreps(sh_irr), Irreps(irr)), heads,
                      radial_fold=64)
    rng = np.random.default_rng(31)
    rnd = lambda *s: _t(rng.normal(size=s))  # noqa: E731
    x = rnd(1, plan.d_x).expand(21, plan.d_x) if B3_SITES[site] else rnd(21, plan.d_x)
    sh, h, Wrs, W, g = rnd(21, plan.d_sh), rnd(21, 64), rnd(65, plan.d_w), rnd(plan.w_numel), \
        rnd(21, plan.d_out)
    n = torch.tensor(13, dtype=torch.int32)
    Wr0 = torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])
    for Wl in (Wrs, Wr0) if len(need) == 3 else (Wrs,):
        _check_bwd3(_emulate_rad_bwd3(plan, x, sh, h, Wl, W, g, 13, need, len(plan.groups)),
                    dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wl, W, g, n), need, 13)


@pytest.mark.parametrize("n_ranges", [1, 2, 3])
@pytest.mark.parametrize("ones", [True, False])
@pytest.mark.parametrize("site", list(K7_PLANS))
def test_k7_contraction_matches_radial_dWrs_plain(site, ones, n_ranges):
    """The d[Wr; offset] tiles that K7-B's launch 2 and K7-Wr share
    (k2::dWr_body), walked in torch over edge ranges of whole 16-edge steps
    (64 in the kernel) and summed in range order, give radial_dWrs_plain in
    fp64 within 1e-6 at the fold's full-width plans, with h's ones column 1
    and 0: 37 edges of which 29 are real, each partial element written once
    per range, and rows past n_edges (NaN here) adding exactly 0."""
    plan = _k7_plan(site)
    rng = np.random.default_rng(11)
    h, dw = _t(rng.normal(size=(37, 64))), _t(rng.normal(size=(37, plan.d_w)))
    range_len = -(-37 // n_ranges // 16) * 16
    assert -(-37 // range_len) == n_ranges
    part, writes = _k7_wr_partials(plan, h, dw, 29, ones, range_len, step=16)
    assert part.shape[0] == n_ranges and bool((writes == 1).all())
    got = _k7_dWrs(plan, _sum_rows(part))
    want = radial_dWrs_plain(h, dw, torch.tensor(29, dtype=torch.int32), ones)
    assert _rel(got, want) < 1e-6
    assert (float(got[-1].abs().max()) == 0.0) == (not ones)
    h[29:], dw[29:] = float("nan"), float("nan")
    again = _k7_dWrs(plan, _sum_rows(_k7_wr_partials(plan, h, dw, 29, ones, range_len, step=16)[0]))
    assert torch.equal(again, got)


@pytest.mark.parametrize("site", list(K7_PLANS) + ["dead-w-cols"])
def test_k7_packed_Wr_unpacks_to_each_group(site):
    """The fold's packings of [Wr; offset] for K7-B (DTPLinPlan.k7_tables),
    unpacked by the mma fragment layout, are each group's columns of Wr in
    local order, for the w build (K = hd, N = span) and for dh (K = span, N
    = hd); the plan's fan order is its local w order.  K7-L's one gather of
    W and [Wr; offset] (``k7_leg_tables``) gives K2's packed W, those
    packings and Wl, each where its offsets say."""
    cpu = torch.device("cpu")
    plan = _plan(HEADS["dead-w-cols"]) if site == "dead-w-cols" else _k7_plan(site)
    rng = np.random.default_rng(12)
    Wrs = _t(rng.normal(size=(plan.radial_fold + 1, plan.d_w)))
    Wl, packs = _k7_packs(plan, Wrs)
    gk = plan.k2_tables(cpu).gk.tolist()
    assert sorted(packs) == [q for q, r in enumerate(gk) if r[10]]
    for q, (pw, pd) in packs.items():
        sb, sn = gk[q][8], gk[q][9]
        assert torch.equal(pw, Wl[:-1, sb : sb + sn]) and torch.equal(pd, Wl[:-1, sb : sb + sn])
    W = _t(rng.normal(size=plan.w_numel))
    kl = plan.k7_leg_tables(cpu)
    packed = fold_gather(plan, W, Wrs, kl.index)
    assert torch.equal(packed[: kl.pk_off], k2_packed_W(plan, W))
    assert torch.equal(packed[kl.pk_off : kl.wl_off],
                       torch.cat([Wl.reshape(-1), Wl.new_zeros(1)])[plan.k7_tables(cpu).index])
    assert torch.equal(packed[kl.wl_off :], Wl.reshape(-1))


@pytest.mark.parametrize("site, itemsize, E, tile, x_global", [
    ("qm9-sep_act", 4, 36352, 16, False), ("qm9-sep_act", 2, 36352, 16, False),
    ("qm9-edge_deg", 4, 36352, 32, False), ("qm9-edge_deg", 2, 36352, 16, False),
    ("md17-sep_act", 4, 2944, 16, True), ("md17-sep_act", 2, 2944, 16, False),
])
def test_k7f_tile_fits_two_blocks_and_fills_the_card(site, itemsize, E, tile, x_global):
    """K7-F's block is K1's with the fold's h and w tiles, which
    ``k1_smem_bytes(fold=True)`` counts: at QM9 sep_act in fp32 the 32-edge
    tile (172 KB) would hold one block an SM, so the 16-edge one (86 KB);
    the edge degree's row-broadcast x leaves room for 32 (113 KB); at MD17
    L3 sep_act in fp32 the 16-edge tile (145 KB) holds one block an SM with
    x staged, so x is read through L2 (91 KB); bf16 takes the 16-edge tile
    and stages x.  Every choice leaves room for a second block."""
    plan = _k7_plan(site)
    x_rows = site != "qm9-edge_deg"
    assert k1_tile(plan, itemsize, x_rows, E, 132, fold=True) == tile
    assert k1_x_global(plan, itemsize, x_rows, tile) == x_global
    assert k1_smem_bytes(plan, tile, itemsize, x_rows, True, x_global) <= K1_TWO_BLOCKS_SMEM
    assert k1_smem_bytes(plan, tile, itemsize, x_rows, True) > k1_smem_bytes(plan, tile, itemsize,
                                                                              x_rows)
    kt = plan.k1_tables(torch.device("cpu"), fold=True)
    assert kt.span_max == max(g.fan for g in plan.groups) and kt.vec == 4


def test_ctypes_signatures_match_the_c_entry_points():
    """Every ``extern "C"`` entry point of csrc/ has a ctypes signature in
    kernels/_build.py of the same length, pointers as c_void_p, long long
    as c_longlong, float as c_float and int as c_int (ctypes would pass a
    pointer given as an int cut to 32 bits, and a float as its integer
    part)."""
    import ctypes

    found = {}
    for src in sorted(Path(_build.CSRC).glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[m.group(1)] = [a.strip() for a in m.group(2).split(",") if a.strip()]
    assert set(found) == set(_build._SIGNATURES)
    for name, args in found.items():
        want = [ctypes.c_void_p if "*" in a else ctypes.c_longlong if "long long" in a
                else ctypes.c_float if a.startswith("float ") else ctypes.c_int for a in args]
        assert _build._SIGNATURES[name] == want, name


@pytest.mark.slow
def test_fold_plain_matches_pallas_interpret():
    """JAX's radial-folded Pallas kernel in interpret mode
    (``make_fused_dtp_lin`` of a plan with ``radial_fold=HD``) against the
    port's folded op on the CPU: values and dx / dh / dWr / doffset of a
    scalar loss, fp32, 1e-5 relative on the real rows.  The interpret sweep
    takes minutes, hence the slow tier."""
    from equiformer_tpu.kernels.dtp_lin_pallas import DTPLinPlan as JPlan, make_fused_dtp_lin

    heads = HEADS["two-head"]
    c = {k: (np.asarray(v, np.float32) if k != "head_ws" else
             [[None if a is None else np.asarray(a, np.float32) for a in ws] for ws in v])
         for k, v in _case(heads, seed=2).items()}
    jplan = JPlan(j_dtp(JIrreps(IRR), JIrreps(SH), JIrreps(IRR)), [JIrreps(h) for h in heads],
                  fold_rescale=True, shared_weights=False, radial_fold=HD)
    fused = make_fused_dtp_lin(jplan, tile=128, interpret=True)
    Ws = jplan.pack_weights([[None if a is None else jnp.asarray(a) for a in ws]
                             for ws in c["head_ws"]])
    cots = [np.random.default_rng(9).normal(size=(E, Irreps(h).dim)).astype(np.float32)
            for h in heads]
    for cc in cots:
        cc[N_REAL:] = 0.0

    def jloss(x, h, Wr, off):
        out = fused(x, jnp.asarray(c["sh"]), (h, jplan.pack_radial(Wr, off)), Ws,
                    n_edges=N_REAL)
        return sum(jnp.sum(o * g) for o, g in zip(jplan.split_output(out), cots))

    jargs = [jnp.asarray(c[k]) for k in ("x", "h", "Wr", "off")]
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    plan = _plan(heads)
    lv = _leaves(c, grad=("x", "h", "Wr", "off"))
    outs = _port_out(dtp_lin, plan, c, lv, N_REAL)
    tg = torch.autograd.grad(sum((o * _t(g)).sum() for o, g in zip(outs, cots)),
                             [lv[k] for k in ("x", "h", "Wr", "off")])
    for got, want, rows in zip(tg, jg, (N_REAL, N_REAL, None, None)):
        got, want = got.numpy(), np.asarray(want)
        if rows is not None:
            got, want = got[:rows], want[:rows]
        assert _rel(got, want) < 1e-5
