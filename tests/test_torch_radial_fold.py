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
from equiformer_tpu_torch.utils import params_from_jax, torch_name  # noqa: E402

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
    detached, as in a force evaluation.  A ``create_graph=True`` pass, or a
    gradient of [Wr; offset] or W, raises ``NotImplementedError``."""
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
    with pytest.raises(NotImplementedError, match="K7-L, K7-LW and K7-Wr"):
        torch.autograd.grad(tl, [lv["x"]], create_graph=True)
    lw = _leaves(c, grad=("x", "Wr"))
    with pytest.raises(NotImplementedError, match="K7-L, K7-LW and K7-Wr"):
        sum(o.sum() for o in _port_out(dtp_lin_ho, plan, c, lw, N_REAL)).backward()


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
def _tile_w(Wl, hd, hs, sb, sn):
    """K7's ``build_w``: a group's w columns of one tile."""
    return Wl[hd, sb : sb + sn] + hs @ Wl[:hd, sb : sb + sn]


def _emulate_rad_fwd(plan, x, sh, h, Wrs, W_flat, n_edges, tile=32):
    """csrc/dtp_lin.cu's folded loop over ``plan.bwd_tables``: per tile, the
    group's w built from the local [Wr; offset] at its first component, z
    from the terms (local w columns), z @ W_g."""
    gk, terms, coeffs, *_ = plan.bwd_tables(torch.device("cpu"))
    gk, terms, coeffs = gk.tolist(), terms.tolist(), coeffs.tolist()
    Wl, hd = Wrs[:, plan.radial_cols(torch.device("cpu"))], plan.radial_fold
    out = torch.zeros(x.shape[0], plan.d_out, dtype=x.dtype)
    for e0 in range(0, min(x.shape[0], n_edges), tile):
        rows = slice(e0, min(e0 + tile, n_edges))
        for fs, cols, out_col, w_off, tb, te, _, _, sb, sn, first, _ in gk:
            if first:
                ws = _tile_w(Wl, hd, h[rows], sb, sn)
            z = torch.zeros(rows.stop - e0, fs, dtype=x.dtype)
            for (a, col, _, fc, mul, bl), c in zip(terms[tb:te], coeffs[tb:te]):
                z[:, fc : fc + mul] += c * sh[rows, col : col + 1] * x[rows, a : a + mul] \
                    * ws[:, bl : bl + mul]
            out[rows, out_col : out_col + cols] = z @ W_flat[w_off : w_off + fs * cols].view(
                fs, cols)
    return out


def _emulate_rad_bwd(plan, x, sh, h, Wrs, W_flat, g, n_edges, bwd3=False, n_parts=3,
                     tile=16):
    """csrc/dtp_lin_bwd.cu's (or with ``bwd3`` csrc/dtp_lin_bwd3.cu's)
    folded loop: w built per group, dz, the term transposes into the local
    dw tile, and at the group's last component dh += dw Wr^T and (K7-B) the
    block's partial rows of dW and d[Wr; offset]; ``n_parts`` persistent
    blocks walking the tiles, their rows summed in order."""
    gk, terms, coeffs, _, wt_index, *_ = (kho.bwd3_tables(plan, torch.device("cpu")) if bwd3
                                          else plan.bwd_tables(torch.device("cpu")))
    gk, terms, coeffs = gk.tolist(), terms.tolist(), coeffs.tolist()
    cols_loc = plan.radial_cols(torch.device("cpu"))
    Wl, hd, n_loc = Wrs[:, cols_loc], plan.radial_fold, len(cols_loc)
    WT = torch.cat([W_flat, W_flat.new_zeros(1)])[wt_index]
    E_ = x.shape[0]
    dx, dsh, dh = (torch.zeros(E_, n, dtype=x.dtype) for n in (plan.d_x, plan.d_sh, hd))
    part = torch.zeros(n_parts, plan.w_numel + (hd + 1) * n_loc, dtype=x.dtype)
    for b in range(n_parts):
        for t in range(b, -(-E_ // tile), n_parts):
            e0 = t * tile
            n_live = max(0, min(tile, n_edges - e0, E_ - e0))
            if n_live == 0:
                continue
            rows = slice(e0, e0 + n_live)
            hs = h[rows]
            for fs, cols, out_col, w_off, tb, te, wt_off, cp, sb, sn, first, last in gk:
                if first:
                    ws = _tile_w(Wl, hd, hs, sb, sn)
                    dws = torch.zeros(n_live, sn, dtype=x.dtype)
                gt = torch.zeros(n_live, cp, dtype=x.dtype)
                gt[:, :cols] = g[rows, out_col : out_col + cols]
                if not bwd3:
                    z = torch.zeros(n_live, fs, dtype=x.dtype)
                    for (a, col, _, fc, mul, bl), c in zip(terms[tb:te], coeffs[tb:te]):
                        z[:, fc : fc + mul] += c * sh[rows, col : col + 1] \
                            * x[rows, a : a + mul] * ws[:, bl : bl + mul]
                    part[b, w_off : w_off + fs * cols] += (z.T @ gt[:, :cols]).reshape(-1)
                dz = gt @ WT[wt_off : wt_off + cp * fs].reshape(cp, fs)
                for (a, col, _, fc, mul, bl), c in zip(terms[tb:te], coeffs[tb:te]):
                    d = c * dz[:, fc : fc + mul]
                    xw = x[rows, a : a + mul] * ws[:, bl : bl + mul]
                    dx[rows, a : a + mul] += sh[rows, col : col + 1] * d * ws[:, bl : bl + mul]
                    dws[:, bl : bl + mul] += sh[rows, col : col + 1] * d * x[rows, a : a + mul]
                    dsh[rows, col] += (d * xw).sum(1)
                if last:
                    dh[rows] += dws @ Wl[:hd, sb : sb + sn].T
                    pr = part[b, plan.w_numel :].view(hd + 1, n_loc)
                    pr[:, sb : sb + sn] += torch.cat([hs, torch.ones_like(hs[:, :1])], 1).T @ dws
    red = part.sum(0)
    dWrs = torch.zeros(hd + 1, plan.d_w, dtype=x.dtype)
    dWrs[:, cols_loc] = red[plan.w_numel :].view(hd + 1, n_loc)
    if bwd3:
        return dx, dsh, dh
    return dx, dh, dWrs, red[: plan.w_numel]


def _kernel_inputs(case, seed=4):
    plan = _plan(HEADS[case])
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    return (plan, rnd(E, plan.d_x), rnd(E, plan.d_sh), rnd(E, HD), rnd(HD + 1, plan.d_w),
            rnd(plan.w_numel), rnd(E, plan.d_out))


@pytest.mark.parametrize("case", list(HEADS))
def test_rad_kernel_tables_drive_the_plain_math(case):
    """K7-F, K7-B and K7-B3 walk DTPLinPlan.bwd_tables with each group's w
    columns in local order; walking them in torch gives dtp_lin_rad_plain,
    dtp_lin_rad_bwd_plain and dtp_lin_rad_bwd3_plain (1e-6: the tables'
    fp32 CG coefficients)."""
    plan, x, sh, h, Wrs, W, g = _kernel_inputs(case)
    n = torch.tensor(N_REAL, dtype=torch.int32)
    assert _rel(_emulate_rad_fwd(plan, x, sh, h, Wrs, W, N_REAL),
                dtp_lin_rad_plain(plan, x, sh, h, Wrs, W, n)) < 1e-6
    for got, want in zip(_emulate_rad_bwd(plan, x, sh, h, Wrs, W, g, N_REAL),
                         dtp_lin_rad_bwd_plain(plan, x, sh, h, Wrs, W, g, n)):
        assert got.shape == want.shape and _rel(got, want) < 1e-6
    for got, want in zip(_emulate_rad_bwd(plan, x, sh, h, Wrs, W, g, N_REAL, bwd3=True),
                         dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wrs, W, g, n)):
        assert got.shape == want.shape and _rel(got, want) < 1e-6


def test_ctypes_signatures_match_the_c_entry_points():
    """Every ``extern "C"`` entry point of csrc/ has a ctypes signature in
    kernels/_build.py of the same length, pointers as c_void_p, long long
    as c_longlong and int as c_int (ctypes would pass a pointer given as an
    int cut to 32 bits)."""
    import ctypes

    found = {}
    for src in sorted(Path(_build.CSRC).glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[m.group(1)] = [a.strip() for a in m.group(2).split(",") if a.strip()]
    assert set(found) == set(_build._SIGNATURES)
    for name, args in found.items():
        want = [ctypes.c_void_p if "*" in a else ctypes.c_longlong if "long long" in a
                else ctypes.c_int for a in args]
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
