"""The unfused DTP route (K6) against the JAX package.

Kernel level: the port's T, R and first-order op (their plain versions, on
the CPU) against JAX's ``t_apply``, ``r_apply`` and ``make_first_order_dtp``
run in Pallas interpret mode at tile 8: the term permutations of every
transpose, results and gradients through ``jax.vjp``, shared (broadcast)
a and b, the double backward, and ``gradgradcheck``; the port's T against
JAX's lane-packed ``PackedPallasDTP``; and the device tables walked the way
the CUDA kernels walk them (``csrc/dtp_tr.cuh``), which cannot run here.

Module level: ``SeparableFCTP`` and ``EdgeDegreeEmbedding`` with
``fused_dtp_lin=False`` against JAX's modules with
``EQUIFORMER_TPU_PALLAS=1`` and ``EQUIFORMER_TPU_FUSED_DTPLIN=0`` (so JAX runs
``PallasDTP`` in interpret mode), forward and every gradient.

The slice: three ``make_qm9_steps`` of the reduced flagship on the unfused
route (with and without ``dtp_first_order_bwd``), and energies, forces and
three ``make_md17_steps`` of a reduced L3 force model on it, against JAX's
einsum route, which computes the same function: JAX's Pallas route in
interpret mode traces a kernel body per term and compiles a whole step for
tens of seconds to minutes on a CPU (130 s for one force evaluation of the
2-block L3 model, 252 s for its training step), and its T / R primitives
and modules are held to the port above.  The two routes of the port agree,
and one JAX tree loads into both.

Tolerances, relative to the largest JAX value, all in fp64: 1e-10 for the
primitives (the same products summed in another order), 1e-9 for modules
and steps.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import equiformer_tpu.nn as jnn  # noqa: E402
from equiformer_tpu.core import Irreps as JIrreps, depthwise_tp as j_dtp  # noqa: E402
from equiformer_tpu.data import qm9_like_dataset  # noqa: E402
from equiformer_tpu.graph.batching import collate_dense as j_collate  # noqa: E402
from equiformer_tpu.kernels import dtp_pallas as jdp  # noqa: E402
from equiformer_tpu.models.equiformer import GraphAttentionTransformer as JModel  # noqa: E402
from equiformer_tpu.models.md17_models import energy_and_forces as j_forces  # noqa: E402
from equiformer_tpu.train import engine as jeng, optim as jopt, state as jstate  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
import equiformer_tpu_torch.nn as tnn  # noqa: E402
from equiformer_tpu_torch.core import Irreps, depthwise_tp  # noqa: E402
from equiformer_tpu_torch.data import md17_like_dataset  # noqa: E402
from equiformer_tpu_torch.graph.batching import collate_dense as t_collate  # noqa: E402
from equiformer_tpu_torch.kernels import dtp as kd  # noqa: E402
from equiformer_tpu_torch.kernels import dtp_t_variants as kv  # noqa: E402
from equiformer_tpu_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from equiformer_tpu_torch.models import md17_models  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.tools.kbench import flagship_tp  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax, torch_name  # noqa: E402

IRR, SH = "8x0e+4x1e+2x2e", "1x0e+1x1e+1x2e"
SH3 = "1x0e+1x1e+1x2e+1x3e"
# (node irreps, SH) of the term lists: interpret mode traces a kernel body
# per term, so the comparisons with JAX's kernels take the small one
PLANS = {"small": ("4x0e+2x1e+2x2e", "1x0e+1x1e"), "l2": (IRR, SH),
         "l3": ("4x0e+4x1e+2x2e+2x3e", SH3)}
ALPHA = "6x0e"
E, TILE = 24, 8
PRIM_TOL, TOL = 1e-10, 1e-9
WALK_TOL = 1e-6  # the device tables hold float32 coefficients
PALLAS_UNFUSED = {"EQUIFORMER_TPU_PALLAS": "1", "EQUIFORMER_TPU_FUSED_DTPLIN": "0"}

if os.environ.get("PYTEST_XDIST_WORKER"):  # see tests/test_torch_md17_train.py
    torch.set_num_threads(2)


def _jterms(ts, order):
    """JAX's terms with the lane offsets (a, b, out) taken in ``order``."""
    return tuple(jdp.Term(*(((t.a_off, t.b_off, t.out_off)[i]) for i in order[:1]), t.col_off,
                          *(((t.a_off, t.b_off, t.out_off)[i]) for i in order[1:]), t.mul,
                          t.coeff) for t in ts)


# port permutation, JAX's term permutation (dtp_pallas.py:185-190, :272-286)
PERMS = {
    "base": (lambda tl: tl, lambda ts: ts),
    "perm_a": (kd.perm_a, jdp._perm_a),
    "perm_b": (kd.perm_b, jdp._perm_b),
    "perm_r_a": (kd.perm_r_a, lambda ts: _jterms(ts, (1, 2, 0))),
    "perm_r_b": (kd.perm_r_b, lambda ts: _jterms(ts, (0, 2, 1))),
    "perm_r_d": (kd.perm_r_d, lambda ts: _jterms(ts, (0, 1, 2))),
    "perm_a.perm_r_a": (lambda tl: kd.perm_a(kd.perm_r_a(tl)),
                        lambda ts: jdp._perm_a(_jterms(ts, (1, 2, 0)))),
}
SHARED = {"none": (False, False), "a": (True, False), "b": (False, True)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _tt(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _lists(plan="small", fold=True):
    """(port TermList, JAX terms) of one plan."""
    irr, sh = PLANS[plan]
    tl = kd.TermList.for_plan(depthwise_tp(Irreps(irr), Irreps(sh), Irreps(irr)), fold)
    return tl, jdp._plan_terms(j_dtp(JIrreps(irr), JIrreps(sh), JIrreps(irr)), fold)


def _dims(tl):
    return dict(d_a=tl.d_a, d_col=tl.d_col, d_b=tl.d_b, d_out=tl.d_out)


@pytest.mark.parametrize("perm", list(PERMS))
def test_term_permutations_equal_jax(perm):
    """Each permutation of the family gives JAX's term list, in JAX's order,
    and is built once (the family shares its members)."""
    port, jax_perm = PERMS[perm]
    tl, jt = _lists("l3")
    p = port(tl)
    assert p.terms == tuple(tuple(t) for t in jax_perm(jt))
    assert port(tl) is p and {m.slots for m in tl._family.values()} >= {p.slots}
    offs = {"a": p.d_a, "b": p.d_b, "out": p.d_out}
    for t in p.terms:
        assert t.a_off + t.mul <= offs["a"] and t.b_off + t.mul <= offs["b"]
        assert t.out_off + t.mul <= offs["out"] and t.col_off < p.d_col


# every permutation unshared; broadcast operands where the transposes move them
T_CASES = [(p, "none") for p in PERMS] + [("base", "a"), ("base", "b"), ("perm_a", "b"),
                                           ("perm_r_a", "a"), ("perm_r_a", "b")]


@pytest.mark.parametrize("perm,shared", T_CASES)
def test_t_and_gradients_match_t_apply(perm, shared):
    """T on a permuted list and its a / col / b gradients (T, R, T of the
    transposes) against jax.vjp of t_apply in interpret mode."""
    sa, sb = SHARED[shared]
    tl, jt = _lists()
    tl, jt = PERMS[perm][0](tl), PERMS[perm][1](jt)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(1 if sa else E, tl.d_a))
    col = rng.normal(size=(E, tl.d_col))
    b = rng.normal(size=(1 if sb else E, tl.d_b))
    ct = rng.normal(size=(E, tl.d_out))
    j_out, vjp = jax.vjp(lambda a, c, b: jdp.t_apply(
        a, c, b, terms=jt, **_dims(tl), tile=TILE, interpret=True, shared_a=sa, shared_b=sb),
        jnp.asarray(a), jnp.asarray(col), jnp.asarray(b))
    ops = [_tt(v, True) for v in (a, col, b)]
    out = kd.t_apply(tl, *ops, sa, sb)
    assert _rel(out.detach().numpy(), j_out) < PRIM_TOL
    grads = torch.autograd.grad(out, ops, _tt(ct))
    for g, jg in zip(grads, vjp(jnp.asarray(ct))):
        assert g.shape == jg.shape and _rel(g.numpy(), jg) < PRIM_TOL


@pytest.mark.parametrize("shared", list(SHARED))
@pytest.mark.parametrize("perm", ["base", "perm_a", "perm_r_a"])
def test_r_and_gradients_match_r_apply(perm, shared):
    """R and its a / b / d gradients (three T on the R permutations) against
    jax.vjp of r_apply in interpret mode."""
    sa, sb = SHARED[shared]
    tl, jt = _lists()
    tl, jt = PERMS[perm][0](tl), PERMS[perm][1](jt)
    rng = np.random.default_rng(1)
    a = rng.normal(size=(1 if sa else E, tl.d_a))
    b = rng.normal(size=(1 if sb else E, tl.d_b))
    d = rng.normal(size=(E, tl.d_out))
    ct = rng.normal(size=(E, tl.d_col))
    j_out, vjp = jax.vjp(lambda a, b, d: jdp.r_apply(
        a, b, d, terms=jt, d_a=tl.d_a, d_b=tl.d_b, d_d=tl.d_out, d_col=tl.d_col, tile=TILE,
        interpret=True, shared_a=sa, shared_b=sb), jnp.asarray(a), jnp.asarray(b), jnp.asarray(d))
    ops = [_tt(v, True) for v in (a, b, d)]
    out = kd.r_apply(tl, *ops, sa, sb)
    assert _rel(out.detach().numpy(), j_out) < PRIM_TOL
    grads = torch.autograd.grad(out, ops, _tt(ct))
    for g, jg in zip(grads, vjp(jnp.asarray(ct))):
        assert g.shape == jg.shape and _rel(g.numpy(), jg) < PRIM_TOL


@pytest.mark.parametrize("wrt", ["x", "sh"])
def test_double_backward_matches_jax(wrt):
    """Force-style grad-of-grad (the analogue of JAX's
    test_double_backward_through_kernel): the gradient of |d/d(wrt) of
    sum T(x, sh, w)^2|^2 with respect to x, sh and a shared w, through the
    port's family and through t_apply in interpret mode."""
    tl, jt = _lists()
    rng = np.random.default_rng(2)
    x, sh = rng.normal(size=(E, tl.d_a)), rng.normal(size=(E, tl.d_col))
    w = rng.normal(size=(1, tl.d_b))
    i = ("x", "sh").index(wrt)

    def j_energy(x, sh, w):
        return jnp.sum(jdp.t_apply(x, sh, w, terms=jt, **_dims(tl), tile=TILE, interpret=True,
                                   shared_b=True) ** 2)

    def j_norm(x, sh, w):
        return jnp.sum(jax.grad(j_energy, argnums=i)(x, sh, w) ** 2)

    j_grads = jax.grad(j_norm, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w))
    ops = [_tt(v, True) for v in (x, sh, w)]
    (g,) = torch.autograd.grad((kd.t_apply(tl, *ops, False, True) ** 2).sum(), ops[i],
                               create_graph=True)
    grads = torch.autograd.grad((g ** 2).sum(), ops)
    for t, j in zip(grads, j_grads):
        assert _rel(t.numpy(), j) < PRIM_TOL


@pytest.mark.parametrize("shared", list(SHARED))
def test_gradgradcheck_t_and_r(shared):
    """Second derivatives of T and R against finite differences."""
    sa, sb = SHARED[shared]
    tl = kd.TermList.for_plan(depthwise_tp(Irreps("2x0e+2x1e"), Irreps("1x0e+1x1e"),
                                           Irreps("2x0e+2x1e")), True)
    rng = np.random.default_rng(3)
    En = 3
    a = _tt(rng.normal(size=(1 if sa else En, tl.d_a)), True)
    col = _tt(rng.normal(size=(En, tl.d_col)), True)
    b = _tt(rng.normal(size=(1 if sb else En, tl.d_b)), True)
    d = _tt(rng.normal(size=(En, tl.d_out)), True)
    assert torch.autograd.gradgradcheck(lambda a, c, b: kd.t_apply(tl, a, c, b, sa, sb),
                                        (a, col, b))
    assert torch.autograd.gradgradcheck(lambda a, b, d: kd.r_apply(tl, a, b, d, sa, sb),
                                        (a, b, d))


@pytest.mark.parametrize("shared_w", [False, True])
def test_first_order_op_matches_make_first_order_dtp(shared_w):
    """T forward, one FB for dx, dsh and dw, against JAX's fused first-order
    op in interpret mode; a second derivative raises; a broadcast x gets the
    summed gradient of its rows."""
    tl, jt = _lists(fold=not shared_w)
    rng = np.random.default_rng(4)
    x, sh = rng.normal(size=(E, tl.d_a)), rng.normal(size=(E, tl.d_col))
    w = rng.normal(size=(1 if shared_w else E, tl.d_b))
    ct = rng.normal(size=(E, tl.d_out))
    jf = jdp.make_first_order_dtp(jt, tl.d_a, tl.d_col, tl.d_b, tl.d_out, TILE, True, shared_w)
    j_out, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w))
    ops = [_tt(v, True) for v in (x, sh, w)]
    out = kd.first_order_dtp(tl, *ops, False, shared_w)
    assert _rel(out.detach().numpy(), j_out) < PRIM_TOL
    grads = torch.autograd.grad(out, ops, _tt(ct), create_graph=True)
    for g, jg in zip(grads, vjp(jnp.asarray(ct))):
        assert g.shape == jg.shape and _rel(g.detach().numpy(), jg) < PRIM_TOL
    with pytest.raises(RuntimeError):
        torch.autograd.grad(grads[0].sum(), ops[2])
    x1 = _tt(x[:1], True)
    want = torch.autograd.grad(kd.t_apply(tl, x1.expand(E, -1), ops[1], ops[2], False, shared_w),
                               x1, _tt(ct))[0]
    for op in (kd.first_order_dtp, kd.t_apply):
        (g,) = torch.autograd.grad(op(tl, x1, ops[1], ops[2], True, shared_w), x1, _tt(ct))
        assert g.shape == (1, tl.d_a) and _rel(g.numpy(), want.numpy()) < PRIM_TOL


def test_t_matches_packed_pallas_dtp():
    """JAX's lane-packed kernel computes the same function as T (its
    counterpart in the port), forward and x gradient."""
    tl, _ = _lists()
    irr, sh = PLANS["small"]
    jtp = j_dtp(JIrreps(irr), JIrreps(sh), JIrreps(irr))
    rng = np.random.default_rng(5)
    x, sh = rng.normal(size=(E, tl.d_a)), rng.normal(size=(E, tl.d_col))
    w, ct = rng.normal(size=(E, tl.d_b)), rng.normal(size=(E, tl.d_out))
    k = jdp.PackedPallasDTP(jtp, tile_rows=8, interpret=True)
    j_out, vjp = jax.vjp(lambda x: k(x, jnp.asarray(sh), jnp.asarray(w)), jnp.asarray(x))
    xt = _tt(x, True)
    out = kd.t_apply(tl, xt, _tt(sh), _tt(w))
    assert _rel(out.detach().numpy(), j_out) < PRIM_TOL
    (g,) = torch.autograd.grad(out, xt, _tt(ct))
    assert _rel(g.numpy(), vjp(jnp.asarray(ct))[0]) < PRIM_TOL


def _t_lanes(item, chunk, vec):
    """The rows and first columns of the live lanes of one K6 warp item, and
    the chunk's column in its segment (csrc/dtp_tr.cuh, ``item_lane``)."""
    y = chunk[1]
    lg, lane = (y >> 8) & 7, np.arange(32)
    rows, us = (item & 255) + (lane >> lg), (lane & ((1 << lg) - 1)) * vec
    live = us < (y & 255)
    return rows[live], us[live], y >> 11


def _t_chunk(e, us, du, vec, records, t0, t1, col, a, b):
    """One warp item's lanes summing a chunk's terms: [lanes, vec] values at
    the lanes' columns u = us + 0..vec-1."""
    u = us[:, None] + np.arange(vec)
    coeffs = records[:, 3].copy().view(np.float32)
    acc = np.zeros(u.shape)
    for t in range(t0, t1):
        ao, j, bo = records[t, :3]
        acc += float(coeffs[t]) * col[e, j] * a[e, ao + du + u] * b[e, bo + du + u]
    return u, acc


def _walk_t_plan(tl, a, col, b, vec, runs):
    """T as csrc/dtp_t.cu walks ``t_plan``: a block per (32-edge tile,
    run), each warp item's lanes writing their columns; every output element
    is written exactly once."""
    chunks, records, items, run_items = (t.numpy() for t in tl.t_plan(torch.device("cpu"), vec,
                                                                        runs))
    E = col.shape[0]
    a, b = np.broadcast_to(a, (E, tl.d_a)), np.broadcast_to(b, (E, tl.d_b))
    out, hits = np.full((E, tl.d_out), np.nan), np.zeros((E, tl.d_out), int)
    assert run_items.shape == (runs + 1,) and run_items[-1] == items.shape[0]
    for e0 in range(0, E, kd.T_TILE):
        for r in range(runs):
            for it in items[run_items[r]:run_items[r + 1]]:
                o, _, t0, t1 = chunk = chunks[it >> 8]
                rows, us, du = _t_lanes(it, chunk, vec)
                keep = (rows < kd.T_TILE) & (e0 + rows < E)
                e = (e0 + rows[keep])[:, None]
                u, acc = _t_chunk(e, us[keep], du, vec, records, t0, t1, col, a, b)
                out[e, o + u] = acc
                np.add.at(hits, (e, o + u), 1)
    assert (hits == 1).all()
    return out


def _walk_staged(tl, a, col, b, vec, tile, z_slots=None):
    """T as S1-A (csrc/dtp_t_variants.cu) walks ``staged_plan``: a block per
    ``tile``-edge tile, each warp item's lanes writing their columns of the
    dense z or of its 128-column slots (chunks of no terms: the padding's
    zeros); every output element is written exactly once."""
    chunks, records, items, d_out = kv.staged_plan(tl, z_slots, torch.device("cpu"), vec, tile)
    chunks, records, items = chunks.numpy(), records.numpy(), items.numpy()
    E = col.shape[0]
    out, hits = np.full((E, d_out), np.nan), np.zeros((E, d_out), int)
    for e0 in range(0, E, tile):
        for it in items:
            o, _, t0, t1 = chunk = chunks[it >> 8]
            rows, us, du = _t_lanes(it, chunk, vec)
            keep = (rows < tile) & (e0 + rows < E)
            e = (e0 + rows[keep])[:, None]
            u, acc = _t_chunk(e, us[keep], du, vec, records, t0, t1, col, a, b)
            out[e, o + u] = acc
            np.add.at(hits, (e, o + u), 1)
    assert (hits == 1).all()
    return out


def _walk_r(tl, a, b, d, vec, tile):
    """R as csrc/dtp_r.cu walks ``r_plan`` (K6-FB's dsh part): a block per
    edge tile, each item a chunk of the b <-> out permutation over some
    rows, its lanes writing c * sum a d b of each term into the row's slot,
    then each (row, column) summing its slots; every slot a column reads is
    written exactly once, and holds a term of that column."""
    chunks, records, n_terms, n_slots, ranges, slots, items = (
        t.numpy() if isinstance(t, torch.Tensor) else t
        for t in tl.r_plan(torch.device("cpu"), vec, tile))
    E = d.shape[0]
    a, b = np.broadcast_to(a, (E, tl.d_a)), np.broadcast_to(b, (E, tl.d_b))
    coeffs = records[:, 3].copy().view(np.float32)
    assert ranges.shape == (tl.d_col, 2) and ranges[-1, 1] == len(slots)
    for j, (lo, hi) in enumerate(ranges):
        assert (records[slots[lo:hi] % n_terms, 1] == j).all()
    out = np.full((E, tl.d_col), np.nan)
    for e0 in range(0, E, tile):
        part, part_hits = np.full((tile, n_slots), np.nan), np.zeros((tile, n_slots), int)
        for it in items:
            o, _, t0, t1 = chunk = chunks[it >> 8]
            rows, us, du = _t_lanes(it, chunk, vec)
            keep = (rows < tile) & (e0 + rows < E)
            rows, us = rows[keep], us[keep]
            u = us[:, None] + np.arange(vec)
            for r in np.unique(rows):
                cols, er = u[rows == r].ravel(), e0 + r
                for t in range(t0, t1):
                    ao, _, bo = records[t, :3]
                    slot = du // (32 * vec) * n_terms + t
                    part[r, slot] = float(coeffs[t]) * np.sum(
                        a[er, ao + du + cols] * d[er, bo + du + cols] * b[er, o + cols])
                    part_hits[r, slot] += 1
        for r in range(min(tile, E - e0)):
            for j, (lo, hi) in enumerate(ranges):
                assert (part_hits[r, slots[lo:hi]] == 1).all()
                out[e0 + r, j] = part[r, slots[lo:hi]].sum()
    return out


def _walk_fb(tl, x, sh, w, g, vec, tile):
    """K6-FB as csrc/dtp_fused_bwd.cu walks ``fb_plan``: a block per edge
    tile, each item a dx or a dw chunk of some rows, a dw chunk's lanes also
    writing c * sum x g w of each term into their row's slot, then each
    (row, SH column) summing its slots; every element of dx and dw and
    every slot read is written exactly once."""
    chunks, n_dx, dxt, dwt, n_dwt, n_slots, ranges, slots, items = (
        t.numpy() if isinstance(t, torch.Tensor) else t
        for t in tl.fb_plan(torch.device("cpu"), vec, tile))
    E = g.shape[0]
    x, w = np.broadcast_to(x, (E, tl.d_a)), np.broadcast_to(w, (E, tl.d_b))
    outs = {k: np.full((E, d), np.nan) for k, d in (("dx", tl.d_a), ("dw", tl.d_b),
                                                    ("dsh", tl.d_col))}
    hits = {k: np.zeros(v.shape, int) for k, v in outs.items() if k != "dsh"}
    coeffs = dwt[:, 3].copy().view(np.float32)
    for e0 in range(0, E, tile):
        part, part_hits = np.full((tile, n_slots), np.nan), np.zeros((tile, n_slots), int)
        for it in items:
            o, _, t0, t1 = chunk = chunks[it >> 8]
            rows, us, du = _t_lanes(it, chunk, vec)
            keep = (rows < tile) & (e0 + rows < E)
            rows, e = rows[keep], (e0 + rows[keep])[:, None]
            key, rec, a, b = ("dx", dxt, g, w) if it >> 8 < n_dx else ("dw", dwt, x, g)
            u, acc = _t_chunk(e, us[keep], du, vec, rec, t0, t1, sh, a, b)
            outs[key][e, o + u] = acc
            np.add.at(hits[key], (e, o + u), 1)
            if key == "dw":
                for r in np.unique(rows):
                    cols, er = u[rows == r].ravel(), e0 + r
                    for t in range(t0, t1):
                        ao, _, bo = dwt[t, :3]
                        slot = du // (32 * vec) * n_dwt + t
                        part[r, slot] = float(coeffs[t]) * np.sum(
                            x[er, ao + du + cols] * g[er, bo + du + cols] * w[er, o + cols])
                        part_hits[r, slot] += 1
        for r in range(min(tile, E - e0)):
            for j, (lo, hi) in enumerate(ranges):
                assert (part_hits[r, slots[lo:hi]] == 1).all()
                outs["dsh"][e0 + r, j] = part[r, slots[lo:hi]].sum()
    assert all((h == 1).all() for h in hits.values())
    return outs["dx"], outs["dsh"], outs["dw"]


@pytest.mark.parametrize("perm", list(PERMS))
def test_tables_drive_the_plain_math(perm):
    """S1-A's plan (K6-T's chunks over a staged tile) and K6-T's plan
    (chunks, items, runs), and K6-R's plan (K6-FB's dsh part), walked as the
    kernels walk them, give the plain versions' results (within the tables'
    float32 coefficients); so does K6-FB's plan (dx: the a <-> out
    permutation's chunks with a = g, dw: the b <-> out one's with b = g,
    dsh: the dw chunks' slots), at tiles of 8 and 3 edges, with 40 edges (a
    partial last tile) and a broadcast b."""
    tl = PERMS[perm][0](_lists("l3")[0])
    rng = np.random.default_rng(6)
    a, col = rng.normal(size=(40, tl.d_a)), rng.normal(size=(40, tl.d_col))
    b, d = rng.normal(size=(1, tl.d_b)), rng.normal(size=(40, tl.d_out))
    t = kd.dtp_t_plain(tl, _tt(a), _tt(col), _tt(b)).numpy()
    assert _rel(_walk_staged(tl, a, col, np.broadcast_to(b, (40, tl.d_b)), 1, 3), t) < WALK_TOL
    for runs in (1, 2, 4):
        assert _rel(_walk_t_plan(tl, a, col, b, 1, runs), t) < WALK_TOL
    want = [v.numpy() for v in kd.dtp_fused_bwd_plain(tl, _tt(a), _tt(col), _tt(b), _tt(d))]
    for tile in (8, 3):
        assert _rel(_walk_r(tl, a, b, d, 1, tile),
                    kd.dtp_r_plain(tl, _tt(a), _tt(b), _tt(d)).numpy()) < WALK_TOL
        for got, ref in zip(_walk_fb(tl, a, col, b, d, 1, tile), want):
            assert _rel(got, ref) < WALK_TOL


@pytest.mark.parametrize("perm", list(PERMS))
def test_r_plan_is_k6fb_dsh_part(perm):
    """K6-R's plan is K6-FB's dsh part: the b <-> out permutation's chunks
    and term records, K6-FB's slots and column lists, and its dw items in
    K6-FB's order; walked over 3-edge tiles (a partial last one) with a
    broadcast a or b, in lanes of 4 columns and of 1 (tiles of 64 and 36
    columns cut into pieces of 32: a term's slot a piece), it gives
    ``dtp_r_plain``."""
    irr = Irreps("64x0e+36x1e")
    tl = PERMS[perm][0](kd.TermList.for_plan(depthwise_tp(irr, Irreps("1x0e+1x1e"), irr), True))
    assert tl.vec4()
    for vec, tile in ((4, 3), (4, 8), (1, 3)):
        chunks, n_dx, _, dwt, n_dwt, n_slots, ranges, slots, items = tl.fb_plan(
            torch.device("cpu"), vec, tile)
        r = tl.r_plan(torch.device("cpu"), vec, tile)
        assert torch.equal(r[0], chunks[n_dx:]) and torch.equal(r[1], dwt)
        assert (r[2], r[3]) == (n_dwt, n_slots) and n_slots == (1 if vec == 4 else 2) * n_dwt
        assert torch.equal(r[4], ranges) and torch.equal(r[5], slots)
        assert torch.equal(r[6], items[items >> 8 >= n_dx] - (n_dx << 8))
    rng = np.random.default_rng(9)
    for shared_a, shared_b in ((True, False), (False, True)):
        a = rng.normal(size=(1 if shared_a else 40, tl.d_a))
        b = rng.normal(size=(1 if shared_b else 40, tl.d_b))
        d = rng.normal(size=(40, tl.d_out))
        want = kd.dtp_r_plain(tl, _tt(a), _tt(b), _tt(d)).numpy()
        for vec in (4, 1):
            assert _rel(_walk_r(tl, a, b, d, vec, 3), want) < WALK_TOL


@pytest.mark.parametrize("layout", ["dense", "slots"])
def test_staged_plan_drives_the_plain_math(layout):
    """S1-A's plan at kbench's widths (the flagship's sep_act DTP, d_a 480,
    d_col 9, z 3136 dense or 128-column slots), walked in lanes of 4 columns
    over the tile the wrapper picks in fp32 and bf16 with 9 edges (a
    partial last tile), gives ``dtp_t_staged_plain``: every element
    written once, the slots' padding zero; the dense chunks are K6-T's."""
    tp = flagship_tp()
    tl = kd.TermList.for_plan(tp, True)
    z_slots = kv.make_layouts(tp)[4] if layout == "slots" else None
    rng = np.random.default_rng(10)
    a, col, b = (rng.normal(size=(9, n)) for n in (tl.d_a, tl.d_col, tl.d_b))
    want = kv.dtp_t_staged_plain(tl, _tt(a), _tt(col), _tt(b), z_slots).numpy()
    tiles = {kv.staged_tile(tl, size) for size in (4, 2)}
    assert tiles == {2, 4} and all(
        kv._staged_bytes(kv.staged_tile(tl, size), size, tl) <= kv.STAGED_SMEM for size in (4, 2))
    for tile in sorted(tiles):
        got = _walk_staged(tl, a, col, b, 4, tile, z_slots)
        assert got.shape == want.shape and _rel(got, want) < WALK_TOL
        if z_slots is not None:
            pad = np.ones(got.shape, bool)
            for slot, mul in z_slots.values():
                pad[:, slot:slot + mul] = False
            assert (got[pad] == 0).all()
    if z_slots is None:
        chunks = kv.staged_plan(tl, None, torch.device("cpu"), 4, 4)[0]
        assert chunks.tolist() == [list(c) for c in tl.chunks(4)[0]]


FULL_WIDTH = {"qm9": ("128x0e+64x1e+32x2e", "1x0e+1x1e+1x2e", 36352),
              "l3": ("128x0e+64x1e+64x2e+32x3e", SH3, 2944)}


@pytest.mark.parametrize("plan", list(FULL_WIDTH))
def test_full_width_tables_fit_the_kernels(plan):
    """At the model widths every family member's tables fit the launches:
    segments that cover the output once, SH columns within the kernels'
    shared col tile, output tiles that never overlap; K6's lanes own 4
    columns; K6-T's chunks keep their segment's terms in table order and
    fit the records' fields, its runs fill the card at both models' edge
    counts; K6-FB's tile keeps five blocks an SM in both dtypes, with g
    staged at QM9."""
    irr, sh, E = FULL_WIDTH[plan]
    tl = kd.TermList.for_plan(depthwise_tp(Irreps(irr), Irreps(sh), Irreps(irr)), True)
    assert tl.vec4()
    for name in ("base", "perm_a", "perm_b", "perm_r_a", "perm_a.perm_r_a"):
        m = PERMS[name][0](tl)
        order, seg_list = m._segments()
        assert 1 <= len(seg_list) and sum(s[1] for s in seg_list) == m.d_out
        for vec in (4, 1):
            chunks, records, _ = m.chunks(vec)
            assert len(chunks) < 1 << 20 and [tuple(r[:3]) for r in records] == [
                (m.terms[i].a_off, m.terms[i].col_off, m.terms[i].b_off) for i in order]
            for o, y, t0, t1 in chunks:
                width, lg, du = y & 255, (y >> 8) & 7, y >> 11
                assert width <= 32 * vec and lg <= 5 and (1 << lg) * vec >= width
                seg = next(s for s in seg_list if s[0] <= o < s[0] + s[1])
                assert (seg[0] + du, seg[2], seg[3]) == (o, t0, t1)
                assert all(m.terms[order[t]].out_off == seg[0] for t in range(t0, t1))
                assert order[t0:t1] == sorted(order[t0:t1])
        runs = m.t_runs(E, 4)
        assert runs <= 16 and (-(-E // kd.T_TILE) * runs >= kd.T_BLOCKS
                               or runs == min(16, len(m.chunks(4)[0])))
    n_slots = tl.fb_plan(torch.device("cpu"), 4, 1)[5]
    assert n_slots == len(tl.terms)  # one chunk a segment: a slot a term
    for size in (4, 2):
        for sx, sw in SHARED.values():
            tile, stage_g = tl.fb_tile(size, sx, sw, 4)
            assert stage_g == (plan == "qm9") and tile >= 2 and kd._fb_bytes(
                tile, size, sx, sw, stage_g, tl.d_a, tl.d_b, tl.d_out, tl.d_col,
                n_slots) <= kd.FB_SMEM
    assert tl.d_col <= 64 and len(tl._family) <= 6


@pytest.mark.parametrize("plan", list(FULL_WIDTH))
def test_full_width_k6_plans_drive_the_plain_math(plan):
    """K6-T's plans (lanes of 4 columns; the runs both models' edge counts
    give) and K6-FB's (its tiles in both dtypes), walked at the model
    widths over 37 edges (partial tiles), give the plain versions'
    results, every output element written once."""
    irr, sh, _ = FULL_WIDTH[plan]
    tl = kd.TermList.for_plan(depthwise_tp(Irreps(irr), Irreps(sh), Irreps(irr)), True)
    rng = np.random.default_rng(7)
    x, sh_, w, g = (rng.normal(size=(37, n)) for n in (tl.d_a, tl.d_col, tl.d_b, tl.d_out))
    runs = sorted({tl.t_runs(E, 4) for _, _, E in FULL_WIDTH.values()})
    for m, (a, b) in ((tl, (x, w)), (kd.perm_a(tl), (g, w)), (kd.perm_b(tl), (x, g))):
        want = kd.dtp_t_plain(m, _tt(a), _tt(sh_), _tt(b)).numpy()
        for r in runs:
            assert _rel(_walk_t_plan(m, a, sh_, b, 4, r), want) < WALK_TOL
    want = [v.numpy() for v in kd.dtp_fused_bwd_plain(tl, _tt(x), _tt(sh_), _tt(w), _tt(g))]
    for tile in sorted({tl.fb_tile(size, False, False, 4)[0] for size in (4, 2)}):
        for got, ref in zip(_walk_fb(tl, x, sh_, w, g, 4, tile), want):
            assert _rel(got, ref) < WALK_TOL


@pytest.mark.parametrize("plan", list(FULL_WIDTH))
def test_full_width_r_plans_drive_the_plain_math(plan):
    """K6-R's plan on every family member at the model widths, walked over
    37 edges (partial tiles) with the tile the wrapper picks in fp32 and
    bf16 at the model's edge count and at 37 edges, gives ``dtp_r_plain``;
    the tile's block (a rows and slots: b and d are read through L1 / L2)
    fits FB_SMEM on every member, also where a is z (one z row is 37.6 KB
    fp32 at MD17 L3), and the force pass's own list (a = x) fills the card
    with R_BLOCKS blocks at the model's edge count."""
    irr, sh, E = FULL_WIDTH[plan]
    tl = kd.TermList.for_plan(depthwise_tp(Irreps(irr), Irreps(sh), Irreps(irr)), True)
    rng = np.random.default_rng(11)
    for name in PERMS:
        m = PERMS[name][0](tl)
        a, b, d = (rng.normal(size=(37, n)) for n in (m.d_a, m.d_b, m.d_out))
        n_slots = m.r_plan(torch.device("cpu"), 4, 1)[3]
        assert n_slots == len(m.terms)  # one chunk a segment: a slot a term
        want = kd.dtp_r_plain(m, _tt(a), _tt(b), _tt(d)).numpy()
        tiles = set()
        for size in (4, 2):
            for edges in (E, 37):
                for sa in (False, True):
                    tile = m.r_tile(edges, size, sa, 4)
                    assert kd._fb_bytes(tile, size, sa, False, False, m.d_a, 0, m.d_out, 0,
                                        n_slots) <= kd.FB_SMEM, (name, size, tile)
                    tiles.add(tile)
            if m.slots == (0, 1, 2):
                assert -(-E // m.r_tile(E, size, False, 4)) >= kd.R_BLOCKS
        for tile in sorted(tiles):
            assert _rel(_walk_r(m, a, b, d, 4, tile), want) < WALK_TOL, (name, tile)


# ------------------------------------------------------------------ modules
def _noisy_init(jm, args, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64) + 0.1 * rng.normal(
        size=a.shape), jm.init(jax.random.PRNGKey(seed), *args))


def _jax_grads(tree):
    """{port name: gradient in the port's layout} of a flax gradient tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    out = {}
    for path, g in flat:
        name = torch_name(tuple(k.key for k in path))
        g = np.asarray(g)
        out[name] = g.T if name.endswith(".weight") and g.ndim == 2 else g
    return out


def _compare(jm, tm, tree, args, n_inputs):
    """Forward outputs, input gradients and parameter gradients for one
    random cotangent per output: port against jax.vjp."""
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    j_outs, vjp = jax.vjp(lambda p, *x: jm.apply(p, *x, *jargs[n_inputs:]), tree,
                          *jargs[:n_inputs])
    rng = np.random.default_rng(9)
    cts = [rng.normal(size=o.shape) for o in j_outs]
    j_grads = vjp(tuple(jnp.asarray(c) for c in cts))
    inputs = [_tt(a, True) for a in args[:n_inputs]]
    rest = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args[n_inputs:]]
    outs = tm(*inputs, *rest)
    params = dict(tm.named_parameters())
    for o, jo in zip(outs, j_outs):
        assert _rel(o.detach().numpy(), jo) < TOL
    loss = sum((o * _tt(c)).sum() for o, c in zip(outs, cts))
    grads = torch.autograd.grad(loss, inputs + list(params.values()))
    for g, jg in zip(grads[:n_inputs], j_grads[1:]):
        assert _rel(g.numpy(), jg) < TOL
    want = _jax_grads(j_grads[0])
    assert set(want) == set(params)
    for n, g in zip(params, grads[n_inputs:]):
        assert _rel(g.numpy(), want[n]) < TOL, n


class _JSep(fnn.Module):
    """JAX SeparableFCTP with its attention-style second head."""

    internal: bool
    ho: bool

    def setup(self):
        kw = (dict(fc_neurons=None, use_activation=False, internal_weights=True)
              if self.internal else
              dict(fc_neurons=(16, 8), use_activation=True, internal_weights=False,
                   extra_head_irreps=(JIrreps(ALPHA),)))
        self.sep = jnn.SeparableFCTP(JIrreps(IRR), JIrreps(SH), JIrreps(IRR),
                                     higher_order_grads=self.ho, **kw)
        if not self.internal:
            self.alpha = jnn.IrrepsLinear(j_dtp(JIrreps(IRR), JIrreps(SH), JIrreps(IRR)).irreps_out,
                                          JIrreps(ALPHA))

    def __call__(self, x, sh, rbf):
        if self.internal:
            return (self.sep(x, sh),)
        return tuple(self.sep.dtp_lin(x, sh, self.sep.dtp_weights(rbf),
                                      extra_heads=(self.alpha,)))


class _TSep(torch.nn.Module):
    def __init__(self, internal, ho, first_order):
        super().__init__()
        self.internal = internal
        kw = (dict(internal_weights=True) if internal else
              dict(fc_neurons=(16, 8), use_activation=True, extra_head_irreps=(ALPHA,)))
        self.sep = tnn.SeparableFCTP(IRR, SH, IRR, higher_order_grads=ho, fused_dtp_lin=False,
                                     dtp_first_order_bwd=first_order, **kw)
        if not internal:
            self.alpha = tnn.IrrepsLinear(self.sep.dtp.irreps_out, ALPHA)

    def forward(self, x, sh, rbf):
        if self.internal:
            return (self.sep(x, sh),)
        return self.sep.dtp_lin(x, sh, self.sep.dtp_rad(rbf), extra_heads=(self.alpha,))


SEP_CASES = {  # internal weights, higher_order_grads, first-order backward
    "two-head": (False, True, False),
    "two-head-first-order": (False, False, True),
    "shared-w": (True, False, False),
    "shared-w-first-order": (True, False, True),
}


@pytest.mark.parametrize("case", list(SEP_CASES))
def test_separable_fctp_unfused_matches_pallas_dtp(case, monkeypatch):
    """SeparableFCTP on the unfused route (two heads with per-edge radial
    weights, or shared internal weights) against JAX's with PallasDTP in
    interpret mode: forward, and the gradients of x, sh, the radial input
    and every parameter."""
    internal, ho, first_order = SEP_CASES[case]
    for k, v in PALLAS_UNFUSED.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("EQUIFORMER_TPU_FUSED_BWD", "1" if first_order else "0")
    rng = np.random.default_rng(7)
    Es = 12
    args = (rng.normal(size=(Es, Irreps(IRR).dim)), rng.normal(size=(Es, 9)),
            rng.normal(size=(Es, 16)))
    jm = _JSep(internal, ho)
    tree = _noisy_init(jm, [jnp.asarray(a) for a in args])
    tm = _TSep(internal, ho, first_order).double()
    assert tm.sep.fused_op is None and tm.sep.dtp.first_order_bwd == first_order
    _compare(jm, tm, tree, args, 2 if internal else 3)


@pytest.mark.parametrize("ho", [True, False], ids=["higher-order", "first-order"])
def test_edge_degree_embedding_unfused_matches_pallas_dtp(ho, monkeypatch):
    """EdgeDegreeEmbedding on the unfused route (its constant feature a
    broadcast row of T) against JAX's with PallasDTP in interpret mode:
    forward and the gradients of sh, the radial input and every parameter."""
    for k, v in PALLAS_UNFUSED.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(8)
    N, Es = 10, 24
    sh, rbf = rng.normal(size=(Es, 9)), rng.normal(size=(Es, 16))
    dst = np.sort(rng.integers(0, N, size=Es))
    src = rng.integers(0, N, size=Es)
    mask = np.arange(Es) < 20
    class J(fnn.Module):
        def setup(self):
            self.e = jnn.EdgeDegreeEmbedding(JIrreps(IRR), JIrreps(SH), (16, 8), 3.0,
                                             higher_order_grads=ho)

        def __call__(self, sh, rbf, src, dst, mask):
            return (self.e(sh, rbf, src, dst, mask, N),)

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.e = tnn.EdgeDegreeEmbedding(IRR, SH, (16, 8), 3.0, higher_order_grads=ho,
                                             fused_dtp_lin=False)

        def forward(self, sh, rbf, src, dst, mask):
            return (self.e(sh, rbf, dst, mask, N),)

    jm = J()
    jargs = (sh, rbf, src, dst, mask)
    tree = _noisy_init(jm, [jnp.asarray(a) for a in jargs])
    _compare(jm, T().double(), tree, jargs, 2)


# -------------------------------------------------------------------- slice
QM9_REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+4x2e", num_layers=2, number_of_basis=32,
    fc_neurons=(16, 16), irreps_feature="32x0e", irreps_head="8x0e+4x1e+4x2e",
    num_heads=4, irreps_mlp_mid="24x0e+12x1e+6x2e", max_edges=512, nodes_per_graph=30,
    alpha_drop=0.0,
)
L3_REDUCED = dict(
    irreps_node_embedding="16x0e+8x1e+8x2e+4x3e", num_layers=1, irreps_sh=SH3,
    number_of_basis=32, basis_type="exp", fc_neurons=(16, 16), irreps_feature="32x0e",
    irreps_head="8x0e+4x1e+4x2e+2x3e", num_heads=4, irreps_mlp_mid="24x0e+12x1e+12x2e+6x3e",
    alpha_drop=0.0, max_atom_type=64, avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
    avg_degree=md17_models._AVG_DEGREE_MD17, max_edges=1536, nodes_per_graph=21,
)
LR, WARMUP, TOTAL, EMA = 2e-2, 2, 6, 0.5
STEPS = 3


def _jcfg(cfg):
    return {k: JIrreps(v) if k.startswith("irreps") else v for k, v in cfg.items()}


def _port_leaves(named):
    return {n: t.detach().numpy().copy() for n, t in named.items()}


def _check_steps(jmet, jst, tmet, tst, keys):
    for i in range(STEPS):
        for k in keys:
            assert _rel(tmet[i][k], jmet[i][k]) < TOL, (i, k)
    want_p, want_e = _jax_grads(jst.params), _jax_grads(jst.ema_params)
    got_p, got_e = _port_leaves(tst.params), _port_leaves(tst.ema)
    assert set(got_p) == set(want_p)
    scale = max(np.abs(v).max() for v in want_p.values())
    for got, want in ((got_p, want_p), (got_e, want_e)):
        assert max(np.abs(got[n] - want[n]).max() for n in got) < TOL * scale


@pytest.fixture(scope="module")
def qm9():
    """JAX's three make_qm9_steps of the reduced flagship (fp64, from its own
    init), its init tree and the port's batch."""
    data = qm9_like_dataset(4, seed=0)
    jb = j_collate(data, 30)
    jb = dataclasses.replace(jb, pos=np.asarray(jb.pos, np.float64), y=np.asarray(jb.y, np.float64))
    jm = JModel(**_jcfg(QM9_REDUCED), nonlinear_message=True, higher_order_grads=False)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(0), b, deterministic=True))(jb))
    jopt_ = jopt.create_optimizer(jopt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=5e-3)
    j_step = jax.jit(jeng.make_qm9_steps(jm, jopt_, task_mean=0.3, task_std=1.7,
                                         ema_decay=EMA)[0])
    jst, jmet = jstate.TrainState.create(tree, jopt_), []
    for i in range(STEPS):
        jst, m = j_step(jst, jb, jax.random.PRNGKey(i))
        jmet.append({k: float(v) for k, v in m.items()})
    return tree, jst, jmet, t_collate(data, 30).to(dtype=torch.float64)


@pytest.mark.parametrize("first_order", [False, True], ids=["t-r", "fused-bwd"])
def test_qm9_training_steps_unfused_match_jax(first_order, qm9):
    """Three make_qm9_steps of the reduced flagship on the unfused route
    (with dtp_first_order_bwd: each DTP's backward one FB) against JAX's
    steps, fp64, from JAX's own init."""
    tree, jst, jmet, tb = qm9
    tm = TModel(**QM9_REDUCED, higher_order_grads=False, fused_dtp_lin=False,
                dtp_first_order_bwd=first_order).double()
    params_from_jax(tm, tree)
    topt = pt.create_optimizer(pt.cosine_warmup_schedule(LR, WARMUP, TOTAL), weight_decay=5e-3)
    t_step, _ = pt.make_qm9_steps(tm, topt, task_mean=0.3, task_std=1.7, ema_decay=EMA)
    tst, tmet = pt.TrainState.create(tm, topt), []
    reset_launch_counts()
    for _ in range(STEPS):
        tst, m = t_step(tst, tb, None)
        tmet.append({k: float(v) for k, v in m.items()})
    assert set(launch_counts().values()) == {0}  # CPU tensors: the plain versions
    _check_steps(jmet, jst, tmet, tst, ("loss", "mae", "grad_norm"))


@pytest.fixture(scope="module")
def l3():
    """The reduced L3 force model's JAX module, its init tree (fp64) and
    the md17-like batch."""
    jm = JModel(**_jcfg(L3_REDUCED), nonlinear_message=True, higher_order_grads=True)
    data = md17_like_dataset(4, seed=0)
    jb = j_collate(data, 21, with_forces=True)
    jb = dataclasses.replace(jb, pos=np.asarray(jb.pos, np.float64), y=np.asarray(jb.y, np.float64),
                             forces=np.asarray(jb.forces, np.float64))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(1), b, deterministic=True))(jb))
    tb = t_collate(data, 21, with_forces=True).to(dtype=torch.float64)
    return jm, tree, jb, tb


def _l3_port(tree, fused=False):
    tm = TModel(**L3_REDUCED, fused_dtp_lin=fused).double()
    assert params_from_jax(tm, tree) == len(jax.tree_util.tree_leaves(tree))
    return tm


def test_md17_energies_and_forces_unfused_match_jax(l3):
    """Energies and forces (the T / R family differentiated once) of the
    reduced L3 force model on the unfused route against JAX's, fp64."""
    jm, tree, jb, tb = l3
    je, jf = jax.jit(lambda p, b: j_forces(jm, p, b))(tree, jb)
    e, f = pt.energy_and_forces(_l3_port(tree), tb)
    assert _rel(e.numpy(), je) < TOL and _rel(f.numpy(), jf) < TOL


def test_md17_training_steps_unfused_match_jax(l3):
    """Three make_md17_steps (the grad-of-grad through T and R) of the
    reduced L3 force model on the unfused route against JAX's, fp64."""
    jm, tree, jb, tb = l3
    opt = jopt.create_optimizer(jopt.cosine_warmup_schedule(2e-3, WARMUP, TOTAL), weight_decay=1e-6)
    j_step = jax.jit(jeng.make_md17_steps(jm, opt, task_mean=0.5, task_std=2.0, energy_weight=1.0,
                                          force_weight=80.0, ema_decay=EMA)[0])
    jst, jmet = jstate.TrainState.create(tree, opt), []
    for i in range(STEPS):
        jst, m = j_step(jst, jb, jax.random.PRNGKey(i))
        jmet.append({k: float(v) for k, v in m.items()})
    tm = _l3_port(tree)
    topt = pt.create_optimizer(pt.cosine_warmup_schedule(2e-3, WARMUP, TOTAL), weight_decay=1e-6)
    t_step, _ = pt.make_md17_steps(tm, topt, task_mean=0.5, task_std=2.0, energy_weight=1.0,
                                   force_weight=80.0, ema_decay=EMA)
    tst, tmet = pt.TrainState.create(tm, topt), []
    for _ in range(STEPS):
        tst, m = t_step(tst, tb)
        tmet.append({k: float(v) for k, v in m.items()})
    _check_steps(jmet, jst, tmet, tst, ("loss", "loss_e", "loss_f", "mae_e", "mae_f", "grad_norm"))


def test_routes_agree_and_load_one_jax_tree(l3):
    """One JAX tree loads into the fused and the unfused model (the switch
    does not change the parameters), and both give the same energies,
    forces and training loss gradient (fp64, 1e-12: the same function)."""
    _, tree, _, tb = l3
    models = [_l3_port(tree, fused) for fused in (True, False)]
    assert [n for n, _ in models[0].named_parameters()] == \
        [n for n, _ in models[1].named_parameters()]
    res = []
    for tm in models:
        e, f = pt.energy_and_forces(tm.train(), tb, create_graph=True)
        loss = e.square().sum() + 80.0 * f.square().sum()
        res.append([e, f] + list(torch.autograd.grad(loss, list(tm.parameters()))))
    for a, b in zip(*res):
        assert _rel(a.detach().numpy(), b.detach().numpy()) < 1e-12
    seeded = [TModel(**L3_REDUCED, fused_dtp_lin=fused, seed=5) for fused in (True, False)]
    for (n, p), (_, q) in zip(*(m.named_parameters() for m in seeded)):
        assert torch.equal(p, q), n


def _count_calls(monkeypatch):
    """Record each T / R call of the family (its term list's slots and the
    row counts of its lane operands)."""
    calls = {"t": [], "r": []}
    t0, r0 = kd.dtp_t, kd.dtp_r

    def t(tl, a, col, b):
        calls["t"].append((tl.slots, a.shape[0], b.shape[0]))
        return t0(tl, a, col, b)

    def r(tl, a, b, d):
        calls["r"].append((tl.slots, a.shape[0], b.shape[0]))
        return r0(tl, a, b, d)

    monkeypatch.setattr(kd, "dtp_t", t)
    monkeypatch.setattr(kd, "dtp_r", r)
    return calls


def test_training_passes_skip_the_legs_nobody_reads(l3, monkeypatch):
    """make_md17_steps' force pass computes no gradient of the broadcast
    operands (sep_value's shared weight, the edge-degree embedding's
    constant feature: functions of the parameters alone, one T each), and
    its parameter pass runs no R.  Without the skips both would run."""
    _, tree, _, tb = l3
    calls = _count_calls(monkeypatch)
    tm = _l3_port(tree).train()
    sites = 1 + 2 * tm.num_layers  # the edge degree, sep_act and sep_value per block
    e, f = pt.energy_and_forces(tm, tb, create_graph=True)
    # a forward T per site; the force pass an R per site and the x and w
    # legs of each site but the broadcast ones (1 + num_layers)
    assert len(calls["r"]) == sites
    assert len(calls["t"]) == 3 * sites - (1 + tm.num_layers)
    calls["t"].clear()
    with kd.skip_leg_grads("sh"):
        torch.autograd.grad(e.square().sum() + f.square().sum(), list(tm.parameters()))
    assert len(calls["r"]) == sites and len(calls["t"]) > 0

    # the same two passes without the skips
    calls["t"].clear()
    pos = tb.pos.detach().requires_grad_(True)
    energy = tm(dataclasses.replace(tb, pos=pos))
    (g,) = torch.autograd.grad(energy.sum(), pos, create_graph=True)
    assert len(calls["t"]) == 3 * sites
    torch.autograd.grad(g.square().sum() + energy.square().sum(), list(tm.parameters()))
    assert len(calls["r"]) > 2 * sites
