"""The PyTorch port's graph and data modules against the JAX package.

Edge lists (src, dst, mask) must be identical, row for row, including the
padding fill and truncation at ``max_edges``.  Float results: fp64 within
1e-12 relative, fp32 within 1e-5 relative (sums in another order).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from equiformer_tpu.data import GraphLoader as JLoader, qm9_like_dataset as j_qm9  # noqa: E402
from equiformer_tpu.graph import batching as jb, segment as js  # noqa: E402
from equiformer_tpu_torch.data import GraphLoader as TLoader, qm9_like_dataset as t_qm9  # noqa: E402
from equiformer_tpu_torch.graph import batching as tb, radius_graph as tr, segment as ts  # noqa: E402

# the JAX package's graph/__init__ re-exports a function named radius_graph
jr = importlib.import_module("equiformer_tpu.graph.radius_graph")
DTYPES = {"fp64": (np.float64, torch.float64, 1e-12), "fp32": (np.float32, torch.float32, 1e-5)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def test_synthetic_dataset_identical():
    for gj, gt in zip(j_qm9(20, seed=3), t_qm9(20, seed=3)):
        assert np.array_equal(gj["pos"], gt["pos"])
        assert np.array_equal(gj["species"], gt["species"])
        assert gj["y"] == gt["y"]


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_dense_slots_identical(shuffle):
    data = j_qm9(12, seed=0)
    jl = JLoader(data, batch_size=4, shuffle=shuffle, seed=5, dense_slots=30, use_native=False)
    tl = TLoader(data, batch_size=4, dense_slots=30, shuffle=shuffle, seed=5)
    assert len(jl) == len(tl) == 3
    for a, b in zip(jl, tl):
        assert np.array_equal(a.pos, b.pos.numpy())
        assert np.array_equal(a.species, b.species.numpy())
        assert np.array_equal(a.batch, b.batch.numpy())
        assert np.array_equal(a.node_mask, b.node_mask.numpy())
        assert np.array_equal(a.graph_mask, b.graph_mask.numpy())
        assert np.array_equal(a.y, b.y.numpy())


def test_graphs_tuple_to_recasts_floats_only():
    g = tb.collate_dense(t_qm9(2, seed=0), 30, 3)
    h = g.to("cpu", dtype=torch.float64)
    assert h.pos.dtype == torch.float64 and h.y.dtype == torch.float64
    assert h.species.dtype == torch.int64 and h.node_mask.dtype == torch.bool
    assert not bool(h.graph_mask[2])


@pytest.mark.parametrize("max_edges", [2048, 300], ids=["padded", "truncated"])
def test_radius_graph_dense_identical(max_edges):
    data = j_qm9(4, seed=1)
    b = jb.collate_dense(data, 30)
    e_j = jr.radius_graph_dense(jnp.asarray(b.pos), jnp.asarray(b.node_mask), 4, 5.0, max_edges)
    tbat = tb.collate_dense(data, 30)
    e_t = tr.radius_graph_dense(tbat.pos, tbat.node_mask, 4, 5.0, max_edges)
    assert np.array_equal(np.asarray(e_j.src), e_t.src.numpy())
    assert np.array_equal(np.asarray(e_j.dst), e_t.dst.numpy())
    assert np.array_equal(np.asarray(e_j.mask), e_t.mask.numpy())
    assert bool((e_t.dst[1:] >= e_t.dst[:-1]).all())
    if max_edges == 300:
        assert bool(e_t.mask.all())  # more real edges than capacity
    else:
        assert not bool(e_t.mask[-1])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_edge_vectors_match(dt):
    npdt, tdt, tol = DTYPES[dt]
    data = j_qm9(3, seed=2)
    b = jb.collate_dense(data, 30)
    pos = np.asarray(b.pos, npdt)
    e_j = jr.radius_graph_dense(jnp.asarray(pos), jnp.asarray(b.node_mask), 3, 5.0, 1024)
    vj, lj = jr.edge_vectors(jnp.asarray(pos), e_j)
    tbat = tb.collate_dense(data, 30).to(dtype=tdt)
    e_t = tr.radius_graph_dense(tbat.pos, tbat.node_mask, 3, 5.0, 1024)
    e_t = e_t._replace(rev=tr.reverse_edge_perm_dense(e_t, 3, 30))
    vt, lt = tr.edge_vectors(tbat.pos, e_t)
    assert _rel(vt.numpy(), vj) < tol and _rel(lt.numpy(), lj) < tol
    assert float(lt[~e_t.mask].abs().max()) == 0.0


def _segments(rng, E=300, N=40, C=130):
    dst = np.sort(rng.integers(0, N, size=E))
    mask = rng.random(E) < 0.8
    return dst, mask


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("cols", [(130,), (4, 40), (3,)], ids=["csr-2d", "csr-3d", "narrow"])
def test_segment_sum_matches(cols, dt):
    npdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(4)
    dst, mask = _segments(rng)
    x = rng.normal(size=(len(dst),) + cols).astype(npdt)
    j = np.asarray(js.segment_sum(jnp.asarray(x), jnp.asarray(dst), 40,
                                  mask=jnp.asarray(mask), sorted=True))
    t = ts.segment_sum(torch.from_numpy(x), torch.from_numpy(dst), 40,
                       mask=torch.from_numpy(mask)).numpy()
    assert t.shape == j.shape and _rel(t, j) < tol
    s = ts.scaled_scatter_sum(torch.from_numpy(x), torch.from_numpy(dst), 40, 9.0,
                              mask=torch.from_numpy(mask)).numpy()
    assert _rel(s, j / 3.0) < tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_segment_softmax_matches(dt):
    npdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(5)
    dst, mask = _segments(rng)
    s = (3.0 * rng.normal(size=(len(dst), 4))).astype(npdt)
    j = np.asarray(js.segment_softmax(jnp.asarray(s), jnp.asarray(dst), 40,
                                      mask=jnp.asarray(mask), sorted=True))
    t = ts.segment_softmax(torch.from_numpy(s), torch.from_numpy(dst), 40,
                           mask=torch.from_numpy(mask)).numpy()
    assert _rel(t, j) < tol
    assert np.all(t[~mask] == 0.0)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_segment_softmax_higher_order_shifts_per_segment(dt):
    """The force path's softmax (``higher_order=True``) shifts each segment
    by its own detached max, as JAX's does: a segment whose scores all lie
    ~900 below another segment's keeps its true softmax (a global shift
    underflows it to zeros).  Two segments {0, 1} and {-900, -899}, a masked
    entry, an empty segment; the values, the gradient of a weighted sum and
    the gradient of a weighted sum of that gradient."""
    import jax

    npdt, tdt, tol = DTYPES[dt]
    col = np.array([0.0, 1.0, -900.0, -899.0, 5.0])
    s = np.stack([col, -col], axis=1).astype(npdt)  # the 2nd column shifts the other way
    ids = np.array([0, 0, 1, 1, 1])
    mask = np.array([True, True, True, True, False])
    rng = np.random.default_rng(12)
    c, v = rng.normal(size=(2,) + s.shape).astype(npdt)

    def j_p(x):
        return js.segment_softmax(x, jnp.asarray(ids), 3, mask=jnp.asarray(mask), sorted=True,
                                  higher_order=True)

    j_f = lambda x: jnp.sum(j_p(x) * c)  # noqa: E731
    j_g1 = jax.grad(j_f)
    j_g2 = jax.grad(lambda x: jnp.sum(j_g1(x) * v))
    ts_ = torch.from_numpy(s).requires_grad_()
    p = ts.segment_softmax(ts_, torch.from_numpy(ids), 3, mask=torch.from_numpy(mask),
                           higher_order=True)
    (g1,) = torch.autograd.grad((p * torch.from_numpy(c)).sum(), ts_, create_graph=True)
    (g2,) = torch.autograd.grad((g1 * torch.from_numpy(v)).sum(), ts_)
    want = np.asarray(j_p(jnp.asarray(s)))
    np.testing.assert_allclose(want[:4, 0], [0.2689414, 0.7310586] * 2, rtol=1e-6)
    for got, ref in ((p, want), (g1, j_g1(jnp.asarray(s))), (g2, j_g2(jnp.asarray(s)))):
        assert _rel(got.detach().numpy(), ref) < tol
    assert np.all(p.detach().numpy()[~mask] == 0.0)
    # the first-order route keeps the global shift of the fused combine
    glob = ts.segment_softmax(torch.from_numpy(s), torch.from_numpy(ids), 3,
                              mask=torch.from_numpy(mask)).numpy()
    assert np.all(glob[2:4, 0] == 0.0)


def test_active_edge_bound_matches():
    for mask in (np.array([1, 1, 1, 0, 0], bool), np.array([0, 1, 0, 1, 0], bool),
                 np.zeros(5, bool)):
        j = int(js.active_edge_bound(jnp.asarray(mask)))
        t = ts.active_edge_bound(torch.from_numpy(mask))
        assert t.dtype == torch.int32 and int(t) == j


def test_reverse_edge_perm_matches_on_real_edges():
    """Equal to JAX's on real edges, and each real edge's twin is its
    reverse.  (Padded edges map to some padded slot in both packages: which
    one is left to the scatter's order.)"""
    data = j_qm9(4, seed=1)
    b = jb.collate_dense(data, 30)
    e_j = jr.radius_graph_dense(jnp.asarray(b.pos), jnp.asarray(b.node_mask), 4, 5.0, 2048)
    rev_j = np.asarray(jr.reverse_edge_perm_dense(e_j, 4, 30))
    tbat = tb.collate_dense(data, 30)
    e_t = tr.radius_graph_dense(tbat.pos, tbat.node_mask, 4, 5.0, 2048)
    rev_t = tr.reverse_edge_perm_dense(e_t, 4, 30)
    real = e_t.mask.numpy()
    assert np.array_equal(rev_t.numpy()[real], rev_j[real])
    assert bool((e_t.src[rev_t] == e_t.dst)[e_t.mask].all())
    assert bool((e_t.dst[rev_t] == e_t.src)[e_t.mask].all())
    assert bool((~e_t.mask[rev_t[~e_t.mask]]).all())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("cols", [130, 60], ids=["csr", "narrow"])
def test_gather_add_grads_match(cols, dt):
    """``xs[src] + xd[dst]`` and its rev-twin backward (segment sums over dst)
    against jax.grad of the JAX package's ``gather_add(..., rev=...)``;
    padded edges carry a zero cotangent, as the model's masks make them."""
    import jax

    npdt, tdt, tol = DTYPES[dt]
    data = j_qm9(3, seed=6)
    tbat = tb.collate_dense(data, 30)
    e_t = tr.radius_graph_dense(tbat.pos, tbat.node_mask, 3, 5.0, 1024)
    e_t = e_t._replace(rev=tr.reverse_edge_perm_dense(e_t, 3, 30))
    N = 90
    rng = np.random.default_rng(7)
    xs, xd = (rng.normal(size=(N, cols)).astype(npdt) for _ in range(2))
    g = rng.normal(size=(1024, cols)).astype(npdt) * e_t.mask.numpy()[:, None]
    src, dst, rev = (jnp.asarray(t.numpy()) for t in (e_t.src, e_t.dst, e_t.rev))

    def f(a, b):
        return jnp.sum(js.gather_add(a, b, src, dst, N, rev=rev, higher_order=False)
                       * jnp.asarray(g))

    jgs, jgd = jax.grad(f, argnums=(0, 1))(jnp.asarray(xs), jnp.asarray(xd))
    ts_, td_ = (torch.from_numpy(a).requires_grad_() for a in (xs, xd))
    out = ts.gather_add(ts_, td_, e_t.src, e_t.dst, N, rev=e_t.rev)
    assert _rel(out.detach().numpy(), xs[e_t.src.numpy()] + xd[e_t.dst.numpy()]) == 0.0
    out.backward(torch.from_numpy(g))
    assert _rel(ts_.grad.numpy(), jgs) < tol and _rel(td_.grad.numpy(), jgd) < tol


# ------------------------------------------------ linear_prims, orders 1 and 2
# take / segsum / perm against the JAX package's primitives of the same
# names on one symmetric dst-sorted edge list with a rev involution and a
# padded tail: values, gradients and the gradient of a gradient (the force
# training pattern), fp64 within 1e-12 relative.
LP_TOL = 1e-12


def _sym_edges(num_nodes=10, num_edges=64, seed=11):
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < num_edges // 2 - 4:
        i, j = rng.integers(0, num_nodes, 2)
        if i != j:
            pairs.add((min(i, j), max(i, j)))
    es = sorted([(i, j) for i, j in pairs] + [(j, i) for i, j in pairs], key=lambda e: e[1])
    pad = num_edges - len(es)
    src = np.array([e[0] for e in es] + [0] * pad, np.int64)
    dst = np.array([e[1] for e in es] + [num_nodes - 1] * pad, np.int64)
    key = {e: k for k, e in enumerate(es)}
    rev = np.arange(num_edges, dtype=np.int64)
    for k, (s, d) in enumerate(es):
        rev[k] = key[(d, s)]
    return src, dst, rev, np.arange(num_edges) < len(es)


def _both(order, j_fn, t_fn, args):
    """Gradients (order 1) or gradients of the summed squared gradients
    (order 2) of a scalar function of ``args`` in both packages."""
    import jax

    n = tuple(range(len(args)))
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    if order == 1:
        jg = jax.grad(j_fn, n)(*jargs)
        tg = torch.autograd.grad(t_fn(*targs), targs)
    else:
        jg = jax.grad(lambda *a: sum(jnp.sum(g ** 2) for g in jax.grad(j_fn, n)(*a)), n)(*jargs)
        first = torch.autograd.grad(t_fn(*targs), targs, create_graph=True)
        tg = torch.autograd.grad(sum((g ** 2).sum() for g in first), targs)
    return [np.asarray(g) for g in jg], [g.numpy() for g in tg]


def test_linear_prims_values_match_jax():
    from equiformer_tpu.graph import linear_prims as jlp

    lp = importlib.import_module("equiformer_tpu_torch.graph.linear_prims")
    src, dst, rev, _ = _sym_edges()
    rng = np.random.default_rng(12)
    x, v = rng.normal(size=(10, 7)), rng.normal(size=(64, 5))
    T = torch.from_numpy
    assert np.array_equal(lp.take_rows(T(x), T(src), T(dst), T(rev)).numpy(),
                          np.asarray(jlp.take_rows(jnp.asarray(x), jnp.asarray(src))))
    assert _rel(lp.segsum_rows(T(v), T(dst), 10).numpy(),
                np.asarray(jlp.segsum_rows(jnp.asarray(v), jnp.asarray(dst), 10, sorted=True))) \
        < LP_TOL
    assert np.array_equal(lp.permute_rows(T(v), T(rev)).numpy(),
                          np.asarray(jlp.permute_rows(jnp.asarray(v), jnp.asarray(rev))))


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("op", ["take", "segsum", "segsum-masked-wide", "perm", "gather_add",
                                "softmax"])
def test_linear_prims_grads_match_jax(op, order):
    """Orders 1 and 2 of each op and of the two compositions the model
    builds from them (the message gather with its rev twin, the composed
    segment softmax) against jax.grad through the JAX package's primitives."""
    from equiformer_tpu.graph import linear_prims as jlp

    lp = importlib.import_module("equiformer_tpu_torch.graph.linear_prims")
    src, dst, rev, mask = _sym_edges()
    jsrc, jdst, jrev, jmask = (jnp.asarray(a) for a in (src, dst, rev, mask))
    tsrc, tdst, trev, tmask = (torch.from_numpy(a) for a in (src, dst, rev, mask))
    rng = np.random.default_rng(13)
    if op == "take":
        args = [rng.normal(size=(10, 7))]
        j_fn = lambda x: jnp.sum(jnp.sin(jnp.where(  # noqa: E731
            jmask[:, None], jlp.take_rows(x, jsrc, t_ids=jdst, t_perm=jrev, t_sorted=True),
            0.0)) ** 2)
        t_fn = lambda x: (torch.sin(torch.where(  # noqa: E731
            tmask[:, None], lp.take_rows(x, tsrc, tdst, trev), torch.zeros(()).double())) ** 2
        ).sum()
    elif op in ("segsum", "segsum-masked-wide"):
        wide = op != "segsum"
        args = [rng.normal(size=(64, 130 if wide else 5))]

        def j_fn(v):
            s = jlp.segsum_rows(jnp.where(jmask[:, None], v, 0.0), jdst, 10, sorted=True)
            return jnp.sum(jnp.cos(s) * s)

        def t_fn(v):  # the wide one passes its mask to the CSR wrapper
            s = (lp.segsum_rows(v, tdst, 10, tmask) if wide else lp.segsum_rows(
                torch.where(tmask[:, None], v, torch.zeros(()).double()), tdst, 10))
            return (torch.cos(s) * s).sum()
    elif op == "perm":
        p = np.random.default_rng(14).permutation(64)
        p_inv = np.argsort(p)
        args = [rng.normal(size=(64, 5))]
        j_fn = lambda v: jnp.sum(jnp.tanh(jlp.permute_rows(  # noqa: E731
            v, jnp.asarray(p), jnp.asarray(p_inv))) * jnp.arange(5.0))
        t_fn = lambda v: (torch.tanh(lp.permute_rows(  # noqa: E731
            v, torch.from_numpy(p), torch.from_numpy(p_inv))) * torch.arange(5.0).double()).sum()
    elif op == "gather_add":
        args = [rng.normal(size=(10, 6)), rng.normal(size=(10, 6))]
        j_fn = lambda a, b: jnp.sum(jnp.tanh(jnp.where(  # noqa: E731
            jmask[:, None], js.gather_add(a, b, jsrc, jdst, 10, rev=jrev, higher_order=True),
            0.0)))
        t_fn = lambda a, b: torch.tanh(torch.where(  # noqa: E731
            tmask[:, None], ts.gather_add(a, b, tsrc, tdst, 10, rev=trev),
            torch.zeros(()).double())).sum()
    else:
        args = [rng.normal(size=(64, 4))]
        j_fn = lambda s: jnp.sum(js._segment_softmax_composed(  # noqa: E731
            s, jdst, 10, mask=jmask, sorted=True, higher_order=True)
            * jnp.arange(4.0) * jnp.cosh(s * 0.1))
        t_fn = lambda s: (ts.segment_softmax(s, tdst, 10, mask=tmask)  # noqa: E731
                          * torch.arange(4.0).double() * torch.cosh(s * 0.1)).sum()
    jg, tg = _both(order, j_fn, t_fn, args)
    # the softmaxes shift by different constants (per segment in JAX, per
    # column here), which changes only the rounding
    tol = 1e-9 if op == "softmax" else LP_TOL
    for a, b in zip(tg, jg):
        assert a.shape == b.shape and _rel(a, b) < tol


def test_second_order_wide_sums_take_the_csr_wrapper(monkeypatch):
    """At second order a wide sum is the CSR wrapper (K3 on the card) and a
    narrow one the fixed-order sum: neither the gather's nor the sum's
    double backward reaches autograd's own scatter-add."""
    lp = importlib.import_module("equiformer_tpu_torch.graph.linear_prims")
    calls = []
    for name in ("csr_segment_sum", "fixed_order_segment_sum"):
        def counting(*a, _f=getattr(lp, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(lp, name, counting)
    banned = ("index_add", "index_put", "scatter", "IndexBackward", "IndexSelectBackward")

    def walk(fn, seen):
        if fn is None or fn in seen:
            return
        seen.add(fn)
        assert not any(b.lower() in fn.name().lower() for b in banned), fn.name()
        for nxt, _ in fn.next_functions:
            walk(nxt, seen)

    src, dst, rev, mask = (torch.from_numpy(a) for a in _sym_edges())
    for cols, want in ((130, "csr_segment_sum"), (5, "fixed_order_segment_sum")):
        xs = torch.randn(10, cols, dtype=torch.float64).requires_grad_()
        v = torch.randn(64, cols, dtype=torch.float64).requires_grad_()
        out = (torch.sin(ts.gather_add(xs, xs * 2, src, dst, 10, rev=rev)).sum()
               + torch.cos(ts.segment_sum(v, dst, 10, mask=mask)).sum())
        del calls[:]
        g_xs, g_v = torch.autograd.grad(out, (xs, v), create_graph=True)
        assert calls == [want] * 2  # the two takes' backward; the sum's is a take
        second = (g_xs ** 2).sum() + (g_v ** 2).sum()
        walk(second.grad_fn, set())
        del calls[:]
        torch.autograd.grad(second, (xs, v))
        assert calls and set(calls) == {want}
