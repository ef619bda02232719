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
