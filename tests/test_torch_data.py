"""The port's data layer against the JAX package: QM9's raw files and
cache, ``compute_stats``, the native host library, ``GraphLoader`` (native
and numpy collation, shards, the last partial batch), ``prefetch``, and
the YAML config reader against PyYAML.

Everything here is numpy or C++ in both packages, so every comparison is
exact: equal values, equal float bits (the port's integer fields are int64
where JAX's native arena writes int32).
"""

import glob
import os
import shutil

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from equiformer_tpu import native as j_native  # noqa: E402
from equiformer_tpu.data import GraphLoader as JLoader  # noqa: E402
from equiformer_tpu.data import prefetch as j_prefetch  # noqa: E402
from equiformer_tpu.data.qm9 import load_qm9 as j_load_qm9  # noqa: E402
from equiformer_tpu.data.stats import compute_stats as j_compute_stats  # noqa: E402
from equiformer_tpu.utils import config as j_config  # noqa: E402
from equiformer_tpu_torch import native  # noqa: E402
from equiformer_tpu_torch.data import GraphLoader, compute_stats, prefetch  # noqa: E402
from equiformer_tpu_torch.data import md17_like_dataset, qm9_like_dataset  # noqa: E402
from equiformer_tpu_torch.data import qm9 as t_qm9  # noqa: E402
from equiformer_tpu_torch.utils import config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yml"), recursive=True))
FIELDS = ("pos", "species", "batch", "node_mask", "graph_mask", "y", "forces")


def _same(t, j):
    """Equal values; floats also equal in dtype (so equal bits)."""
    t, j = np.asarray(t), np.asarray(j)
    if j.dtype.kind == "f":
        assert t.dtype == j.dtype
    return t.shape == j.shape and np.array_equal(t, j)


def _same_batch(tb, jb):
    for f in FIELDS:
        t, j = getattr(tb, f), getattr(jb, f)
        assert (t is None) == (j is None), f
        if t is not None:
            assert _same(t.numpy(), j), f


def _same_graphs(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert set(ga) == set(gb)
        for k in ga:
            assert _same(ga[k], gb[k]), k


# ------------------------------------------------------------ QM9

@pytest.fixture()
def qm9_roots(tmp_path):
    roots = []
    for name in ("port", "jax"):
        shutil.copytree(os.path.join(FIX, "qm9_raw"), tmp_path / name)
        roots.append(str(tmp_path / name))
    return roots


def test_load_qm9_matches_jax_and_reads_its_cache(qm9_roots):
    port_root, jax_root = qm9_roots
    for target, ref in ((1, True), (7, True), (7, False), (2, True)):
        t = t_qm9.load_qm9(port_root, "train", target, subtract_atomref=ref)
        j = j_load_qm9(jax_root, "train", target, subtract_atomref=ref)
        _same_graphs(t[0], j[0])
        assert t[1:] == j[1:]
    # 12 molecules, the 7th uncharacterized: skipped, and all 11 in train
    assert len(t[0]) == 11
    for split in ("valid", "test"):
        assert t_qm9.load_qm9(port_root, split)[0] == [] == j_load_qm9(jax_root, split)[0]
    caches = [np.load(os.path.join(r, "processed_tpu", "qm9.npz")) for r in qm9_roots]
    assert set(caches[0].files) == set(caches[1].files) == {"pos", "species", "counts", "y"}
    for k in caches[0].files:
        assert _same(caches[0][k], caches[1][k]), k
    # each package reads the other's cache (the raw files removed)
    for r in qm9_roots:
        shutil.rmtree(os.path.join(r, "raw"))
    _same_graphs(t_qm9.load_qm9(jax_root, "train", 7)[0], j_load_qm9(port_root, "train", 7)[0])


def test_load_qm9_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_qm9.load_qm9(str(tmp_path))


# ------------------------------------------------------------ stats

def _pbc_graphs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for g in qm9_like_dataset(n, seed=seed, min_atoms=4, max_atoms=9):
        g = dict(g, cell=np.diag(rng.uniform(4.0, 7.0, size=3)) + rng.normal(0, 0.3, (3, 3)))
        out.append(g)
    return out


@pytest.mark.parametrize("case", ["plain", "max_neighbors", "pbc", "pbc_max_neighbors"])
def test_compute_stats_matches_jax(case):
    graphs = _pbc_graphs(6, seed=2) if case.startswith("pbc") else qm9_like_dataset(12, seed=4)
    kw = dict(max_neighbors=6 if case.endswith("max_neighbors") else None,
              use_pbc=case.startswith("pbc"))
    got, want = compute_stats(graphs, 5.0, **kw), j_compute_stats(graphs, 5.0, **kw)
    assert got == want
    if case == "max_neighbors":
        assert got["avg_degree"] < compute_stats(graphs, 5.0)["avg_degree"]


# ------------------------------------------------------------ native

needs_native = pytest.mark.skipif(not (native.HAVE_NATIVE and j_native.HAVE_NATIVE),
                                  reason="no C++ compiler")


@needs_native
@pytest.mark.parametrize("with_forces", [False, True])
def test_native_collate_matches_jax_native(with_forces):
    graphs = md17_like_dataset(7, num_atoms=11, seed=3) if with_forces else \
        qm9_like_dataset(9, seed=5)
    idx = np.array([3, 6, 1, 4])
    tb = native.GraphArena(graphs, with_forces=with_forces).collate_dense(idx, 32)
    jb = j_native.GraphArena(graphs, with_forces=with_forces).collate_dense(idx, 32)
    _same_batch(tb, jb)
    assert tb.species.dtype == tb.batch.dtype == torch.int64
    assert tb.extras == {}


@needs_native
def test_native_collate_overflow_raises():
    graphs = qm9_like_dataset(4, seed=8, min_atoms=20, max_atoms=29)
    for arena in (native.GraphArena(graphs), j_native.GraphArena(graphs)):
        with pytest.raises(ValueError):
            arena.collate_dense(np.array([0, 1]), 8)


@needs_native
def test_native_radius_stats_match_jax_and_numpy():
    graphs = qm9_like_dataset(10, seed=7)
    got = native.GraphArena(graphs).radius_stats(5.0)
    want = j_native.GraphArena(graphs).radius_stats(5.0)
    assert np.array_equal(got.pop("edges_per_graph"), want.pop("edges_per_graph"))
    assert got == want
    ref = compute_stats(graphs, 5.0)
    assert got["avg_edges"] == pytest.approx(ref["avg_edges"], rel=1e-12)


@needs_native
@pytest.mark.parametrize("use_native", [True, False])
def test_balanced_assign_matches_jax(use_native, monkeypatch):
    monkeypatch.setattr(native, "HAVE_NATIVE", use_native)
    rng = np.random.default_rng(0)
    sizes = rng.integers(3, 30, size=41)
    for shards in (2, 3, 4):
        assert np.array_equal(native.balanced_assign(sizes, shards),
                              j_native.balanced_assign(sizes, shards))
        for caps in (np.full(shards, 41 // shards) + (np.arange(shards) < 41 % shards),
                     np.full(shards, 5)):  # the second sums below n: overflow to shard 0
            assert np.array_equal(native.balanced_assign_capped(sizes, shards, caps),
                                  j_native.balanced_assign_capped(sizes, shards, caps))


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    if not native.HAVE_NATIVE:
        pytest.skip("no C++ compiler")
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="host_ops.cpp"):
            native._lib()
    finally:
        native._lib.cache_clear()


# ------------------------------------------------------------ GraphLoader

LOADER_CASES = {
    "native": dict(dense_slots=30),
    "numpy_dense": dict(dense_slots=30, use_native=False),
    "packed": dict(),
    "native_forces_partial": dict(dense_slots=30, with_forces=True, drop_last=False),
    "numpy_partial": dict(dense_slots=30, use_native=False, drop_last=False),
    "packed_partial": dict(drop_last=False),
}


@needs_native
@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_graph_loader_matches_jax(case):
    kw = LOADER_CASES[case]
    data = (md17_like_dataset(22, num_atoms=13, seed=1) if kw.get("with_forces")
            else qm9_like_dataset(22, seed=1))
    tl, jl = GraphLoader(data, 4, seed=3, **kw), JLoader(data, 4, seed=3, **kw)
    assert len(tl) == len(jl) == (6 if kw.get("drop_last") is False else 5)
    for _ in range(2):  # two epochs: the shuffle follows the epoch count
        tbs, jbs = list(tl), list(jl)
        assert len(tbs) == len(jbs) == len(tl)
        for tb, jb in zip(tbs, jbs):
            _same_batch(tb, jb)
    last = tbs[-1].graph_mask.shape[0]
    if kw.get("drop_last") is False:
        # the arena collates the two graphs left; numpy pads to 4 slots
        assert last == (2 if "native" in case else 4)
        assert int(tbs[-1].graph_mask.sum()) == 2


@needs_native
@pytest.mark.parametrize("balance", ["atoms", None])
def test_graph_loader_shards_match_jax(balance):
    data = qm9_like_dataset(40, seed=11)
    seen = []
    for s in range(3):
        kw = dict(shuffle=True, seed=7, num_shards=3, shard_index=s, balance=balance,
                  dense_slots=30)
        tl, jl = GraphLoader(data, 4, **kw), JLoader(data, 4, **kw)
        assert len(tl) == len(jl) == 3
        for _ in range(2):
            for tb, jb in zip(list(tl), list(jl)):
                _same_batch(tb, jb)
                seen.append(tb)
    assert len(seen) == 2 * 3 * 3


def test_prefetch_keeps_order_and_raises_after_the_items():
    items = [np.full(3, i) for i in range(17)]
    for size in (1, 2, 5):
        got = list(prefetch(iter(items), size))
        assert all(np.array_equal(a, b) for a, b in zip(got, list(j_prefetch(iter(items),
                                                                              size))))
        assert len(got) == 17

    def failing():
        yield 1
        yield 2
        raise KeyError("boom")

    it = prefetch(failing())
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(KeyError, match="boom"):
        next(it)


# ------------------------------------------------------------ YAML configs

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_yaml_reader_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert config.loads(text) == yaml.safe_load(text)
    assert config.load_config(path) == j_config.load_config(path)


SNIPPETS = [
    "a: 1e-3\nb: 1.0e-3\nc: 1.0e3\nd: .5\ne: -.inf\nf: ~\ng:\nh: Yes\ni: off\nj: 1_000",
    "k: x # y\nl: a:b\nm: x#y  # comment\nn: 128x0e+64x1e\no: -12",
    "a: [1, [2, 3], [], [b, c]]\nd: [e, 1, [f, g], []]\nj: [5.0e-4, 2.0e-4,]",
    "a:\n- 1\n- two\nb:\n  - [3]\n  -\n    c: 4\n",
    "x:\n  y:\n    z: 1\n  w: 2\nv: 3\n1: one\ntrue: t\nq k: v",
    "", "# only a comment\n", "5", "[1, 2]", "plain text",
]
OUTSIDE = ["a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x", "a: 0x1F", "a: 017",
           "a: 1:30", "a: 2001-01-01", "---\na: 1", "a: b\n  c", "- a: 1", "a:\n\tb: 1",
           "? a\n: b", "a: b: c", "a: 'open", "k: 'x # y'", "l: \"q\\\"r\\t\"", "n: it's",
           "a: {b: c}", "d: [e, {f: 1}]", "'q k': v"]


@pytest.mark.parametrize("i", range(len(SNIPPETS)))
def test_yaml_reader_snippets_equal_safe_load(i):
    assert config.loads(SNIPPETS[i]) == yaml.safe_load(SNIPPETS[i])


@pytest.mark.parametrize("text", OUTSIDE)
def test_yaml_reader_raises_outside_the_subset(text):
    with pytest.raises(config.YAMLSubsetError):
        config.loads(text)


def test_overrides_and_grid_match_jax(tmp_path):
    base = os.path.join(REPO, "configs", "oc20", "is2re", "l1_256_nonlinear_aux.yml")
    overrides = ["optim.lr_initial=1.0e-4", "optim.batch_size=16", "model.name=foo",
                 "model.fc_neurons=[32, 32]", "optim.flag=true", "new.deep.key=null",
                 "model.irreps_feature=256x0e", "optim.eps=1e-8"]
    assert config.build_config(base, overrides) == j_config.build_config(base, overrides)
    with pytest.raises(config.YAMLSubsetError):
        config.build_config(base, ["x.y={a: 1}"])
    sweep = tmp_path / "sweep.yml"
    sweep.write_text("optim.lr_initial: [5.0e-4, 2.0e-4]\nmodel.alpha_drop: [0.1, 0.2, 0.0]\n")
    cfg = config.load_config(base)
    grid = config.create_grid(cfg, str(sweep))
    assert len(grid) == 6 and grid == j_config.create_grid(j_config.load_config(base),
                                                           str(sweep))
    with pytest.raises(ValueError):
        config.apply_overrides({}, ["no_equals_sign"])


@needs_native
def test_native_inputs_are_checked_before_the_library_reads_them():
    arena = native.GraphArena(qm9_like_dataset(3, seed=1))
    for bad in (np.array([0, 3]), np.array([-1]), np.zeros((1, 1), np.int64)):
        with pytest.raises(ValueError, match="graph ids"):
            arena.collate_dense(bad, 32)
    with pytest.raises(ValueError, match="one count per shard"):
        native.balanced_assign_capped(np.arange(5), 3, np.array([2, 2]))
