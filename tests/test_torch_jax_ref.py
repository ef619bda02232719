"""The compile policy of the JAX references that the port's tests hold it to.

``fast_jit`` is imported by every ``tests/test_torch_*.py`` file that
compiles a JAX reference; the tests here hold it to ``jax.jit`` on a small
float64 function (relative 1e-12) and check that it compiles once for each
structure of its arguments.
"""

import numpy as np
import pytest

import jax


def fast_jit(fn):
    """``jax.jit(fn)`` compiled, at its first call for each structure of
    arguments, without XLA's backend optimization passes: they take much of
    a compile and change only the rounding, far below the float64
    tolerances that the references compiled this way are held to."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, treedef = jax.tree_util.tree_flatten(args)
        key = (treedef, tuple((np.shape(a), np.result_type(a)) for a in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile({"xla_backend_optimization_level": 0})
        return compiled[key](*args)

    call.compiled = compiled
    return call


def _fn(tree, x):
    h = jax.numpy.tanh(x @ tree["w"] + tree["b"])
    return jax.numpy.sum(h * h, axis=-1), jax.grad(lambda w: jax.numpy.sum(jax.numpy.sin(x @ w)))(
        tree["w"])


@pytest.mark.parametrize("rows", [3, 7])
def test_fast_jit_equals_jit(rows):
    rng = np.random.default_rng(rows)
    tree = {"w": rng.normal(size=(5, 4)), "b": rng.normal(size=4)}
    x = rng.normal(size=(rows, 5))
    got, want = fast_jit(_fn)(tree, x), jax.jit(_fn)(tree, x)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float64
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-12, atol=1e-12)


def test_fast_jit_compiles_once_for_each_structure():
    f = fast_jit(_fn)
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(5, 4)), "b": rng.normal(size=4)}
    for rows in (3, 3, 6, 3):
        f(tree, rng.normal(size=(rows, 5)))
    assert len(f.compiled) == 2
    f(jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree),
      rng.normal(size=(3, 5)).astype(np.float32))
    assert len(f.compiled) == 3
