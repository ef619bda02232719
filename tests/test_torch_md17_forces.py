"""The ported MD17 energies and forces against the JAX package's, on the
reduced force model of ``tests/test_torch_md17.py`` (its weights, batches,
references and tolerances, imported from there): fp64 and fp32 on the exp
and the bessel basis, and bf16.  The JAX references' compiles take most of
the time, so these cases run in a file of their own, on another worker.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from equiformer_tpu.models.md17_models import energy_and_forces as j_energy_and_forces  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.utils import params_from_jax  # noqa: E402
from test_torch_md17 import (  # noqa: E402
    BF16_FACTOR, BF16_MIN_SHIFT, DTYPES, GRAPHS, REDUCED, SLOTS, _cast, _close, _jax_batch,
    _jax_ref, _reduced, _rel, _torch_batch,
)


def _port_ef(tm, data, tdt):
    return pt.energy_and_forces(tm.to(tdt), _torch_batch(data, tdt))


@pytest.mark.parametrize("basis, dt", [("exp", "fp64"), ("exp", "fp32"), ("bessel", "fp64"),
                                       pytest.param("bessel", "fp32", marks=pytest.mark.slow)])
def test_reduced_energy_and_forces_match_jax(basis, dt):
    _, tm, _, data = _reduced(basis)
    ref = {d: _jax_ref(basis, d) for d in (("fp64",) if dt == "fp64" else DTYPES)}
    te, tf = _port_ef(tm, data, DTYPES[dt][1])
    assert te.shape == (GRAPHS,) and tf.shape == (GRAPHS * SLOTS, 3)
    assert tf.dtype == DTYPES[dt][1]
    assert _close(te.numpy(), {k: v[0] for k, v in ref.items()}, dt)
    assert _close(tf.numpy(), {k: v[1] for k, v in ref.items()}, dt)
    assert float(tf.abs().max()) > 0.0


@pytest.mark.parametrize("basis", ["exp", pytest.param("bessel", marks=pytest.mark.slow)])
def test_reduced_bfloat16_energy_and_forces_match_jax(basis):
    """compute_dtype='bfloat16' in both packages, fp32 weights and positions.
    JAX's own bf16 forces lie 3.3e-2 (exp) and 2.8e-2 (bessel) of the
    largest force from its fp64 ones: bf16 features meet the bases'
    cancelling derivatives.  The two packages round at different points, so
    each is held to the fp64 values, the port within BF16_FACTOR times JAX's
    own bf16 error.  The run must be in bf16: it moves off JAX's fp32
    results by more than BF16_MIN_SHIFT."""
    jm, _, tree, data = _reduced(basis)
    ref = {"fp64": _jax_ref(basis, "fp64"), "fp32": _jax_ref(basis, "fp32")}
    jb = jax.jit(lambda p, b: j_energy_and_forces(jm.clone(compute_dtype="bfloat16"), p, b))(
        _cast(tree, np.float32), _jax_batch(data, np.float32))
    tm16 = TModel(**REDUCED, basis_type=basis, compute_dtype="bfloat16", seed=4).eval()
    params_from_jax(tm16, tree)
    got = pt.energy_and_forces(tm16, _torch_batch(data, torch.float32))
    for i, t in enumerate(got):
        assert t.dtype == torch.float32
        jerr = _rel(jb[i], ref["fp64"][i])
        assert _rel(t.numpy(), ref["fp64"][i]) <= BF16_FACTOR * jerr
        assert _rel(t.numpy(), ref["fp32"][i]) > BF16_MIN_SHIFT
