"""The PyTorch port's core (irreps, CG, SH, tensor products) against the JAX
package, on the same numpy inputs.

Tolerances: CG tables and irreps plans are bit-equal (same numpy float64
code).  SH and TP outputs: fp64 within 1e-12 relative (sums in another order),
fp32 within 1e-5 relative (float32 rounding through two contractions).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from equiformer_tpu import core as jc  # noqa: E402
from equiformer_tpu_torch import core as tc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"fp64": (np.float64, torch.float64, 1e-12), "fp32": (np.float32, torch.float32, 1e-5)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "import equiformer_tpu_torch\n"
        "import equiformer_tpu_torch.kernels, equiformer_tpu_torch.utils.convert_jax\n"
        "m = equiformer_tpu_torch.model_entrypoint('graph_attention_transformer_nonlinear_l2')\n"
        "assert all(sys.modules.get(k) is None for k in ('jax', 'flax', 'optax'))\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("s", ["128x0e+64x1e+32x2e", "1x1o+2x0e+3x1e+1x0o", "4x0e+4x0e+1x2o"])
def test_irreps_match(s):
    j, t = jc.Irreps(s), tc.Irreps(s)
    assert str(j) == str(t) and j.dim == t.dim and j.num_irreps == t.num_irreps
    js, jp, jinv = j.sort_even_first()
    ts, tp, tinv = t.sort_even_first()
    assert (str(js), jp, jinv) == (str(ts), tp, tinv)
    assert str(j.simplify()) == str(t.simplify())


def test_cg_tables_bit_equal():
    for l1 in range(4):
        for l2 in range(4):
            for l3 in range(abs(l1 - l2), min(l1 + l2, 4) + 1):
                assert np.array_equal(jc.wigner_3j(l1, l2, l3), tc.wigner_3j(l1, l2, l3))
                assert np.array_equal(jc.wigner_3j_component(l1, l2, l3),
                                      tc.wigner_3j_component(l1, l2, l3))
                assert np.array_equal(jc.su2_cg(l1, l2, l3), tc.su2_cg(l1, l2, l3))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_spherical_harmonics_match(dt):
    npdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3)).astype(npdt)
    v[0] = 0.0  # zero vector (padded edge) -> Y_0 = 1, rest 0
    j = np.asarray(jc.spherical_harmonics([0, 1, 2, 3], jnp.asarray(v)))
    t = tc.spherical_harmonics([0, 1, 2, 3], torch.from_numpy(v)).numpy()
    assert t.dtype == npdt
    assert _rel(t, j) < tol
    assert np.array_equal(t[0], np.eye(16)[0])


def _tp_inputs(tp, rng, npdt, n=16, shared=False):
    x1 = rng.normal(size=(n, tp.irreps_in1.dim)).astype(npdt)
    x2 = rng.normal(size=(n, tp.irreps_in2.dim)).astype(npdt)
    w = rng.normal(size=(tp.weight_numel,) if shared else (n, tp.weight_numel)).astype(npdt)
    return x1, x2, w


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["depthwise_sh", "depthwise_mul2", "fc_scalar_attr", "fc_general"])
def test_tensor_product_apply_matches(kind, dt):
    npdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    irr = "8x0e+4x1e+2x2e"
    if kind == "depthwise_sh":
        args, make, shared, scale = (irr, "1x0e+1x1e+1x2e", irr), "depthwise_tp", False, True
    elif kind == "depthwise_mul2":
        args, make, shared, scale = (irr, "2x0e+2x1e", irr), "depthwise_tp", False, True
    elif kind == "fc_scalar_attr":
        args, make, shared, scale = (irr, "1x0e", "6x0e+3x1e+2x2e"), "fully_connected_tp", True, False
    else:
        args, make, shared, scale = (irr, "2x0e+1x1e", "5x0e+3x1e+1x2e"), "fully_connected_tp", True, False
    jtp = getattr(jc, make)(*[jc.Irreps(a) for a in args])
    ttp = getattr(tc, make)(*[tc.Irreps(a) for a in args])
    assert str(jtp.irreps_out) == str(ttp.irreps_out)
    assert jtp.weight_numel == ttp.weight_numel
    assert np.array_equal(jtp.weight_std_flat(), ttp.weight_std_flat())
    x1, x2, w = _tp_inputs(jtp, rng, npdt, shared=shared)
    j = np.asarray(jtp.apply(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w), scale_weights=scale))
    t = ttp.apply(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(w),
                  scale_weights=scale).numpy()
    assert _rel(t, j) < tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_elementwise_multiply_matches(dt):
    npdt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(2)
    irr = "3x0e+2x1e+2x2e"
    x = rng.normal(size=(5, jc.Irreps(irr).dim)).astype(npdt)
    s = rng.normal(size=(5, 7)).astype(npdt)
    j = np.asarray(jc.elementwise_multiply(jc.Irreps(irr), jnp.asarray(x), jnp.asarray(s)))
    t = tc.elementwise_multiply(tc.Irreps(irr), torch.from_numpy(x), torch.from_numpy(s)).numpy()
    assert _rel(t, j) < tol
