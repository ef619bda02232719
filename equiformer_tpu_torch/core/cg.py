"""Clebsch-Gordan / Wigner-3j coefficients in the real spherical-harmonic basis.

The same construction as ``equiformer_tpu.core.cg``, in numpy float64, so the
tables are bit-equal between the two packages:

1. SU(2) Clebsch-Gordan coefficients in the complex |l m> basis via the Racah
   formula (exact rational arithmetic inside the sum).
2. Change of basis to real spherical harmonics (real-SH ordering mu = -l..l,
   so the l=1 basis is (y, z, x)).
3. The real intertwiner is purely real or purely imaginary; take the
   non-vanishing part, normalize to unit Frobenius norm (e3nn's
   ``o3.wigner_3j`` convention), and fix the overall sign deterministically.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np


@functools.lru_cache(maxsize=None)
def _f(n: int) -> int:
    return math.factorial(n)


@functools.lru_cache(maxsize=None)
def su2_cg(j1: int, j2: int, j3: int) -> np.ndarray:
    """Complex-basis CG coefficients <j1 m1 j2 m2 | j3 m3> (Condon-Shortley).

    Returns array of shape (2j1+1, 2j2+1, 2j3+1) indexed by (m1+j1, m2+j2, m3+j3).
    Racah's closed form with exact integer arithmetic inside the sum.
    """
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    out = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    pref_delta = Fraction(
        _f(j1 + j2 - j3) * _f(j1 - j2 + j3) * _f(-j1 + j2 + j3), _f(j1 + j2 + j3 + 1)
    )
    for m1 in range(-j1, j1 + 1):
        for m2 in range(-j2, j2 + 1):
            m3 = m1 + m2
            if abs(m3) > j3:
                continue
            pref = (
                Fraction(2 * j3 + 1)
                * pref_delta
                * (_f(j3 + m3) * _f(j3 - m3))
                * (_f(j1 - m1) * _f(j1 + m1))
                * (_f(j2 - m2) * _f(j2 + m2))
            )
            s = Fraction(0)
            kmin = max(0, -(j3 - j2 + m1), -(j3 - j1 - m2))
            kmax = min(j1 + j2 - j3, j1 - m1, j2 + m2)
            for k in range(kmin, kmax + 1):
                den = (
                    _f(k)
                    * _f(j1 + j2 - j3 - k)
                    * _f(j1 - m1 - k)
                    * _f(j2 + m2 - k)
                    * _f(j3 - j2 + m1 + k)
                    * _f(j3 - j1 - m2 + k)
                )
                s += Fraction((-1) ** k, den)
            val = float(s) * math.sqrt(float(pref))
            out[m1 + j1, m2 + j2, m3 + j3] = val
    return out


@functools.lru_cache(maxsize=None)
def real_basis_change(l: int) -> np.ndarray:
    """Unitary Q with S_real = Q @ Y_complex.

    Rows are real-SH indices mu=-l..l, columns complex m=-l..l:
      mu=0 : S_0 = Y^0
      mu>0 : S_mu  = (Y^{-mu} + (-1)^mu Y^{mu}) / sqrt(2)
      mu<0 : S_mu  = i (Y^{mu} - (-1)^mu Y^{-mu}) / sqrt(2)   (mu = -a, a>0)
    """
    Q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    Q[l, l] = 1.0
    s2 = 1.0 / math.sqrt(2.0)
    for a in range(1, l + 1):
        sgn = (-1.0) ** a
        # mu = +a row
        Q[l + a, l - a] = s2
        Q[l + a, l + a] = sgn * s2
        # mu = -a row
        Q[l - a, l - a] = 1j * s2
        Q[l - a, l + a] = -1j * sgn * s2
    return Q


@functools.lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis Wigner-3j-like intertwiner, unit Frobenius norm.

    C[i, j, k] such that sum_ij C[i,j,k] u_i v_j is equivariant when u, v, out
    transform in the real irreps l1, l2, l3.  Zero unless |l1-l2|<=l3<=l1+l2.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    cg = su2_cg(l1, l2, l3)  # [m1, m2, m3]
    Q1 = real_basis_change(l1)
    Q2 = real_basis_change(l2)
    Q3 = real_basis_change(l3)
    # C[mu1,mu2,mu3] = sum conj(Q1) conj(Q2) Q3 cg
    C = np.einsum("ia,jb,kc,abc->ijk", np.conj(Q1), np.conj(Q2), Q3, cg)
    re, im = np.real(C), np.imag(C)
    if np.linalg.norm(im) > np.linalg.norm(re):
        out, resid = im, np.linalg.norm(re)
    else:
        out, resid = re, np.linalg.norm(im)
    assert resid < 1e-9, f"intertwiner not purely real/imag for {(l1, l2, l3)}"
    out = out / np.linalg.norm(out)
    # Deterministic sign: first element with significant magnitude is positive.
    flat = out.ravel()
    idx = np.argmax(np.abs(flat) > 1e-8)
    if flat[idx] < 0:
        out = -out
    return np.ascontiguousarray(out)


@functools.lru_cache(maxsize=None)
def wigner_3j_component(l1: int, l2: int, l3: int) -> np.ndarray:
    """wigner_3j scaled by sqrt(2*l3+1): per-output-component unit norm.

    This is the per-path coefficient used by e3nn TensorProduct with
    ``irrep_normalization='component'`` and ``path_normalization='none'``
    (the reference configuration, tensor_product_rescale.py:33-37).
    """
    return wigner_3j(l1, l2, l3) * math.sqrt(2 * l3 + 1)
