"""The CUDA-core FMA probe (S2): K dependent multiply-adds per element.

Counterpart of ``scripts/chip_peaks.py``'s ``_vpu_kernel`` (``bench_vpu``,
``bench_vpu_wide``): ``acc <- acc * m + c``, K times, on every element,
the rate at which the card's CUDA cores run the elementwise FMAs that the
DTP kernels' term loops spend.  ``fma_probe`` launches the kernel
(``csrc/peaks.cu``) for CUDA tensors and takes ``fma_probe_plain`` for CPU
tensors.  ``m`` and ``c`` are rounded to the operand dtype first, as JAX
rounds its weakly typed Python floats: in bf16 the default multiplier
1.000001 is exactly 1.0.
"""

from __future__ import annotations

import torch

from . import _build

MULTIPLIER, ADDEND = 1.000001, 0.5  # the script's constants


def _rounded(v: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(v, dtype=dtype))


def fma_probe_plain(x: torch.Tensor, k: int, m: float = MULTIPLIER,
                    c: float = ADDEND) -> torch.Tensor:
    """Plain version: ``acc = acc * m + c`` K times in x's dtype (each
    product and sum rounded, as JAX's body rounds them; the kernel's fused
    multiply-add rounds once)."""
    m, c = _rounded(m, x.dtype), _rounded(c, x.dtype)
    acc = x.clone()
    for _ in range(k):
        acc = acc * m + c
    return acc


def fma_probe(x: torch.Tensor, k: int, m: float = MULTIPLIER, c: float = ADDEND) -> torch.Tensor:
    """S2: K dependent FMAs on each element of ``x`` (float32 or bfloat16,
    any shape), returned in a new tensor of x's shape and dtype.  CPU
    tensors take ``fma_probe_plain``; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return fma_probe_plain(x, k, m, c)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    code = _build.dtype_code(x)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads 16-byte vectors
    out = torch.empty_like(x)
    err = _build.library().fma_probe(
        _build.ptr(x), _build.ptr(out), x.numel(), k, _rounded(m, x.dtype), _rounded(c, x.dtype),
        code, _build.stream_ptr())
    _build.check(err, "fma_probe")
    fma_probe.launches += 1
    return out


fma_probe.launches = 0
