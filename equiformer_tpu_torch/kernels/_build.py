"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles every source in ``equiformer_tpu_torch/csrc`` for Hopper
(``sm_90a``), one process per source, all started together, then links the
objects into one shared library with a plain C interface, which is loaded
with ``ctypes``.  The library lands in ``build/torch_kernels/<hash>/``
at the repository root, keyed by a hash of the sources and flags, so an
unchanged tree builds once.  A failed build raises with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this source hash is already built; returns
    the library path.  The compiler's register/shared-memory report goes to
    ``ptxas.log`` beside the library."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libequiformer_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus = [p for p in _sources() if p.suffix == ".cu"]
    # build into temporary names and rename, so a concurrent or interrupted
    # build never leaves a half-written library under the final name
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for cu in cus:
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(tmp / (cu.stem + ".o")),
               str(cu)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp / lib.name), *[str(tmp / (cu.stem + ".o"))
                                                            for cu in cus]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    (out_dir / "ptxas.log").write_text("\n".join(log))
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("\n".join(failed))
    os.replace(tmp / lib.name, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    return lib


_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C entry points: name -> argtypes (every one returns a cudaError_t as int)
_SIGNATURES = {
    # x, x_row_stride, sh, w, W, out, n_edges*, E, d_sh, d_w, d_out,
    # gk table, n_gk, terms, coeffs, max_fan_stride, dtype, stream
    "dtp_lin_fwd": [_VP, _LL, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                    _VP, _I, _VP, _VP, _I, _I, _VP],
    # x, x_row_stride, d_x, sh, d_sh, w, d_w, W^T, g, d_out, n_edges*, E,
    # gk table, n_gk, terms, coeffs, dwmap, dx, dw, dW partials, n_parts, dW,
    # w_numel, span_max, cols_pad_max, max_fan_stride, dtype, stream
    "dtp_lin_bwd": [_VP, _LL, _I, _VP, _I, _VP, _I, _VP, _VP, _I, _VP, _I,
                    _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP,
                    _I, _I, _I, _I, _I, _VP],
    # x, x_row_stride, d_x, sh, d_sh, w, d_w, W^T, g, d_out, n_edges*, E,
    # gk table, n_gk, terms, coeffs, dwmap, dx, dsh, dw (each may be null),
    # span_max, cols_pad_max, max_fan_stride, dtype, stream
    "dtp_lin_bwd3": [_VP, _LL, _I, _VP, _I, _VP, _I, _VP, _VP, _I, _VP, _I,
                     _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    # d_x (0 without dx), d_sh, span (0 without dw), cols_pad_max,
    # max_fan_stride, hd (0 unfolded), dtype -> resident blocks per SM (or -cudaError_t)
    "dtp_lin_bwd3_occupancy": [_I, _I, _I, _I, _I, _I, _I],
    # the radial fold (K7): h [E, hd] and Wl [hd + 1, n_loc] in place of w.
    # K7-F: x, x_row_stride, sh, W, out, n_edges*, E, d_sh, d_out, gk table
    # (bwd_tables'), n_gk, terms, coeffs, max_fan_stride, h, hd, Wl, n_loc,
    # span_max, dtype, stream
    "dtp_lin_rad_fwd": [_VP, _LL, _VP, _VP, _VP, _VP, _I, _I, _I, _VP, _I, _VP, _VP, _I,
                        _VP, _I, _VP, _I, _I, _I, _VP],
    # K7-B: x, x_row_stride, d_x, sh, d_sh, W^T, g, d_out, n_edges*, E, gk
    # table, n_gk, terms, coeffs, dx, partials, n_parts, dW ++ d[Wr; offset],
    # w_numel, span_max, cols_pad_max, max_fan_stride, h, hd, Wl, n_loc, dh,
    # dtype, stream
    "dtp_lin_rad_bwd": [_VP, _LL, _I, _VP, _I, _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _VP,
                        _VP, _VP, _I, _VP, _I, _I, _I, _I, _VP, _I, _VP, _I, _VP, _I, _VP],
    # K7-B3: x, x_row_stride, d_x, sh, d_sh, W^T, g, d_out, n_edges*, E, gk
    # table, n_gk, terms, coeffs, dx, dsh (each may be null), span_max,
    # cols_pad_max, max_fan_stride, h, hd, Wl, n_loc, dh, dtype, stream
    "dtp_lin_rad_bwd3": [_VP, _LL, _I, _VP, _I, _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _VP,
                         _VP, _VP, _I, _I, _I, _VP, _I, _VP, _I, _VP, _I, _VP],
    # leg (0 x, 1 sh, 2 w), x, x_row_stride, d_x, sh, d_sh, w, d_w, W^T, g, d_out,
    # n_edges*, E, gk table, n_gk, terms, coeffs, dwmap, out, span_max,
    # cols_pad_max, max_fan_stride, dtype, stream
    "dtp_lin_leg": [_I, _VP, _LL, _I, _VP, _I, _VP, _I, _VP, _VP, _I, _VP, _I,
                    _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    # leg, d_x, d_sh, span_max, cols_pad_max, max_fan_stride, dtype
    # -> resident blocks per SM (or -cudaError_t)
    "dtp_lin_leg_occupancy": [_I, _I, _I, _I, _I, _I, _I],
    # x, x_row_stride, sh, d_sh, w, d_w, g, d_out, n_edges*, E, gk table, n_gk,
    # terms, coeffs, dW partials, n_parts, dW, w_numel, cols_pad_max,
    # max_fan_stride, dtype, stream
    "dtp_lin_legW": [_VP, _LL, _VP, _I, _VP, _I, _VP, _I, _VP, _I, _VP, _I,
                     _VP, _VP, _VP, _I, _VP, _I, _I, _I, _I, _VP],
    # cols_pad_max, max_fan_stride, dtype -> resident blocks per SM (or -cudaError_t)
    "dtp_lin_legW_occupancy": [_I, _I, _I],
    # a, a_row_stride, col, d_col, b, b_row_stride, out, d_out, E, segments,
    # n_seg, terms, coeffs, dtype, stream
    "dtp_t": [_VP, _LL, _VP, _I, _VP, _LL, _VP, _I, _I, _VP, _I, _VP, _VP, _I, _VP],
    # a, a_row_stride, b, b_row_stride, d, d_d, out, d_col, E, column ranges,
    # terms, coeffs, dtype, stream
    "dtp_r": [_VP, _LL, _VP, _LL, _VP, _I, _VP, _I, _I, _VP, _VP, _VP, _I, _VP],
    # x, x_row_stride, sh, d_sh, w, w_row_stride, g, d_g, dx, d_x, dsh, dw,
    # d_w, E, dx segments, n, terms, coeffs, dw segments, n, terms, coeffs,
    # R's column ranges, terms, coeffs, dtype, stream
    "dtp_fused_bwd": [_VP, _LL, _VP, _I, _VP, _LL, _VP, _I, _VP, _I, _VP, _VP, _I, _I,
                      _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _VP],
    # val, C, rowptr, mask, out, N, dtype, stream
    "csr_segment_sum": [_VP, _I, _VP, _VP, _VP, _I, _I, _VP],
    # scores, value, dropmul, shift, rowptr, out, den, N, H, D, dtype, stream
    "attn_combine": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def dtype_code(t) -> int:
    """0 for float32, 1 for bfloat16; other dtypes have no kernel."""
    import torch

    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"no CUDA kernel for dtype {t.dtype} (float32 or bfloat16)")


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()
