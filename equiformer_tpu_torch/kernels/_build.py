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
_F = ctypes.c_float

# C entry points: name -> argtypes (every one returns a cudaError_t as int)
# K2's arguments (csrc/dtp_lin_bwd.cu, k2::Args), which every entry on its
# launches takes first: x, x_row_stride, d_x, sh, d_sh, w, d_w, packed W,
# g, d_out, n_edges*, E, gk table (k2_tables'), n_gk, terms, coeffs, dwmap,
# dx, dw, span_max, cp_max, fd_max, dW tiles, n_tiles, dW partials,
# n_ranges, range_len, dW, w_numel
_K2 = [_VP, _LL, _I, _VP, _I, _VP, _I, _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _VP, _VP, _VP, _VP,
       _I, _I, _I, _VP, _I, _VP, _I, _I, _VP, _I]

_SIGNATURES = {
    # K1: x, x_row_stride, d_x, sh, d_sh, w, d_w, packed W, out, d_out,
    # n_edges*, E, gk table (k1_tables'), groups, n_groups, runs, terms,
    # coeffs, fz_max, tile (32 or 16), vec (4 or 1), dtype, stream
    "dtp_lin_fwd": [_VP, _LL, _I, _VP, _I, _VP, _I, _VP, _VP, _I, _VP, _I,
                    _VP, _VP, _I, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    # K2: K2's arguments, dtype, stream
    "dtp_lin_bwd": _K2 + [_I, _VP],
    # S3: K2's arguments, then the stage (0-6) before the dtype
    "dtp_lin_bwd_stage": _K2 + [_I, _I, _VP],
    # K5a and K5b's sh leg: K2's arguments, then dsh, its split partials,
    # the dsh slots a row, the leg (4 K5a, 1 sh) and the irrep-group splits
    # of a tile before the dtype
    "dtp_lin_bwd3": _K2 + [_VP, _VP, _I, _I, _I, _I, _VP],
    # leg (4 K5a or K7-B3, 1 sh), d_x, d_sh, span_max, cp_max, fd_max, has_w,
    # x rows (0 broadcast), need (1 dx, 2 dsh, 4 dw or K7-B3's dh), dsh
    # slots, hd (0, or K7-B3's), dtype -> resident blocks per SM (or
    # -cudaError_t)
    "dtp_lin_dsh_occupancy": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I],
    # the radial fold (K7): h [E, hd] in place of w.  K7-F: K1's arguments
    # (w null; the packed W and [Wr; offset] of k1_tables(fold=True)), then
    # h, hd, the packed Wr and offsets, their per-group offsets, span_max,
    # x read through L2 (0 or 1), dtype, stream
    "dtp_lin_rad_fwd": [_VP, _LL, _I, _VP, _I, _VP, _I, _VP, _VP, _I, _VP, _I,
                        _VP, _VP, _I, _VP, _VP, _VP, _I, _I, _I, _VP, _I, _VP, _VP, _I, _I,
                        _I, _VP],
    # K7-B: K2's arguments (w null, dw the workspace, dW ++ d[Wr; offset]),
    # then h, hd, Wl, n_loc, the packed Wr (k7_tables), its gk offsets, dh
    # before the dtype
    "dtp_lin_rad_bwd": _K2 + [_VP, _I, _VP, _I, _VP, _VP, _VP, _I, _VP],
    # K7-LW: K2's arguments (w null), then h, hd, Wl, n_loc, the packed Wr
    # (k7_tables) and its gk offsets before the dtype
    "dtp_lin_rad_legW": _K2 + [_VP, _I, _VP, _I, _VP, _VP, _I, _VP],
    # K7-B3: K2's arguments (w and dw null), then h, hd, Wl, n_loc, the packed
    # Wr (k7_tables) and its gk offsets, dh, dsh, its split partials, the dsh
    # slots a row, dh's split partials and the irrep-group splits of a tile
    # before the dtype
    "dtp_lin_rad_bwd3": _K2 + [_VP, _I, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I,
                               _VP],
    # K5b's x and w legs: K2's arguments, then the leg (0 x, 2 w) and the
    # irrep-group splits of a tile before the dtype
    "dtp_lin_edge_leg": _K2 + [_I, _I, _I, _VP],
    # K5c: K2's arguments
    "dtp_lin_legW": _K2 + [_I, _VP],
    # K7-L: K2's arguments (w and dw null), then h, hd, Wl, n_loc, the packed
    # Wr (k7_tables) and its gk offsets, dh, dsh, its split partials, the dsh
    # slots a row, the leg (0 x, 1 sh, 2 h) and the irrep-group splits of a
    # tile before the dtype
    "dtp_lin_rad_leg": _K2 + [_VP, _I, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    # K7-Wr: K2's arguments (w and dx null, dw the workspace, dW the d[Wr;
    # offset]), then h, hd, n_loc, one (0 or 1) and the w leg's irrep-group
    # splits before the dtype
    "dtp_lin_rad_legWr": _K2 + [_VP, _I, _I, _I, _I, _I, _VP],
    # a, a_row_stride, col, d_col, b, b_row_stride, out, d_out, E, chunks,
    # terms, items, run_items, n_runs (TermList.t_plan), vec, dtype, stream
    "dtp_t": [_VP, _LL, _VP, _I, _VP, _LL, _VP, _I, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    # a, a_row_stride, b, b_row_stride, d, d_d, out, d_col, d_a, d_b, E, tile,
    # chunks, terms, n_terms, n_slots, column ranges, slots, items, n_items
    # (TermList.r_plan), vec, dtype, stream
    "dtp_r": [_VP, _LL, _VP, _LL, _VP, _I, _VP, _I, _I, _I, _I, _I, _VP, _VP, _I, _I, _VP, _VP,
              _VP, _I, _I, _I, _VP],
    # x, x_row_stride, sh, d_sh, w, w_row_stride, g, d_g, dx, d_x, dsh, dw,
    # d_w, E, tile, stage_g, chunks, n_dx, dx terms, dw terms, n_dw_terms,
    # n_slots, dsh ranges, dsh slots, items, n_items (TermList.fb_plan), vec,
    # dtype, stream
    "dtp_fused_bwd": [_VP, _LL, _VP, _I, _VP, _LL, _VP, _I, _VP, _I, _VP, _VP, _I, _I, _I, _I,
                      _VP, _I, _VP, _VP, _I, _I, _VP, _VP, _VP, _I, _I, _I, _VP],
    # K8-F: x, x_row_stride, sh, d_sh, w, d_w, packed G, out, d_out,
    # n_edges*, E, gk table (KronMeta.k1_tables'), n_gk, runs, terms, coeffs,
    # fz_max, vec (4 or 1), the (g, k)'s column chunks, dtype, stream
    "dtp_lin_kron_fwd": [_VP, _LL, _VP, _I, _VP, _I, _VP, _VP, _I, _VP, _I, _VP, _I, _VP, _VP,
                         _VP, _I, _I, _I, _I, _VP],
    # K8-B: K2's arguments on KronMeta.bwd_tables (the packed G^T in the
    # packed W's place, dG and G's numel in dW's and w_numel's), dtype, stream
    "dtp_lin_kron_bwd": _K2 + [_I, _VP],
    # S1-F: x, d_x, sh, d_sh, w, d_w, out, d_out, E, dtype, stream
    "dtp_t_floor": [_VP, _I, _VP, _I, _VP, _I, _VP, _I, _I, _I, _VP],
    # S1-A: a, d_a, col, d_col, b, d_b, out, d_out, E, tile, chunks, terms,
    # items, n_items (dtp_t_variants.staged_plan), vec, dtype, stream
    "dtp_t_staged": [_VP, _I, _VP, _I, _VP, _I, _VP, _I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _VP],
    # S2: x, out, n, k, m, c, dtype, stream
    "fma_probe": [_VP, _VP, _LL, _I, _F, _F, _I, _VP],
    # val, C, dst, dst's bytes per index (8 or 4), E, mask, out, N, vec (1 or
    # 16 bytes' worth), nodes per block, dtype, stream
    "csr_segment_sum": [_VP, _I, _VP, _I, _I, _VP, _VP, _I, _I, _I, _I, _VP],
    # K4: scores, value, dropmul, shift, dst, dst's bytes per index (8 or 4),
    # mask, E, out, den, N, H, D, vec (1 or 16 bytes' worth), nodes per
    # block, dtype, stream
    "attn_combine": [_VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I,
                     _I, _VP],
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
    """The current device's current CUDA stream as a pointer: what
    ``torch.cuda.current_stream().cuda_stream`` gives, without building the
    Stream object (host time is what the small launches pay)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()
