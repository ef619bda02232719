"""ctypes bindings of the port's host runtime (``host_ops.cpp``).

Counterpart of ``equiformer_tpu.native``.  The system C++ compiler builds
the library at first use into ``build/torch_host/<hash>/`` at the
repository root, keyed by a hash of the source, the flags and the
compiler, so an unchanged tree builds once.  A failed compile raises with
the compiler's output; only a missing compiler leaves ``HAVE_NATIVE``
False, and then ``balanced_assign`` / ``balanced_assign_capped`` take
their numpy versions (the same assignment) and ``GraphLoader`` collates in
numpy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_host"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]


def _compiler():
    for cc in ("g++", "c++", "clang++"):
        path = shutil.which(cc)
        if path:
            return path
    return None


HAVE_NATIVE = _compiler() is not None


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (unless this hash is built) and load the library."""
    cc = _compiler()
    if cc is None:
        raise RuntimeError("native library unavailable: no C++ compiler")
    version = subprocess.run([cc, "--version"], capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join([cc, version, platform.machine(), *CXX_FLAGS]).encode())
    h.update(_SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libequiformer_host.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename, so a concurrent or cut
        # build never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [cc, *CXX_FLAGS, "-o", tmp, str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.collate_dense_batch.restype = ctypes.c_int
    lib.collate_dense_batch.argtypes = [vp] * 6 + [i64, i64] + [vp] * 7
    lib.radius_graph_stats.restype = i64
    lib.radius_graph_stats.argtypes = [vp, vp, i64, ctypes.c_float, vp]
    lib.balanced_assign.restype = None
    lib.balanced_assign.argtypes = [vp, vp, i64, i64, vp]
    lib.balanced_assign_capped.restype = None
    lib.balanced_assign_capped.argtypes = [vp, vp, i64, i64, vp, vp]
    return lib


def _p(a):
    return None if a is None else a.ctypes.data


class GraphArena:
    """A dataset's graphs in contiguous arrays, for native collation: each
    batch is one memcpy per field per graph instead of numpy assembly."""

    def __init__(self, graphs, with_forces: bool = False):
        offsets = np.zeros(len(graphs) + 1, np.int64)
        for i, g in enumerate(graphs):
            offsets[i + 1] = offsets[i] + len(g["pos"])
        total = int(offsets[-1])
        self.offsets = offsets
        self.pos = np.zeros((total, 3), np.float32)
        self.species = np.zeros(total, np.int64)
        self.forces = np.zeros((total, 3), np.float32) if with_forces else None
        self.y = np.zeros(len(graphs), np.float32)
        for i, g in enumerate(graphs):
            s, e = offsets[i], offsets[i + 1]
            self.pos[s:e] = g["pos"]
            self.species[s:e] = g["species"]
            if with_forces and "forces" in g:
                self.forces[s:e] = g["forces"]
            if g.get("y") is not None:
                self.y[i] = g["y"]
        self.with_forces = with_forces

    def __len__(self):
        return len(self.offsets) - 1

    def collate_dense(self, indices: np.ndarray, slots: int):
        """The graphs ``indices`` in ``len(indices)`` graph slots of
        ``slots`` node slots each, ``collate_dense``'s layout, as a
        ``GraphsTuple`` of CPU tensors (no extras).  Raises ``ValueError``
        when a graph has more than ``slots`` atoms."""
        from ..graph.batching import GraphsTuple

        indices = np.ascontiguousarray(indices, np.int64)
        if indices.ndim != 1 or (len(indices) and not 0 <= indices.min() <= indices.max()
                                 < len(self)):
            raise ValueError(f"indices must be graph ids in [0, {len(self)})")
        b = len(indices)
        n_cap = b * slots
        pos = np.empty((n_cap, 3), np.float32)
        species = np.empty(n_cap, np.int64)
        node_mask = np.empty(n_cap, bool)
        batch = np.empty(n_cap, np.int64)
        graph_mask = np.empty(b, bool)
        y = np.empty(b, np.float32)
        forces = np.empty((n_cap, 3), np.float32) if self.with_forces else None
        ret = _lib().collate_dense_batch(
            _p(self.pos), _p(self.species), _p(self.forces), _p(self.offsets), _p(self.y),
            _p(indices), b, slots, _p(pos), _p(species), _p(node_mask), _p(batch),
            _p(graph_mask), _p(y), _p(forces))
        if ret != 0:
            raise ValueError(f"a graph exceeds {slots} node slots")
        t = torch.from_numpy
        return GraphsTuple(pos=t(pos), species=t(species), batch=t(batch),
                           node_mask=t(node_mask), graph_mask=t(graph_mask), y=t(y),
                           forces=None if forces is None else t(forces), extras={})

    def radius_stats(self, radius: float):
        """avg_nodes / avg_edges / avg_degree of the radius graph (float32
        distances), and ``edges_per_graph``."""
        per = np.zeros(len(self), np.int64)
        total = _lib().radius_graph_stats(_p(self.pos), _p(self.offsets), len(self),
                                          ctypes.c_float(radius), _p(per))
        n = float(self.offsets[-1])
        return {
            "avg_nodes": n / len(self),
            "avg_edges": total / len(self),
            "avg_degree": total / n,
            "edges_per_graph": per,
        }


def balanced_assign(sizes: np.ndarray, shards: int) -> np.ndarray:
    """Shard of each graph: greedy by decreasing size onto the lightest
    shard."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    order = np.argsort(-sizes).astype(np.int64)
    out = np.zeros(len(sizes), np.int64)
    if HAVE_NATIVE:
        _lib().balanced_assign(_p(order), _p(sizes), len(sizes), shards, _p(out))
        return out
    loads = np.zeros(shards, np.int64)
    for g in order:
        k = int(np.argmin(loads))
        out[g] = k
        loads[k] += sizes[g]
    return out


def balanced_assign_capped(sizes: np.ndarray, shards: int, caps: np.ndarray) -> np.ndarray:
    """``balanced_assign`` with at most ``caps[s]`` graphs on shard ``s``, so
    every shard keeps the round-robin item count (OCP's
    BalancedBatchSampler)."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    caps = np.ascontiguousarray(caps, np.int64)
    if caps.shape != (shards,):
        raise ValueError(f"caps must hold one count per shard ({shards}), got {caps.shape}")
    order = np.argsort(-sizes).astype(np.int64)
    out = np.zeros(len(sizes), np.int64)
    if HAVE_NATIVE:
        _lib().balanced_assign_capped(_p(order), _p(sizes), len(sizes), shards, _p(caps),
                                      _p(out))
        return out
    loads = np.zeros(shards, np.int64)
    counts = np.zeros(shards, np.int64)
    for g in order:
        open_ = counts < caps
        if not open_.any():
            out[g] = 0
            continue
        k = int(np.flatnonzero(open_)[np.argmin(loads[open_])])
        out[g] = k
        loads[k] += sizes[g]
        counts[k] += 1
    return out
