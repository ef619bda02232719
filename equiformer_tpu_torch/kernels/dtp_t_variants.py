"""Two variants of K6-T for measuring it against its shapes (S1).

Counterparts of the kernels of ``scripts/kbench.py``; the tool
``tools/kbench.py`` times them beside K6-T (``dtp_t``).

* ``dtp_t_floor`` (S1-F, the script's ``dma_call``): out [E, d_out] zero
  except ``out[:, :128] = (x[:, :128] + sh[:, :1]) + w[:, :128]``; the
  kernel loads every element of x, sh and w once and stores every element
  of out once, so its time is the byte floor of T at these shapes.
* ``dtp_t_staged`` (S1-A, the script's ``aligned_call``): T on K6-T's
  term tables, each block staging its edge tile's rows in shared memory
  once and writing every output segment of the tile from there; z dense
  (``aligned_call(False)``) or, given the z slots of ``make_layouts``, in
  128-column slots with zero padding (``aligned_call(True)``).

Both kernels are in ``csrc/dtp_t_variants.cu``.  CPU tensors take the plain
versions (``dtp_t_floor_plain``, ``dtp_t_staged_plain``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.tensor_product import TensorProduct
from . import _build
from .dtp import TermList, _edge_rows, dtp_t_plain

FLOOR_COLS = 128  # the columns of x and w that reach the floor's output
SLOT = 128  # the aligned layout's slot width

Slots = Dict[int, Tuple[int, int]]  # flat offset -> (slot column, mul)


def make_layouts(tp: TensorProduct):
    """The 128-column slot layouts of ``scripts/kbench.py``'s ``make_layouts``
    (the port's own copy): one slot per (block, component) of x and of the
    output, one per instruction of w.  Returns (x_slots, d_x_al, w_slots,
    d_w_al, z_slots, d_z_al), each ``*_slots`` mapping a flat offset to
    (slot column, mul)."""

    def slots(irreps):
        out, acc = {}, 0
        for (mul, ir), sl in zip(irreps, irreps.slices()):
            for c in range(ir.dim):
                out[sl.start + c * mul] = (acc, mul)
                acc += SLOT
        return out, acc

    x_slots, d_x_al = slots(tp.irreps_in1)
    w_slots = {tp._offsets[i]: (SLOT * i, tp.irreps_in1[ins.i_in1].mul)
               for i, ins in enumerate(tp.instructions)}
    z_slots, d_z_al = slots(tp.irreps_out)
    return x_slots, d_x_al, w_slots, SLOT * len(tp.instructions), z_slots, d_z_al


# ------------------------------------------------------------------ S1-F
def _floor_check(x, sh, w, d_out):
    E = x.shape[0]
    if x.dim() != 2 or sh.dim() != 2 or w.dim() != 2 or sh.shape[0] != E or w.shape[0] != E:
        raise ValueError(f"x, sh, w must be [E, *] with one E, got {tuple(x.shape)}, "
                         f"{tuple(sh.shape)}, {tuple(w.shape)}")
    if min(x.shape[1], w.shape[1], d_out) < FLOOR_COLS or sh.shape[1] < 1:
        raise ValueError(f"x, w and the output need at least {FLOOR_COLS} columns")
    for t in (sh, w):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError("x, sh and w must share a dtype and a device")


def dtp_t_floor_plain(x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                      d_out: int) -> torch.Tensor:
    """Plain version of S1-F: zeros [E, d_out] in x's dtype with
    ``out[:, :128] = (x[:, :128] + sh[:, :1]) + w[:, :128]``, each sum
    rounded to the dtype, as the script's body adds."""
    _floor_check(x, sh, w, d_out)
    out = x.new_zeros((x.shape[0], d_out))
    out[:, :FLOOR_COLS] = (x[:, :FLOOR_COLS] + sh[:, :1]) + w[:, :FLOOR_COLS]
    return out


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dtp_t_floor(x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor, d_out: int) -> torch.Tensor:
    """S1-F: the plain version's function, [E, d_out] in x's dtype, with
    every element of x, sh and w loaded once (a NaN anywhere in an edge
    tile's inputs makes the tile's output NaN).  CPU tensors take
    ``dtp_t_floor_plain``; CUDA tensors launch the kernel (float32 or
    bfloat16) or raise."""
    if x.device.type == "cpu":
        return dtp_t_floor_plain(x, sh, w, d_out)
    _floor_check(x, sh, w, d_out)
    code = _build.dtype_code(x)
    x, sh, w = _aligned16(x), _aligned16(sh), _aligned16(w)
    E = x.shape[0]
    out = torch.empty((E, d_out), dtype=x.dtype, device=x.device)
    if E == 0:
        return out
    err = _build.library().dtp_t_floor(
        _build.ptr(x), x.shape[1], _build.ptr(sh), sh.shape[1], _build.ptr(w), w.shape[1],
        _build.ptr(out), d_out, E, code, _build.stream_ptr())
    _build.check(err, "dtp_t_floor")
    dtp_t_floor.launches += 1
    return out


# ------------------------------------------------------------------ S1-A
def staged_tables(tl: TermList, z_slots: Optional[Slots], device: torch.device):
    """(segments int32 [n_seg, 4], terms, coeffs, d_out) as
    csrc/dtp_t_variants.cu reads them.  ``z_slots`` None: K6-T's own tables
    (``tl.t_tables``), the dense output.  Otherwise each output tile (o,
    mul) of the terms goes to its slot's column, and the slot's columns past
    mul to a zero segment: the output is [E, 128 * len(z_slots)]."""
    segs, terms, coeffs = tl.t_tables(device)
    if z_slots is None:
        return segs, terms, coeffs, tl.d_out
    key = ("staged-aligned", device)
    if key not in tl._tables:
        runs = {o: (b, e) for o, _, b, e in segs.tolist() if e > b}
        if not set(runs) <= set(z_slots):
            raise ValueError("an output tile of the terms has no slot")
        al = []
        for o, (slot, mul) in sorted(z_slots.items(), key=lambda kv: kv[1][0]):
            b, e = runs.get(o, (0, 0))
            al.append((slot, mul, b, e))
            if mul < SLOT:
                al.append((slot + mul, SLOT - mul, e, e))
        tl._tables[key] = torch.tensor(al, dtype=torch.int32, device=device)
    return tl._tables[key], terms, coeffs, SLOT * len(z_slots)


def dtp_t_staged_plain(tl: TermList, a, col, b, z_slots: Optional[Slots] = None) -> torch.Tensor:
    """Plain version of S1-A: T(a, col, b) (``dtp_t_plain``), dense or,
    with ``z_slots``, each output tile moved to its 128-column slot and the
    rest zero."""
    z = dtp_t_plain(tl, a, col, b)
    if z_slots is None:
        return z
    out = z.new_zeros((z.shape[0], SLOT * len(z_slots)))
    for o, (slot, mul) in z_slots.items():
        out[:, slot : slot + mul] = z[:, o : o + mul]
    return out


def dtp_t_staged(tl: TermList, a: torch.Tensor, col: torch.Tensor, b: torch.Tensor,
                 z_slots: Optional[Slots] = None) -> torch.Tensor:
    """S1-A: T(a, col, b) with a [E, d_a], col [E, d_col], b [E, d_b] (no
    broadcast rows), dense [E, d_out] or in ``z_slots``' 128-column layout.
    CPU tensors take ``dtp_t_staged_plain``; CUDA tensors launch the kernel
    (float32 or bfloat16) or raise."""
    if col.device.type == "cpu":
        return dtp_t_staged_plain(tl, a, col, b, z_slots)
    E = col.shape[0]
    code = _build.dtype_code(col)
    col = _aligned16(_edge_rows(col, E, tl.d_col, col, "col"))
    a = _aligned16(_edge_rows(a, E, tl.d_a, col, "a"))
    b = _aligned16(_edge_rows(b, E, tl.d_b, col, "b"))
    segs, terms, coeffs, d_out = staged_tables(tl, z_slots, col.device)
    out = torch.empty((E, d_out), dtype=col.dtype, device=col.device)
    if E == 0:
        return out
    err = _build.library().dtp_t_staged(
        _build.ptr(a), tl.d_a, _build.ptr(col), tl.d_col, _build.ptr(b), tl.d_b, _build.ptr(out),
        d_out, E, _build.ptr(segs), segs.shape[0], _build.ptr(terms), _build.ptr(coeffs), code,
        _build.stream_ptr())
    _build.check(err, "dtp_t_staged")
    dtp_t_staged.launches += 1
    return out


dtp_t_floor.launches = 0
dtp_t_staged.launches = 0
