"""Two variants of K6-T for measuring it against its shapes (S1).

Counterparts of the kernels of ``scripts/kbench.py``; the tool
``tools/kbench.py`` times them beside K6-T (``dtp_t``).

* ``dtp_t_floor`` (S1-F, the script's ``dma_call``): out [E, d_out] zero
  except ``out[:, :128] = (x[:, :128] + sh[:, :1]) + w[:, :128]``; the
  kernel loads every element of x, sh and w once and stores every element
  of out once, so its time is the byte floor of T at these shapes.
* ``dtp_t_staged`` (S1-A, the script's ``aligned_call``): T on K6-T's
  chunks and term records, each block staging its edge tile's a, b and col
  rows in shared memory once and running K6-T's lanes over them; z dense
  (``aligned_call(False)``, K6-T's bits) or, given the z slots of
  ``make_layouts``, in 128-column slots with zero padding
  (``aligned_call(True)``).

Both kernels are in ``csrc/dtp_t_variants.cu``.  CPU tensors take the plain
versions (``dtp_t_floor_plain``, ``dtp_t_staged_plain``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.tensor_product import TensorProduct
from . import _build
from .dtp import TermList, _edge_rows, _i32, _term_records, cut_segments, dtp_t_plain

FLOOR_COLS = 128  # the columns of x and w that reach the floor's output
SLOT = 128  # the aligned layout's slot width
STAGED_TILES = (4, 2, 1)  # S1-A's edge tiles, largest first
STAGED_SMEM = 16 << 10  # S1-A's shared memory a block

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
def _staged_bytes(tile: int, size: int, tl: TermList) -> int:
    """S1-A's shared memory a block (csrc/dtp_t_variants.cu,
    ``staged_bytes``): a and b rows, col rows in fp32."""
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    return a16(tile * tl.d_a * size) + a16(tile * tl.d_b * size) + tile * tl.d_col * 4


def staged_tile(tl: TermList, size: int) -> int:
    """S1-A's edge tile: the first of STAGED_TILES whose block fits
    STAGED_SMEM, else 1.  At kbench's widths that is 2 edges fp32 and 4
    bf16 (11.6 KB), the fastest of 1, 2, 4 and 8 in both dtypes (dense
    0.272 ms against 0.282 for 4 edges fp32, 0.173 against 0.225 for 2
    bf16; kernel_ab's tiles, H100).  ``size``: bytes an element."""
    return next((t for t in STAGED_TILES if _staged_bytes(t, size, tl) <= STAGED_SMEM), 1)


def staged_plan(tl: TermList, z_slots: Optional[Slots], device: torch.device, vec: int,
                tile: int):
    """(chunks int32 [n, 4], term records int32 [n_t, 4], items int32
    [n_i], d_out) as csrc/dtp_t_variants.cu reads them.  ``z_slots`` None:
    K6-T's own chunks (``tl.chunks``), the dense output.  Otherwise each
    output tile (o, mul) of the terms is cut at its slot's column, and the
    slot's columns past mul into chunks of no terms (zeros): the output is
    [E, 128 * len(z_slots)].  Items (chunk << 8 | first row) cover every
    chunk and the rows of a ``tile``-edge tile, in order of falling cost."""
    key = ("staged", z_slots is not None, device, vec, tile)
    if key not in tl._tables:
        chunks, terms, _ = tl.chunks(vec)
        d_out = tl.d_out
        if z_slots is not None:
            runs = {o: (b, e) for o, _, b, e in tl._segments()[1] if e > b}
            if not set(runs) <= set(z_slots):
                raise ValueError("an output tile of the terms has no slot")
            segs = []
            for o, (slot, mul) in sorted(z_slots.items(), key=lambda kv: kv[1][0]):
                b, e = runs.get(o, (0, 0))
                segs.append((slot, mul, b, e))
                if mul < SLOT:
                    segs.append((slot + mul, SLOT - mul, e, e))
            chunks = cut_segments(segs, vec)[0]
            d_out = SLOT * len(z_slots)
        keyed = sorted(((tb - te - 1, k << 8 | r)
                        for k, (_, y, tb, te) in enumerate(chunks)
                        for r in range(0, tile, 32 >> ((y >> 8) & 7))), key=lambda kv: kv[0])
        tl._tables[key] = (_i32(chunks, 4, device), _term_records(terms, device),
                           _i32([it for _, it in keyed], 0, device), d_out)
    return tl._tables[key]


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
                 z_slots: Optional[Slots] = None, tile: Optional[int] = None) -> torch.Tensor:
    """S1-A: T(a, col, b) with a [E, d_a], col [E, d_col], b [E, d_b] (no
    broadcast rows), dense [E, d_out] or in ``z_slots``' 128-column layout.
    ``tile``: the edge tile to launch with instead of ``staged_tile``'s (a
    measurement's choice; the results do not depend on it).  CPU tensors
    take ``dtp_t_staged_plain``; CUDA tensors launch the kernel (float32 or
    bfloat16) or raise."""
    if col.device.type == "cpu":
        return dtp_t_staged_plain(tl, a, col, b, z_slots)
    E = col.shape[0]
    code = _build.dtype_code(col)
    col = _aligned16(_edge_rows(col, E, tl.d_col, col, "col"))
    a = _aligned16(_edge_rows(a, E, tl.d_a, col, "a"))
    b = _aligned16(_edge_rows(b, E, tl.d_b, col, "b"))
    vec = 4 if tl.vec4() else 1
    tile = tile or staged_tile(tl, col.element_size())
    chunks, terms, items, d_out = staged_plan(tl, z_slots, col.device, vec, tile)
    out = torch.empty((E, d_out), dtype=col.dtype, device=col.device)
    if E == 0:
        return out
    err = _build.library().dtp_t_staged(
        _build.ptr(a), tl.d_a, _build.ptr(col), tl.d_col, _build.ptr(b), tl.d_b, _build.ptr(out),
        d_out, E, tile, _build.ptr(chunks), _build.ptr(terms), _build.ptr(items), items.shape[0],
        vec, code, _build.stream_ptr())
    _build.check(err, "dtp_t_staged")
    dtp_t_staged.launches += 1
    return out


dtp_t_floor.launches = 0
dtp_t_staged.launches = 0
