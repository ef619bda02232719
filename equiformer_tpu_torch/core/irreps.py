"""Irreducible-representation (irreps) metadata for O(3)-equivariant features.

Pure-Python, hashable metadata describing how a flat feature axis of size
``irreps.dim`` decomposes into irreps of O(3).  The same parser, ordering and
sorting rules as ``equiformer_tpu.core.irreps``, so a plan built from the same
string has the same blocks in the same order in both packages.  Feature values
are stored component-major inside each block (see ``core.tensor_product``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterator, List, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True, order=True)
class Irrep:
    """Degree ``l`` and parity ``p`` (+1 'e', -1 'o'); ``dim = 2l + 1``."""

    l: int
    p: int

    def __post_init__(self):
        if self.l < 0:
            raise ValueError(f"l must be >= 0, got {self.l}")
        if self.p not in (1, -1):
            raise ValueError(f"p must be +1 or -1, got {self.p}")

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    @staticmethod
    def parse(s: Union[str, "Irrep"]) -> "Irrep":
        if isinstance(s, Irrep):
            return s
        m = re.fullmatch(r"(\d+)([eo])", s.strip())
        if not m:
            raise ValueError(f"cannot parse irrep {s!r}")
        return Irrep(int(m.group(1)), 1 if m.group(2) == "e" else -1)

    def __str__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    __repr__ = __str__

    def __mul__(self, other: "Irrep") -> Iterator["Irrep"]:
        """Selection rule: irreps appearing in the tensor product self (x) other."""
        other = Irrep.parse(other)
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)

    def is_scalar(self) -> bool:
        return self.l == 0 and self.p == 1


@dataclasses.dataclass(frozen=True)
class MulIrrep:
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __str__(self) -> str:
        return f"{self.mul}x{self.ir}"

    __repr__ = __str__

    def __iter__(self):
        yield self.mul
        yield self.ir


IrrepsLike = Union[str, "Irreps", Sequence]


class Irreps(tuple):
    """An ordered sequence of ``(mul, Irrep)`` blocks, e.g. ``"128x0e+64x1e+32x2e"``."""

    def __new__(cls, irreps: IrrepsLike = None):
        if irreps is None:
            return super().__new__(cls, ())
        if isinstance(irreps, Irreps):
            return super().__new__(cls, tuple(irreps))
        if isinstance(irreps, Irrep):
            return super().__new__(cls, (MulIrrep(1, irreps),))
        items = []
        if isinstance(irreps, str):
            s = irreps.strip()
            for part in s.split("+") if s else ():
                part = part.strip()
                if "x" in part:
                    mul_s, ir_s = part.split("x")
                    items.append(MulIrrep(int(mul_s), Irrep.parse(ir_s)))
                else:
                    items.append(MulIrrep(1, Irrep.parse(part)))
            return super().__new__(cls, tuple(items))
        for entry in irreps:
            if isinstance(entry, MulIrrep):
                items.append(entry)
            else:
                mul, ir = entry
                items.append(MulIrrep(int(mul), Irrep.parse(ir)))
        return super().__new__(cls, tuple(items))

    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        return sum(mi.mul for mi in self)

    def slices(self) -> List[slice]:
        out, i = [], 0
        for mi in self:
            out.append(slice(i, i + mi.dim))
            i += mi.dim
        return out

    def simplify(self) -> "Irreps":
        """Merge consecutive blocks with identical irrep; drop zero multiplicities."""
        out: List[MulIrrep] = []
        for mi in self:
            if mi.mul == 0:
                continue
            if out and out[-1].ir == mi.ir:
                out[-1] = MulIrrep(out[-1].mul + mi.mul, mi.ir)
            else:
                out.append(mi)
        return Irreps(out)

    def sort_even_first(self) -> Tuple["Irreps", Tuple[int, ...], Tuple[int, ...]]:
        """Stable sort of the blocks by (l, even before odd).

        Returns ``(irreps, p, inv)``: ``p`` maps old block index -> new block
        index and ``inv`` is its inverse.
        """
        inv = tuple(
            sorted(range(len(self)), key=lambda i: (self[i].ir.l, -self[i].ir.p))
        )
        p = tuple(inv.index(i) for i in range(len(self)))
        return Irreps([self[i] for i in inv]), p, inv

    def __add__(self, other) -> "Irreps":
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def __mul__(self, n: int) -> "Irreps":
        if not isinstance(n, int):
            raise TypeError("Irreps can only be multiplied by int")
        return Irreps(tuple(self) * n)

    def __contains__(self, ir) -> bool:
        ir = Irrep.parse(ir)
        return any(mi.ir == ir for mi in self)

    def count(self, ir) -> int:
        ir = Irrep.parse(ir)
        return sum(mi.mul for mi in self if mi.ir == ir)

    def __repr__(self) -> str:
        return "+".join(str(mi) for mi in self) if len(self) else "(empty)"

    def filter_scalars_even(self) -> "Irreps":
        """The even scalar (0e) blocks, in order."""
        return Irreps([mi for mi in self if mi.ir.is_scalar()])
