"""Each CUDA kernel's registers, spills and shared memory, as ptxas reports
them, and the difference from another tree's sources.

    python -m equiformer_tpu_torch.tools.ptxas_report [--sources a.cu ...]
        [--against DIR [--match REGEX]] [--out FILE]

Compiles the package's ``csrc/*.cu`` (or the named ones) with the build's
flags (``kernels/_build.py``: ``-Xptxas -v``, sm_90a) and prints one line
per entry function: the demangled name, then the ``Used N registers`` and
stack / spill lines.  With ``--against DIR`` (another tree's ``csrc``) the
same sources are compiled from there too, and every kernel of the other
tree is matched to this tree's (the first design's ``kStage`` argument,
which one tree may have and the other not, is matched at its default 5)
and reported as equal or different; ``--match`` compares only the kernels
whose names it finds (for K7-B alone, when K2 itself was redesigned:
``'dtp_lin_bwd_kernel<[^,]*, .bool.1>'``).  The exit code is 1 if a
compared kernel differs.  Needs nvcc (the machine with the card).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from ..kernels import _build

# the first K2 design's trailing stage argument at its default (kStage = 5)
_DEFAULT_STAGE = re.compile(r"(dtp_lin_bwd_kernel<[^,<>]+, [^,<>]+), (?:\(int\))?5>")


def entries(csrc: Path, sources) -> dict:
    """{demangled kernel name: [ptxas property lines]} of the sources."""
    found = {}
    for name in sources:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-c", "-o", "/dev/null",
               str(csrc / name)]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        cur = None
        for ln in (out.stdout + out.stderr).splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
            if m:
                cur = m.group(1)
            elif cur and ("registers" in ln or "stack frame" in ln):
                found.setdefault(cur, []).append(re.sub(r"^ptxas info\s*:\s*", "", ln.strip()))
    cufilt = Path(_build._nvcc()).with_name("cu++filt")
    names = subprocess.run([str(cufilt)], input="\n".join(found), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return {_short(n): found[m] for n, m in zip(names, found)}


def _short(name: str) -> str:
    """The demangled name without its parameter list and namespace noise."""
    name = name.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            return name[:i].removeprefix("void ")
    return name.removeprefix("void ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", nargs="+", default=None, help="file names in csrc/ (default: all)")
    ap.add_argument("--against", type=Path, default=None, help="another tree's csrc directory")
    ap.add_argument("--match", default=None,
                    help="compare only the kernels whose names this regex finds")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sources = args.sources or sorted(p.name for p in _build.CSRC.glob("*.cu"))
    mine = entries(_build.CSRC, sources)
    for name, lines in mine.items():
        print(f"{name}: {'; '.join(lines)}")
    report, differs = {"kernels": mine}, []
    if args.against is not None:
        other = {_DEFAULT_STAGE.sub(r"\1>", n): v
                 for n, v in entries(args.against, sources).items()
                 if args.match is None or re.search(args.match, _DEFAULT_STAGE.sub(r"\1>", n))}
        at_default = {_DEFAULT_STAGE.sub(r"\1>", n): v for n, v in mine.items()}
        for name, lines in other.items():
            same = at_default.get(name) == lines
            print(f"against {args.against}: {name}: "
                  + ("equal" if same else f"DIFFERS (there: {'; '.join(lines)})"))
            if not same:
                differs.append(name)
        report["against"] = {"dir": str(args.against), "compared": len(other), "differ": differs}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1) + "\n")
    return 1 if differs else 0


if __name__ == "__main__":
    raise SystemExit(main())
