"""Each CUDA kernel's registers, spills and shared memory, as ptxas reports
them, and the difference from another tree's sources.

    python -m equiformer_tpu_torch.tools.ptxas_report [--sources a.cu ...]
        [--against DIR [--match REGEX]] [--out FILE]

Compiles the package's ``csrc/*.cu`` (or the named ones) with the build's
flags (``kernels/_build.py``: ``-Xptxas -v``, sm_90a) and prints one line
per entry function: the demangled name, then the ``Used N registers`` and
stack / spill lines.  With ``--against DIR`` (another tree's ``csrc``) that
tree's sources are compiled too (all of its own, or those of the named
ones it has), and every kernel of the other tree is matched by name to
this tree's and reported as equal, different, or not in this tree (a
retired kernel, also one whose source is gone); ``--match`` compares only
the kernels whose names it finds.  The exit code is 1 if a kernel that both
trees have differs.  Needs nvcc (the machine with the card).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from ..kernels import _build

def entries(csrc: Path, sources) -> dict:
    """{demangled kernel name: [ptxas property lines]} of the sources; a
    kernel compiled in several sources with the same lines (a ``static``
    one of a shared header) is listed once."""
    found = {}
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-c", "-o",
                               "/dev/null", str(csrc / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in sources]  # one nvcc a source, all started together
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, proc.args, out, err)
        cur, mine = None, {}
        for ln in (out + err).splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
            if m:
                cur = m.group(1)
            elif cur and ("registers" in ln or "stack frame" in ln):
                mine.setdefault(cur, []).append(re.sub(r"^ptxas info\s*:\s*", "", ln.strip()))
        for name, lines in mine.items():
            found.setdefault(name, set()).add(tuple(lines))
    cufilt = Path(_build._nvcc()).with_name("cu++filt")
    names = subprocess.run([str(cufilt)], input="\n".join(found), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return {_short(n): [ln for lines in sorted(found[m]) for ln in lines]
            for n, m in zip(names, found)}


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


def _sources(csrc: Path, names) -> list:
    """The named sources that ``csrc`` has, or all of its ``*.cu``."""
    if names is None:
        return sorted(p.name for p in csrc.glob("*.cu"))
    return [n for n in names if (csrc / n).exists()]


def compare(mine: dict, other: dict, match=None) -> dict:
    """The other tree's kernels (those whose names ``match`` finds) against
    this tree's, by name: {"equal", "differ", "not_here", "new_here"}, each
    a list of names (``new_here``: this tree's kernels the other lacks)."""
    other = {n: v for n, v in other.items() if match is None or re.search(match, n)}
    out = {"equal": [], "differ": [], "not_here": [],
           "new_here": [n for n in mine if n not in other]}
    for name, lines in other.items():
        key = "not_here" if name not in mine else "equal" if mine[name] == lines else "differ"
        out[key].append(name)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", nargs="+", default=None, help="file names in csrc/ (default: all)")
    ap.add_argument("--against", type=Path, default=None, help="another tree's csrc directory")
    ap.add_argument("--match", default=None,
                    help="compare only the kernels whose names this regex finds")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    mine = entries(_build.CSRC, _sources(_build.CSRC, args.sources))
    for name, lines in mine.items():
        print(f"{name}: {'; '.join(lines)}")
    report, differs = {"kernels": mine}, []
    if args.against is not None:
        other = entries(args.against, _sources(args.against, args.sources))
        res = compare(mine, other, args.match)
        for key, verdict in (("equal", "equal"), ("differ", "DIFFERS"),
                             ("not_here", "not in this tree"), ("new_here", "new in this tree")):
            for name in res[key]:
                there = f" (there: {'; '.join(other[name])})" if key == "differ" else ""
                print(f"against {args.against}: {name}: {verdict}{there}")
        differs = res["differ"]
        report["against"] = {"dir": str(args.against), **res}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1) + "\n")
    return 1 if differs else 0


if __name__ == "__main__":
    raise SystemExit(main())
