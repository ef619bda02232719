"""Each CUDA kernel's registers, spills and shared memory, as ptxas reports
them, and the difference from another tree's sources.

    python -m equiformer_tpu_torch.tools.ptxas_report [--sources a.cu ...]
        [--against DIR [--match REGEX]] [--sass REGEX [--sass-out FILE]] [--out FILE]

Compiles the package's ``csrc/*.cu`` (or the named ones) with the build's
flags (``kernels/_build.py``: ``-Xptxas -v``, sm_90a) and prints one line
per entry function: the demangled name, then the ``Used N registers`` and
stack / spill lines.  With ``--against DIR`` (another tree's ``csrc``) that
tree's sources are compiled too (all of its own, or those of the named
ones it has), and every kernel of the other tree is matched by name to
this tree's and reported as equal, different, or not in this tree (a
retired kernel, also one whose source is gone); ``--match`` compares only
the kernels whose names it finds.  The exit code is 1 if a kernel that both
trees have differs.  ``--sass REGEX`` also compiles the sources to
cubins, disassembles them (``cuobjdump -sass``) and prints, for each
kernel whose demangled name the regex finds, its instruction count by
opcode (``HFMA2.BF16_V2``, ``FFMA``, ``LDG.E.128``, ...) and the
instructions of its longest run without a branch, the unrolled body of its
hottest loop; ``--sass-out`` keeps those kernels' whole listings.  Needs
nvcc (the machine with the card).
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


def sass(csrc: Path, sources, pattern: str) -> dict:
    """{demangled kernel name: its SASS lines} of the kernels of the
    sources whose names ``pattern`` finds."""
    import tempfile

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    cufilt = Path(_build._nvcc()).with_name("cu++filt")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in sources:
            cubin = Path(tmp) / (Path(name).stem + ".cubin")
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-cubin", "-o",
                            str(cubin), str(csrc / name)], capture_output=True, text=True,
                           check=True)
            text = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True,
                                  text=True, check=True).stdout
            for block in text.split("Function : ")[1:]:
                mangled, _, body = block.partition("\n")
                full = subprocess.run([str(cufilt)], input=mangled.strip(), capture_output=True,
                                      text=True, check=True).stdout.strip()
                if re.search(pattern, full):
                    out[_short(full) + f" [{mangled.strip()}]"] = [
                        ln.strip() for ln in body.splitlines() if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
    return out


def sass_summary(lines) -> dict:
    """Instruction counts by opcode, and the longest run of instructions
    without a branch (the unrolled body of the hottest loop)."""
    ops, runs, cur = {}, [], []
    for ln in lines:
        m = re.match(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if not m:
            continue
        op = m.group(1)
        ops[op] = ops.get(op, 0) + 1
        cur.append(ln.split(";")[0])
        if op.startswith(("BRA", "EXIT", "RET", "BSYNC", "WARPSYNC")):
            runs.append(cur)
            cur = []
    runs.append(cur)
    return {"opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
            "longest_straight_run": max(runs, key=len)}


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
    ap.add_argument("--sass", default=None,
                    help="disassemble the kernels whose names this regex finds")
    ap.add_argument("--sass-out", type=Path, default=None, help="their whole SASS listings")
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
    if args.sass is not None:
        listings = sass(_build.CSRC, _sources(_build.CSRC, args.sources), args.sass)
        report["sass"] = {}
        for name, lines in listings.items():
            summ = report["sass"][name] = sass_summary(lines)
            print(f"sass {name}: {len(lines)} instructions, by opcode {summ['opcodes']}")
            run = summ["longest_straight_run"]
            print(f"sass {name}: longest run without a branch, {len(run)} instructions:")
            for ln in run:
                print(f"    {ln}")
        if args.sass_out is not None:
            args.sass_out.parent.mkdir(parents=True, exist_ok=True)
            args.sass_out.write_text("".join(f"== {n}\n" + "\n".join(v) + "\n"
                                             for n, v in listings.items()))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1) + "\n")
    return 1 if differs else 0


if __name__ == "__main__":
    raise SystemExit(main())
