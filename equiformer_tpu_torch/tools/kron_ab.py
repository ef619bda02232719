"""K8 (the kron-basis op) at the QM9 flagship's sites on one GPU, beside K1 / K2.

    python -m equiformer_tpu_torch.tools.kron_ab [--against FILE.cu ...] [--out FILE]

Builds the flagship's sep_act (two heads, per-edge w) and sep_value (shared
w folded into G) plans, makes random operands from seed 0 at E = 36352
edges with 34000 live rows, and for float32 and bfloat16 times (CUDA
events, median of 5 runs of 5 calls) K8-F and K8-B, each held against its
plain version (max |kernel - plain| / max |plain|), and K1 and K2 on the
same inputs (W in place of G).  With ``--against``, a second build of K8's
two sources (``dtp_lin.cu``: K8-F on K1's block; ``dtp_lin_bwd.cu``: K8-B
on K2's launches), each replaced by a given file of the same name (compiled with
the package's flags into ``build/kron_ab/``), runs in turns with the
package's kernels (package, other, other, package), so two versions of the
same C interface compare within one call (another tree's wrappers:
``kernel_ab --kernels K8F,K8B``).  Prints the card's name and power limit,
then the report as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..kernels import (
    _build,
    dtp_lin_bwd,
    dtp_lin_fwd,
    dtp_lin_kron_bwd,
    dtp_lin_kron_bwd_plain,
    dtp_lin_kron_fwd,
    dtp_lin_kron_plain,
    kron_meta,
)
from ..nn.tp_modules import SeparableFCTP
from ..utils.profiling import card_line, device_time_ms

E, N_LIVE, SEED = 36352, 34000, 0
IRR, SH = "128x0e+64x1e+32x2e", "1x0e+1x1e+1x2e"


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


SOURCES = ("dtp_lin.cu", "dtp_lin_bwd.cu")  # K8-F's and K8-B's


class _Other:
    """The K8 entry points of a second build of ``SOURCES``, each replaced by
    the file of its name in ``sources``, as ``_build.library()`` gives them."""

    def __init__(self, sources):
        mine = {p.name: p for p in sources}
        if not set(mine) <= set(SOURCES):
            raise SystemExit(f"kron_ab: --against takes files named {' or '.join(SOURCES)}")
        out = _build.BUILD_ROOT.parent / "kron_ab" / "libkron_other.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        srcs = [str(mine.get(name, _build.CSRC / name)) for name in SOURCES]
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                        "-o", str(out), *srcs], check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(out))
        for name in ("dtp_lin_kron_fwd", "dtp_lin_kron_bwd"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
            setattr(self, name, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", default=None,
                    help="another dtp_lin.cu and / or dtp_lin_bwd.cu to time in turns "
                         "with the package's")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kron_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)
    time_ms = lambda fn: device_time_ms(fn, dev)  # noqa: E731
    original = _build.library
    libs = {"package": original()}
    if args.against is not None:
        libs["other"] = _Other(args.against)
    order = ["package", "other", "other", "package"] if len(libs) > 1 else ["package"]
    sites = {
        "sep_act": SeparableFCTP(IRR, SH, IRR, fc_neurons=(128, 64, 64), use_activation=True,
                                 extra_head_irreps=("128x0e",), higher_order_grads=False).plan,
        "sep_value": SeparableFCTP(IRR, SH, IRR, internal_weights=True,
                                   higher_order_grads=False).plan,
    }
    report = {"card": card, "torch": torch.__version__, "E": E, "n_live": N_LIVE, "sites": {}}
    try:
        for site, plan in sites.items():
            meta = kron_meta(plan)
            for dt in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(SEED)
                rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)  # noqa: E731
                x, sh, cot = rnd(E, plan.d_x), rnd(E, plan.d_sh), rnd(E, plan.d_out)
                w = None if plan.shared_weights else rnd(E, plan.d_w)
                W = 0.05 * rnd(plan.w_numel)
                G = meta.build_G(W)
                n = torch.tensor(N_LIVE, dtype=torch.int32, device=dev)
                p_fwd = dtp_lin_kron_plain(meta, x, sh, w, G, n)
                p_bwd = dtp_lin_kron_bwd_plain(meta, x, sh, w, G, cot, n)
                runs = []
                for name in order:
                    _build.library = lambda lib=libs[name]: lib  # the wrappers' library
                    k_fwd = dtp_lin_kron_fwd(meta, x, sh, w, G, n)
                    k_bwd = dtp_lin_kron_bwd(meta, x, sh, w, G, cot, n)
                    runs.append({
                        "build": name,
                        "fwd_ms": time_ms(lambda: dtp_lin_kron_fwd(meta, x, sh, w, G, n)),
                        "bwd_ms": time_ms(lambda: dtp_lin_kron_bwd(meta, x, sh, w, G, cot, n)),
                        "fwd_rel_err": rel(k_fwd, p_fwd),
                        "bwd_rel_err": max(rel(a, b) for a, b in zip(k_bwd, p_bwd)
                                           if a is not None)})
                _build.library = original
                entry = {"runs": runs, "K1_ms": time_ms(lambda: dtp_lin_fwd(plan, x, sh, w, W, n)),
                         "K2_ms": time_ms(lambda: dtp_lin_bwd(plan, x, sh, w, W, cot, n))}
                report["sites"][f"{site}/{str(dt)[6:]}"] = entry
                print(site, str(dt)[6:], json.dumps(entry), flush=True)
    finally:
        _build.library = original
    text = json.dumps(report, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
