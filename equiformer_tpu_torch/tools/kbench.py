"""K6-T (the unfused DTP's forward T) at the flagship's shapes beside its
design variants, to place it against its shapes' floor.

    python -m equiformer_tpu_torch.tools.kbench [--device cpu] [--fp32]
        [--edges 40960] [--out FILE]

Counterpart of ``scripts/kbench.py``.  Irreps ``128x0e+64x1e+32x2e`` times
SH ``1x0e+1x1e+1x2e`` (d_x 480, d_w 960, z 3136), random operands from
seed 0, bfloat16 (``--fp32``: float32).  Each variant is timed with CUDA
events (median of 5 runs of 5 calls) and reported with the bytes its
function must move (inputs read once, the output written once) over its
time:

* ``current``: K6-T ``dtp_t`` (``csrc/dtp_t.cu``);
* ``dmafloor``: S1-F ``dtp_t_floor``, which moves T's bytes and computes
  nothing: the floor;
* ``aligned-in``: S1-A ``dtp_t_staged``, T with each edge tile staged in
  shared memory once, z dense;
* ``aligned-i/o``: the same with z in 128-column slots (``make_layouts``);
* ``fusedlin``: K1 ``dtp_lin_fwd``, the fused DTP + linear forward that the
  script's prototype became, heads ``224x0e+64x1e+32x2e`` (the weights of
  the next variant's linear map);
* ``cur+xla-lin``: K6-T and then ``IrrepsLinear``: the composition K1
  replaces.

``fusedlin`` (the script's fused prototype, S1-P) also gets its bound: the
larger of its bytes (plus the packed heads' weights) over 3.35 TB/s and its
operations (2 a multiply-add of the heads, 4 a TP term element) over 67
TFLOP/s fp32 or 989 bf16, the H100's published rates.

The script's ``--tile`` and ``--interpret`` are TPU settings and have no
counterpart: the CUDA kernels choose their own tiles, and ``--device cpu``
runs the plain versions.  Prints the card's name and power limit, then the
report as JSON (also to ``--out``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..core import Irreps, depthwise_tp
from ..kernels import (
    DTPLinPlan,
    TermList,
    dtp_lin_fwd,
    dtp_t,
    dtp_t_floor,
    dtp_t_staged,
    make_layouts,
)
from ..nn.linear import IrrepsLinear
from ..utils.profiling import card_line, device_time_ms, resolve_device

IRR, SH, LIN_OUT = "128x0e+64x1e+32x2e", "1x0e+1x1e+1x2e", "224x0e+64x1e+32x2e"
VARIANTS = ("current", "dmafloor", "aligned-in", "aligned-i/o", "fusedlin", "cur+xla-lin")
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def flagship_tp():
    irr = Irreps(IRR)
    return depthwise_tp(irr, Irreps(SH), irr)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu for the plain versions (default: the card)")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--edges", type=int, default=40960)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (plain versions, host clock)"
    print(card, flush=True)
    dt = torch.float32 if args.fp32 else torch.bfloat16
    E = args.edges

    tp = flagship_tp()
    tl = TermList.for_plan(tp, fold_rescale=True)
    d_x, d_sh, d_w, d_z = tl.d_a, tl.d_col, tl.d_b, tl.d_out
    z_slots = make_layouts(tp)[4]
    d_z_al = 128 * len(z_slots)
    gen = torch.Generator().manual_seed(0)
    lin = IrrepsLinear(tp.irreps_out, LIN_OUT, use_bias=False)
    lin.init_(gen)
    lin = lin.to(dev, dt)
    plan = DTPLinPlan(tp, [LIN_OUT])
    W = plan.pack_weights([[None if t is None else t.detach() for t in lin.weight_list()]])
    d_lin = plan.d_out
    g = torch.Generator(device=dev).manual_seed(0)
    x, sh, w = (torch.randn(E, d, generator=g, device=dev).to(dt) for d in (d_x, d_sh, d_w))

    size = x.element_size()
    calls = {
        "current": (lambda: dtp_t(tl, x, sh, w), d_z),
        "dmafloor": (lambda: dtp_t_floor(x, sh, w, d_z), d_z),
        "aligned-in": (lambda: dtp_t_staged(tl, x, sh, w), d_z),
        "aligned-i/o": (lambda: dtp_t_staged(tl, x, sh, w, z_slots), d_z_al),
        "fusedlin": (lambda: dtp_lin_fwd(plan, x, sh, w, W), d_lin),
        "cur+xla-lin": (lambda: lin(dtp_t(tl, x, sh, w)), d_lin),
    }
    report = {"card": card, "device": str(dev), "torch": torch.__version__, "dtype": str(dt)[6:],
              "edges": E, "dims": {"x": d_x, "sh": d_sh, "w": d_w, "z": d_z, "z_aligned": d_z_al,
                                   "lin": d_lin, "terms": len(tl.terms)},
              "variants": {}}
    with torch.no_grad():
        for name in VARIANTS:
            fn, d_out = calls[name]
            ms = device_time_ms(fn, dev)
            nbytes = E * (d_x + d_sh + d_w + d_out) * size
            report["variants"][name] = {"ms": ms, "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6}
            print(f"{name:12s}: {ms:9.4f} ms  ({nbytes / 1e6:.0f} MB, {nbytes / ms / 1e6:.0f} GB/s)",
                  flush=True)
        fl = report["variants"]["fusedlin"]
        flops = E * (2 * sum(g.ir.dim * g.fan * g.cols for g in plan.groups)
                     + 4 * sum(t.mul for t, _ in plan.terms))
        t_mem = (fl["bytes"] + plan.w_numel * size) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dt] * 1e3
        fl["bound_ms"], fl["bound_by"] = max((t_mem, "bytes"), (t_ops, "operations"))
        # the fused op and the composition it replaces compute one function
        fused = plan.split_output(dtp_lin_fwd(plan, x, sh, w, W))[0].float()
        comp = lin(dtp_t(tl, x, sh, w)).float()
        report["fusedlin_vs_composition_rel"] = float(
            (fused - comp).abs().max() / comp.abs().max().clamp_min(1e-30))
    text = json.dumps(report, indent=1)
    print(text, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return report


if __name__ == "__main__":
    main()
