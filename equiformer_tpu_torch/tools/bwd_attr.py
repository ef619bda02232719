"""K2 (the fused DTP + linear backward) timed phase by phase.

    python -m equiformer_tpu_torch.tools.bwd_attr [--device cpu] [--edges 46848]
        [--qm9] [--out FILE]

Counterpart of ``scripts/bwd_attr.py``.  ``dtp_lin_bwd_stage`` (S3) is K2
cut after each of its phases, in the kernels' order (``BWD_STAGES``).
K2's first launch (dx, dw): the tile loop, zeroing and the x / w staging,
+ G staged in shared memory, + the dz product on the tensor cores, + the
term transposes and the dx / dw flush; its second launch (dW): the loop
and G's column slices staged, + z recomputed, + the dW product and the
partial rows' fixed-order sum (the whole of K2).  Each stage is timed with
CUDA events (median of 5 runs of 5 calls) in float32 and bfloat16 on the
flagship's ``sep_act`` plan
(irreps ``128x0e+64x1e+32x2e``, heads ``224x0e+64x1e+32x2e`` and the
attention's ``128x0e``), and printed with its delta from the stage before.
The TPU script's first stage (copying x and w into 128-lane slots) has no
counterpart: the kernel reads them in place.

Operands are random from seed 0: E = ``--edges`` rows (the script's 46848),
or with ``--qm9`` the real edges of batch 0 of ``chip_smoke.py``'s QM9
geometry (128 QM9-like graphs of 30 slots, seed 0, radius 5) with their SH.
Prints the card's name and power limit, then the report as JSON (also to
``--out``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..core import Irreps
from ..kernels import dtp_lin_bwd_stage
from ..kernels.dtp_lin import BWD_STAGES
from ..nn.tp_modules import SeparableFCTP
from ..utils.profiling import card_line, device_time_ms, resolve_device

IRR, SH = "128x0e+64x1e+32x2e", "1x0e+1x1e+1x2e"
QM9_GRAPHS, QM9_SLOTS, QM9_RADIUS, SEED = 128, 30, 5.0, 0


def sep_act_plan():
    """The QM9 flagship's sep_act plan: the gated output and the attention
    weights read one TP output."""
    return SeparableFCTP(IRR, SH, IRR, fc_neurons=(128, 64, 64), use_activation=True,
                         extra_head_irreps=("128x0e",), higher_order_grads=False).plan


def qm9_sh(dev) -> torch.Tensor:
    """float32 SH [n, 9] of the real edges of batch 0 of chip_smoke.py's QM9
    geometry (its batches come from 4 x 128 graphs; batch 0 is the first
    128)."""
    from ..core.spherical import spherical_harmonics_for_irreps
    from ..data import GraphLoader, qm9_like_dataset
    from ..graph.radius_graph import edge_vectors, radius_graph_dense, reverse_edge_perm_dense

    data = qm9_like_dataset(4 * QM9_GRAPHS, seed=SEED)
    batch = next(iter(GraphLoader(data, QM9_GRAPHS, dense_slots=QM9_SLOTS, shuffle=False))).to(dev)
    edges = radius_graph_dense(batch.pos, batch.node_mask, QM9_GRAPHS, QM9_RADIUS,
                               QM9_GRAPHS * QM9_SLOTS * QM9_SLOTS)
    edges = edges._replace(rev=reverse_edge_perm_dense(edges, QM9_GRAPHS, QM9_SLOTS))
    vec, _ = edge_vectors(batch.pos, edges)
    return spherical_harmonics_for_irreps(Irreps(SH), vec)[edges.mask]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu for the plain versions (default: the card)")
    ap.add_argument("--edges", type=int, default=46848)
    ap.add_argument("--qm9", action="store_true",
                    help="batch 0 of chip_smoke.py's QM9 geometry, real edges only")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (plain versions, host clock)"
    print(card, flush=True)
    plan = sep_act_plan()
    if args.qm9:
        sh32 = qm9_sh(dev)
    else:
        sh32 = torch.randn(args.edges, plan.d_sh, generator=torch.Generator(device=dev)
                           .manual_seed(SEED + 1), device=dev)
    E = sh32.shape[0]
    report = {"card": card, "device": str(dev), "torch": torch.__version__,
              "geometry": "qm9 batch 0" if args.qm9 else "random", "edges": E,
              "plan": {"d_x": plan.d_x, "d_w": plan.d_w, "d_out": plan.d_out,
                       "w_numel": plan.w_numel},
              "stages": list(BWD_STAGES), "times": {}}
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(SEED)
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)  # noqa: E731
        x, w, cot = rnd(E, plan.d_x), rnd(E, plan.d_w), rnd(E, plan.d_out)
        W, sh = 0.05 * rnd(plan.w_numel), sh32.to(dt)
        name, prev, rows = str(dt)[6:], 0.0, []
        for stage, label in enumerate(BWD_STAGES):
            ms = device_time_ms(lambda: dtp_lin_bwd_stage(plan, x, sh, w, W, cot, stage), dev)
            rows.append({"stage": stage, "name": label, "ms": ms, "delta_ms": ms - prev})
            print(f"{name:8s} {label:12s}: {ms:8.4f} ms  (delta {ms - prev:+8.4f})", flush=True)
            prev = ms
        report["times"][name] = rows
    text = json.dumps(report, indent=1)
    print(text, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return report


if __name__ == "__main__":
    main()
