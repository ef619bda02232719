"""Where the time of an eval forward, a training step or a force evaluation goes, on one GPU.

    python -m equiformer_tpu_torch.tools.profile_eval [--train | --md17 | --md17-train | --dens]
        [--unfused [--first-order-bwd] | --radial-fold | --kron-g] [--packed] [--remat]
        [--out FILE]

Builds ``graph_attention_transformer_nonlinear_l2`` at full width with a
seeded init, on 4 batches of 128 QM9-like graphs (30 node slots each,
``max_edges`` the largest batch's real edge count rounded up to 128, as in
``chip_smoke.py``).  The unit is one ``evaluate`` forward, or with
``--train`` one step of ``make_qm9_steps`` (AdamW with the no-decay mask,
``cosine_warmup_schedule(5e-4, 100, 100000)``, weight decay 5e-3, alpha
dropout 0.2 from a CUDA generator, EMA 0.999).  With ``--md17`` the model is
``graph_attention_transformer_nonlinear_exp_l3_md17`` on 4 batches of 8
md17-like molecules (21 slots) and the unit one ``evaluate_md17`` (energies
and forces); with ``--md17-train`` the unit is one step of
``make_md17_steps`` on the same model and batches (``energy_weight=1``,
``force_weight=80``, AdamW with weight decay 1e-6 and the same schedule, EMA
0.999: the forward, the force pass with ``create_graph=True`` and the
grad-of-grad).  With ``--dens`` the model is ``equiformer_md17_dens`` at
the aspirin L3 recipe (``models.dens.ASPIRIN_L3``) on the same batches
(``max_edges`` every ordered pair of atoms, 3456: the radius graph is
rebuilt from noised positions inside the step) and the unit one step of
``make_dens_steps`` with the recipe's settings (``ASPIRIN_L3_TRAIN``: the
noise drawn from a CUDA generator, the force pass and the grad-of-grad, the
denoising head's first-order backward); only the fused route.
``--unfused`` builds the model with ``fused_dtp_lin=False``:
every DTP call site on the T / R primitives (K6) with the linear heads
after it, instead of the fused DTP + linear op; with ``--first-order-bwd``
(QM9 training only: the force models differentiate twice) also
``dtp_first_order_bwd=True``, each site's backward one K6-FB launch.
``--radial-fold`` builds it with ``radial_fold=True`` (and for ``--md17``
and ``--md17-train`` also ``radial_fold_ho``): the radial MLPs' final
linear layers of the 7 per-edge-weight sites run inside the fused op (K7-F forward; K7-B, or K7-B3
for the force pass, backward; in force training's grad-of-grad also the
leg kernels K7-L, K7-LW and K7-Wr).  ``--kron-g`` (QM9 only: the force
models ignore the switch) builds it with ``kron_g=True``: all 13 fused DTP
sites on the kron-basis op (K8-F forward, K8-B backward).  ``--packed``
takes the same molecules in the packed layout (``nodes_per_graph=0``:
``collate``, the [N, N] radius graph, the src side of the gathers'
backward through the src-sort plan) at the CLIs' capacities: node rows 30
a graph and 17 edges a node row for QM9 (``cli/train_qm9.py:58-59``: 3840
and 65280), the atoms and atoms + 1 edges a node row for the force models
(``cli/train_md17.py:83-84``: 256 and 5632).  ``--remat`` (not with
``--dens``: the DeNS model has no remat, as in JAX) builds the model with
``remat=True``, as both CLIs do: each TransBlock's forward runs again in the
backward (twice in force training: in the force pass and in the parameter
pass).  For float32 and bfloat16, per unit:

* ``wall_ms``: one pass over the batches, ending in a synchronize, divided
  by the batch count (median of 5 passes, no profiler);
* ``enqueue_ms``: host time until the call returns, without a synchronize
  (median over 3 x the batches, no profiler);
* from a ``torch.profiler`` trace of one pass: ``device_busy_ms`` (union of
  the kernel, memcpy and memset intervals), ``launches`` (kernels), the 12
  kernels with the most device time: [name, ms, calls] per unit, and
  ``kernel_groups``: [ms, calls] per unit of every kernel whose name holds
  one of ``KERNEL_GROUPS`` (K2's two launches, the fixed-order partial-row
  sum that K2, K5c and the K7 kernels share, K3, K7-B's two launches apart
  from K2's, K1, K4, K5b's x and w legs and K5c apart from K2, K5a and its
  partial sum, K5b's sh leg, K7-Wr's d[Wr; offset] tiles (its dw is K5b's
  w leg), K7-LW's dW tiles, K8-B's two launches, K8-F on K1's block,
  K7-B3 on K2's launch 1, K7-F on K1's block and K7-L's legs on K2's
  launch 1; the split partials' sum of K5a, K5b, K7-L and K7-B3; K6-T,
  K6-R and K6-FB), and
  ``annotated``: [ms, calls]
  per unit of the kernels inside each ``record_function`` range of
  ``ANNOTATIONS`` (K4's backward, torch ops);
* ``idle_share``: 1 - device_busy_ms / wall_ms, the share of the unprofiled
  wall time in which the device has nothing to run;
* ``peak_mib``: ``torch.cuda.max_memory_allocated`` over the wall passes.

Prints the card's name and power limit, then the report as JSON (also
written to ``--out``).  The traces land in ``build/profile/``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from .. import (
    cosine_warmup_schedule,
    create_optimizer,
    evaluate,
    evaluate_md17,
    make_dens_steps,
    make_md17_steps,
    make_qm9_steps,
    model_entrypoint,
)
from ..models.dens import ASPIRIN_L3, ASPIRIN_L3_TRAIN, every_pair_edges
from ..data import GraphLoader, md17_like_dataset, qm9_like_dataset
from ..train import TrainState
from ..graph.batching import cli_capacities
from ..graph.radius_graph import radius_graph_dense
from ..kernels.attn_csr import ATTN_BWD_RANGE
from ..utils.profiling import card_line

N_BATCHES = 4
SEED = 0
# model, graphs per batch, node slots per graph
QM9 = ("graph_attention_transformer_nonlinear_l2", 128, 30)
MD17 = ("graph_attention_transformer_nonlinear_exp_l3_md17", 8, 21)
DENS = ("equiformer_md17_dens", 8, 21)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"
KERNEL_GROUPS = ("k2::dxdw_kernel", "k2::dW_kernel", "sum_partial_rows_kernel",
                 "csr_segment_sum_kernel", "k2::rad_dxdw_kernel", "k2::rad_dW_kernel",
                 "k1::fwd_kernel", "attn_combine_kernel", "k2::edge_leg_kernel",
                 "k2::split_sum_kernel", "k2::W_leg_kernel", "k2::bwd3_kernel",
                 "k2::sh_leg_kernel", "k2::Wr_leg_kernel", "k2::rad_W_leg_kernel",
                 "k2::kron_dxdw_kernel", "k2::kron_dG_kernel", "k1::kron_fwd_kernel",
                 "k2::rad_bwd3_kernel", "k1::rad_fwd_kernel", "k2::rad_leg_kernel",
                 "dtp_t_kernel", "dtp_r_kernel", "dtp_fused_bwd_kernel")
ANNOTATIONS = (ATTN_BWD_RANGE,)


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def trace_summary(path: Path, n_forwards: int) -> dict:
    """Device busy time, launches and per-kernel time of a chrome trace
    that holds ``n_forwards`` units (forwards or steps)."""
    events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise RuntimeError(f"the trace {path} holds no device events")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    by_name: dict = {}
    for e in dev:
        if e["cat"] == "kernel":
            us, calls = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (us + float(e["dur"]), calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    groups = {}
    for pattern in KERNEL_GROUPS:
        hits = [v for name, v in by_name.items() if pattern in name]
        groups[pattern] = [sum(us for us, _ in hits) / 1e3 / n_forwards,
                           sum(c for _, c in hits) / n_forwards]
    annotated = {}
    for name in ANNOTATIONS:  # the kernels that ran inside the range's spans on the card
        ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("cat") == "gpu_user_annotation" and e.get("name") == name]
        hits = [float(e["dur"]) for e in dev if e["cat"] == "kernel" and any(
            a <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= b for a, b in ranges)]
        annotated[name] = [sum(hits) / 1e3 / n_forwards, len(hits) / n_forwards]
    return {
        "device_busy_ms": _union_us(spans) / 1e3 / n_forwards,
        "launches": sum(e["cat"] == "kernel" for e in dev) / n_forwards,
        "kernels": [[name, us / 1e3 / n_forwards, calls / n_forwards]
                    for name, (us, calls) in top],
        "kernel_groups": groups,
        "annotated": annotated,
    }


def profile(run, batches, tag: str) -> dict:
    """``run(batch)`` is one unit: an eval forward, a training step or a
    force evaluation."""
    n = len(batches)
    graphs = int(batches[0].graph_mask.shape[0])
    for b in batches:  # warm-up
        run(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        for b in batches:
            run(b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) / n * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    enqueue = []
    for _ in range(3):
        for b in batches:
            t = time.perf_counter()
            run(b)
            enqueue.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches:
            run(b)
        torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{tag}.json"
    prof.export_chrome_trace(str(path))
    wall = statistics.median(walls)
    trace = trace_summary(path, n)
    return {"wall_ms": wall, "wall_ms_passes": walls, "graphs_per_s": graphs * 1e3 / wall,
            "enqueue_ms": statistics.median(enqueue), "peak_mib": peak,
            "idle_share": 1.0 - trace["device_busy_ms"] / wall, **trace}


def eval_unit(model):
    model.eval()
    return lambda b: evaluate(model, b)


def md17_unit(model):
    model.eval()
    return lambda b: evaluate_md17(model, b)


def train_unit(model):
    opt = create_optimizer(cosine_warmup_schedule(5e-4, 100, 100000), weight_decay=5e-3)
    step, _ = make_qm9_steps(model, opt, 0.0, 1.0, "l1", ema_decay=0.999)
    state = TrainState.create(model, opt)
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(SEED)
    return lambda b: step(state, b, gen)


def md17_train_unit(model):
    opt = create_optimizer(cosine_warmup_schedule(5e-4, 100, 100000), weight_decay=1e-6)
    step, _ = make_md17_steps(model, opt, energy_weight=1.0, force_weight=80.0, ema_decay=0.999)
    state = TrainState.create(model, opt)
    return lambda b: step(state, b)


def dens_train_unit(model):
    opt = create_optimizer(cosine_warmup_schedule(*ASPIRIN_L3_TRAIN["schedule"]),
                           weight_decay=ASPIRIN_L3_TRAIN["weight_decay"])
    step, _ = make_dens_steps(model, opt, **ASPIRIN_L3_TRAIN["steps"])
    state = TrainState.create(model, opt)
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(SEED)
    return lambda b: step(state, b, gen, ASPIRIN_L3_TRAIN["dp_weight"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    unit_arg = ap.add_mutually_exclusive_group()
    unit_arg.add_argument("--train", action="store_true", help="profile QM9 training steps")
    unit_arg.add_argument("--md17", action="store_true",
                          help="profile MD17 energy + force evaluations")
    unit_arg.add_argument("--md17-train", action="store_true",
                          help="profile MD17 energy + force training steps")
    unit_arg.add_argument("--dens", action="store_true",
                          help="profile DeNS training steps (the aspirin L3 recipe)")
    route_arg = ap.add_mutually_exclusive_group()
    route_arg.add_argument("--unfused", action="store_true",
                           help="build the model with fused_dtp_lin=False (the DTP on K6)")
    route_arg.add_argument("--radial-fold", action="store_true",
                           help="build the model with radial_fold=True (and radial_fold_ho "
                                "for --md17 and --md17-train): the radial MLPs' last layers "
                                "inside the fused op (K7)")
    route_arg.add_argument("--kron-g", action="store_true",
                           help="build the QM9 model with kron_g=True (the fused DTPs on K8)")
    ap.add_argument("--first-order-bwd", action="store_true",
                    help="with --unfused --train: dtp_first_order_bwd=True (each DTP's "
                         "backward one K6-FB launch)")
    ap.add_argument("--packed", action="store_true",
                    help="the packed layout (nodes_per_graph=0) at the CLIs' capacities")
    ap.add_argument("--remat", action="store_true",
                    help="build the model with remat=True (the CLIs' setting): the blocks' "
                         "forwards recomputed in the backward")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.kron_g and (args.md17 or args.md17_train):
        ap.error("--kron-g takes the QM9 model: the force models ignore kron_g")
    if args.first_order_bwd and not (args.unfused and args.train):
        ap.error("--first-order-bwd takes --unfused --train")
    if args.dens and (args.unfused or args.radial_fold or args.kron_g or args.remat):
        ap.error("--dens profiles the fused route only, without remat")
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)

    md17 = args.md17 or args.md17_train or args.dens
    model_name, batch, slots = DENS if args.dens else MD17 if md17 else QM9
    if md17:
        data = md17_like_dataset(batch * N_BATCHES, num_atoms=slots, seed=SEED)
    else:
        data = qm9_like_dataset(batch * N_BATCHES, seed=SEED)
    batches = list(GraphLoader(data, batch, dense_slots=slots, shuffle=False, with_forces=md17))
    counts = [int(radius_graph_dense(b.pos, b.node_mask, batch, 5.0, batch * slots * slots)
                  .mask.sum()) for b in batches]
    max_edges = (every_pair_edges(batch, slots) if args.dens
                 else -(-max(counts) // 128) * 128)
    layout = slots
    if args.packed:  # the same molecules at the CLIs' capacities
        nodes, max_edges = cli_capacities(batch, slots, slots + 1 if md17 else 17)
        batches = list(GraphLoader(data, batch, nodes, shuffle=False, with_forces=md17))
        layout = 0
    gpu = [b.to(dev) for b in batches]
    make = model_entrypoint(model_name)
    unit = ("train" if args.train else "md17" if args.md17
            else "md17_train" if args.md17_train else "dens_train" if args.dens else "eval")
    route = ("unfused_fb" if args.first_order_bwd else "unfused" if args.unfused
             else "fold" if args.radial_fold else "kron" if args.kron_g else "fused")
    switches = (dict(ASPIRIN_L3) if args.dens
                else {"fused_dtp_lin": not args.unfused, "kron_g": args.kron_g})
    if args.first_order_bwd:
        switches["dtp_first_order_bwd"] = True
    if args.radial_fold:
        switches.update(radial_fold=True, radial_fold_ho=md17)
    if args.remat:
        switches["remat"] = True
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "model": model_name, "unit": unit, "route": route, "batch": batch, "batches": N_BATCHES,
              "layout": "packed" if args.packed else "fixed-slot", "remat": args.remat,
              "real_edges": counts, "max_edges": max_edges}
    for name in ("float32", "bfloat16"):
        model = make(max_edges=max_edges, nodes_per_graph=layout, seed=SEED, device=dev,
                     compute_dtype=None if name == "float32" else name, **switches)
        if args.train:
            run = train_unit(model)
        elif args.md17:
            run = md17_unit(model)
        elif args.md17_train:
            run = md17_train_unit(model)
        elif args.dens:
            run = dens_train_unit(model)
        else:
            run = eval_unit(model)
        tag = f"{unit}_{route}{'_packed' * args.packed}{'_remat' * args.remat}_{name}"
        report[name] = profile(run, gpu, tag)
        del model, run
    text = json.dumps(report, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
