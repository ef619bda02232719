"""Where the time of an eval forward, a training step or a force evaluation goes, on one GPU.

    python -m equiformer_tpu_torch.tools.profile_eval [--train | --md17 | --md17-train]
        [--unfused | --radial-fold] [--out FILE]

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
grad-of-grad).  ``--unfused`` builds the model with ``fused_dtp_lin=False``:
every DTP call site on the T / R primitives (K6) with the linear heads
after it, instead of the fused DTP + linear op.  ``--radial-fold`` builds
it with ``radial_fold=True`` (and for ``--md17`` also ``radial_fold_ho``):
the radial MLPs' final linear layers of the 7 per-edge-weight sites run
inside the fused op (K7-F forward; K7-B, or K7-B3 for the force
evaluation, backward); the folded force op has no grad-of-grad yet, so
``--md17-train`` does not take it.  For float32 and bfloat16, per unit:

* ``wall_ms``: one pass over the batches, ending in a synchronize, divided
  by the batch count (median of 5 passes, no profiler);
* ``enqueue_ms``: host time until the call returns, without a synchronize
  (median over 3 x the batches, no profiler);
* from a ``torch.profiler`` trace of one pass: ``device_busy_ms`` (union of
  the kernel, memcpy and memset intervals), ``launches`` (kernels), and the
  12 kernels with the most device time: [name, ms, calls] per unit;
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
import subprocess
import time
from pathlib import Path

import torch

from .. import (
    cosine_warmup_schedule,
    create_optimizer,
    evaluate,
    evaluate_md17,
    make_md17_steps,
    make_qm9_steps,
    model_entrypoint,
)
from ..data import GraphLoader, md17_like_dataset, qm9_like_dataset
from ..train import TrainState
from ..graph.radius_graph import radius_graph_dense

N_BATCHES = 4
SEED = 0
# model, graphs per batch, node slots per graph
QM9 = ("graph_attention_transformer_nonlinear_l2", 128, 30)
MD17 = ("graph_attention_transformer_nonlinear_exp_l3_md17", 8, 21)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"


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
    return {
        "device_busy_ms": _union_us(spans) / 1e3 / n_forwards,
        "launches": sum(e["cat"] == "kernel" for e in dev) / n_forwards,
        "kernels": [[name, us / 1e3 / n_forwards, calls / n_forwards]
                    for name, (us, calls) in top],
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    unit_arg = ap.add_mutually_exclusive_group()
    unit_arg.add_argument("--train", action="store_true", help="profile QM9 training steps")
    unit_arg.add_argument("--md17", action="store_true",
                          help="profile MD17 energy + force evaluations")
    unit_arg.add_argument("--md17-train", action="store_true",
                          help="profile MD17 energy + force training steps")
    route_arg = ap.add_mutually_exclusive_group()
    route_arg.add_argument("--unfused", action="store_true",
                           help="build the model with fused_dtp_lin=False (the DTP on K6)")
    route_arg.add_argument("--radial-fold", action="store_true",
                           help="build the model with radial_fold=True (and radial_fold_ho "
                                "for --md17): the radial MLPs' last layers inside the fused "
                                "op (K7)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.radial_fold and args.md17_train:
        ap.error("--radial-fold has no force training yet (the folded leg kernels K7-L, "
                 "K7-LW, K7-Wr are not ported)")
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    md17 = args.md17 or args.md17_train
    model_name, batch, slots = MD17 if md17 else QM9
    if md17:
        data = md17_like_dataset(batch * N_BATCHES, num_atoms=slots, seed=SEED)
    else:
        data = qm9_like_dataset(batch * N_BATCHES, seed=SEED)
    batches = list(GraphLoader(data, batch, slots, shuffle=False, with_forces=md17))
    counts = [int(radius_graph_dense(b.pos, b.node_mask, batch, 5.0, batch * slots * slots)
                  .mask.sum()) for b in batches]
    max_edges = -(-max(counts) // 128) * 128
    gpu = [b.to(dev) for b in batches]
    make = model_entrypoint(model_name)
    unit = ("train" if args.train else "md17" if args.md17
            else "md17_train" if args.md17_train else "eval")
    route = "unfused" if args.unfused else "fold" if args.radial_fold else "fused"
    switches = {"fused_dtp_lin": not args.unfused}
    if args.radial_fold:
        switches.update(radial_fold=True, radial_fold_ho=md17)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "model": model_name, "unit": unit, "route": route, "batch": batch, "batches": N_BATCHES,
              "real_edges": counts, "max_edges": max_edges}
    for name in ("float32", "bfloat16"):
        model = make(max_edges=max_edges, nodes_per_graph=slots, seed=SEED, device=dev,
                     compute_dtype=None if name == "float32" else name, **switches)
        if args.train:
            run = train_unit(model)
        elif args.md17:
            run = md17_unit(model)
        elif args.md17_train:
            run = md17_train_unit(model)
        else:
            run = eval_unit(model)
        report[name] = profile(run, gpu, f"{unit}_{route}_{name}")
        del model, run
    text = json.dumps(report, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
