"""Where the time of the flagship's eval forward goes, on one GPU.

    python -m equiformer_tpu_torch.tools.profile_eval [--out FILE]

Builds ``graph_attention_transformer_nonlinear_l2`` at full width with a
seeded init, on 4 batches of 128 QM9-like graphs (30 node slots each,
``max_edges`` the largest batch's real edge count rounded up to 128, as in
``chip_smoke.py``), and reports for float32 and bfloat16, per forward:

* ``wall_ms``: one pass of ``evaluate`` over the batches, ending in a
  synchronize, divided by the batch count (median of 5 passes, no profiler);
* ``enqueue_ms``: host time until ``evaluate`` returns, without a
  synchronize (median over 3 x the batches, no profiler);
* from a ``torch.profiler`` trace of one pass: ``device_busy_ms`` (union of
  the kernel, memcpy and memset intervals), ``launches`` (kernels), and the
  12 kernels with the most device time: [name, ms, calls] per forward;
* ``idle_share``: 1 - device_busy_ms / wall_ms, the share of the unprofiled
  wall time in which the device has nothing to run.

Prints the card's name and power limit, then the report as JSON (also
written to ``--out``).  The trace itself lands in ``build/profile/``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from .. import evaluate, model_entrypoint
from ..data import GraphLoader, qm9_like_dataset
from ..graph.radius_graph import radius_graph_dense

BATCH = 128
N_BATCHES = 4
SLOTS = 30
SEED = 0
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
    that holds ``n_forwards`` forwards."""
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


def profile(model, batches, tag: str) -> dict:
    n = len(batches)
    for b in batches:  # warm-up
        evaluate(model, b)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        for b in batches:
            evaluate(model, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) / n * 1e3)
    enqueue = []
    for _ in range(3):
        for b in batches:
            t = time.perf_counter()
            evaluate(model, b)
            enqueue.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches:
            evaluate(model, b)
        torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"eval_{tag}.json"
    prof.export_chrome_trace(str(path))
    wall = statistics.median(walls)
    trace = trace_summary(path, n)
    return {"wall_ms": wall, "wall_ms_passes": walls, "graphs_per_s": BATCH * 1e3 / wall,
            "enqueue_ms": statistics.median(enqueue),
            "idle_share": 1.0 - trace["device_busy_ms"] / wall, **trace}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    data = qm9_like_dataset(BATCH * N_BATCHES, seed=SEED)
    batches = list(GraphLoader(data, BATCH, SLOTS, shuffle=False))
    counts = [int(radius_graph_dense(b.pos, b.node_mask, BATCH, 5.0, BATCH * SLOTS * SLOTS)
                  .mask.sum()) for b in batches]
    max_edges = -(-max(counts) // 128) * 128
    gpu = [b.to(dev) for b in batches]
    make = model_entrypoint("graph_attention_transformer_nonlinear_l2")
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "batch": BATCH, "batches": N_BATCHES, "real_edges": counts,
              "max_edges": max_edges}
    for name in ("float32", "bfloat16"):
        model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED,
                     compute_dtype=None if name == "float32" else name).to(dev).eval()
        report[name] = profile(model, gpu, name)
        del model
    text = json.dumps(report, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
