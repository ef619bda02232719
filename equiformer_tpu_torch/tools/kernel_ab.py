"""K3 (the CSR segment sum) and K2 (the fused DTP + linear backward) of this
package against another tree's, in turns, on one GPU.

    python -m equiformer_tpu_torch.tools.kernel_ab [--against DIR] [--out FILE]

``DIR`` is the root of another checkout of the repository (for example the
parent commit unpacked with ``git archive``); its ``equiformer_tpu_torch``
is loaded as a second package, whose wrappers build their own kernels
(into ``DIR/build/``) and launch them, so each side runs its own wrapper
and kernel on the same input tensors.  The sides run in turns (package,
other, other, package), so the two compare within one call on one card.

The shapes are ``chip_smoke.py``'s: batch 0 of the QM9 geometry (128
QM9-like graphs of 30 slots, seed 0, radius 5; ``max_edges`` the largest
of 4 batches' real edge counts rounded up to 128) and of the MD17 one (8
md17-like molecules of 21 slots).  K3 runs at its shapes: at QM9 the
edge-degree scatter [E, 480] (masked) and the message gathers' backward
[E, 480] (unmasked: the 3464 padding edges on the last node are summed),
at MD17 the edge-degree scatter [E, 864], the attention sums [E, 4, 216]
(both masked) and the gathers' backward [E, 864]; K2 at the QM9 flagship's three sites
(sep_act, sep_value with shared weights folded into W, the edge-degree
embedding with its row-broadcast x), random operands from seed 0, the
batch's real edges live.  Per shape and dtype (float32, bfloat16):

* ``ms``: each side's wrapper, CUDA events (median of 5 runs of 5 calls);
  ``host_us`` (K3): its host time a call (median of 5 runs of 100 calls
  without a synchronize), which bounds ``ms`` at the small MD17 shapes;
* ``device_ms``: each side's device time per call, all its kernels, and
  ``kernel_ms`` the segment-sum kernel alone (K3), from a profiler trace of
  20 calls;
* ``rel_err``: each side against this package's plain version (max |diff| /
  max |plain|); ``index_add_`` (K3's one-call equivalent, zeros + add: its
  time as the wrapper's, and its device time) and the plain version's
  times; for K2 the scratch each side allocates beyond its outputs (peak
  memory during the call minus before it).

Prints the card's name and power limit, then the report as JSON (also to
``--out``).  The traces land in ``build/profile/``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from .. import model_entrypoint
from ..data import GraphLoader, md17_like_dataset, qm9_like_dataset
from ..graph.radius_graph import radius_graph_dense
from ..kernels import (
    csr_segment_sum,
    dtp_lin_bwd,
    dtp_lin_bwd_plain,
    segment_sum_plain,
)
from ..utils.profiling import card_line, device_time_ms, kernel_ms, resolve_device

SEED = 0
# model, graphs per batch, node slots per graph
QM9 = ("graph_attention_transformer_nonlinear_l2", 128, 30)
MD17 = ("graph_attention_transformer_nonlinear_exp_l3_md17", 8, 21)
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"
K3_KERNEL = "csr_segment_sum_kernel"


def load_tree(root: Path, name: str = "eqt_other"):
    """``root/equiformer_tpu_torch`` imported as the package ``name``."""
    pkg = root / "equiformer_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def geometry(dataset, graphs: int, slots: int, dev):
    """(dst, mask, N, max_edges) of batch 0, as chip_smoke.py builds it."""
    batches = list(GraphLoader(dataset, graphs, slots, shuffle=False))
    counts = [int(radius_graph_dense(b.pos, b.node_mask, graphs, 5.0, graphs * slots * slots)
                  .mask.sum()) for b in batches]
    max_edges = -(-max(counts) // 128) * 128
    b = batches[0].to(dev)
    edges = radius_graph_dense(b.pos, b.node_mask, graphs, 5.0, max_edges)
    return edges.dst, edges.mask, b.pos.shape[0], max_edges


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def dtp_plans(model):
    ga = model.block_0.ga
    return {"sep_act": ga.sep_act.plan, "sep_value": ga.sep_value.plan,
            "edge_deg": model.edge_deg_embed.plan}


def host_us(fn, reps: int = 5, inner: int = 100) -> float:
    """Host time per call of ``fn`` in microseconds (median over ``reps`` of
    ``inner`` back-to-back calls, no synchronize between them): what a call
    costs where the host, not the card, is the limit."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t) / inner * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def scratch_mib(fn, dev) -> float:
    """Peak memory during ``fn()`` beyond what it returns, MiB."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated(dev) - before
    del out
    return (torch.cuda.max_memory_allocated(dev) - before - kept) / 2**20


def k3_cases(dev):
    dst, mask, N, E = geometry(qm9_like_dataset(4 * QM9[1], seed=SEED), QM9[1], QM9[2], dev)
    mdst, mmask, mN, mE = geometry(md17_like_dataset(4 * MD17[1], num_atoms=MD17[2], seed=SEED),
                                   MD17[1], MD17[2], dev)
    return {"qm9-edge_deg": (dst, mask, N, (E, 480)),
            "qm9-gather": (dst, None, N, (E, 480)),
            "md17-edge_deg": (mdst, mmask, mN, (mE, 864)),
            "md17-attn": (mdst, mmask, mN, (mE, 4, 216)),
            "md17-gather": (mdst, None, mN, (mE, 864))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="the root of another checkout whose K3 and K2 run in turns with these")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    card = card_line()
    print(card, flush=True)
    sides = {"package": (csr_segment_sum, dtp_lin_bwd, model_entrypoint)}
    if args.against is not None:
        other = load_tree(args.against.resolve())
        sides["other"] = (other.kernels.csr_segment_sum, other.kernels.dtp_lin_bwd,
                          other.model_entrypoint)
    order = ["package", "other", "other", "package"] if len(sides) > 1 else ["package"]
    report = {"card": card, "torch": torch.__version__, "order": order, "K3": {}, "K2": {}}

    cases, host_calls = k3_cases(dev), {}
    for case, (dst, mask, N, shape) in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(SEED)
            val = torch.randn(*shape, generator=g, device=dev).to(dt).reshape(shape[0], -1)
            C = val.shape[1]
            want = segment_sum_plain(val, dst, N, mask)
            val_m = val if mask is None else torch.where(mask[:, None], val, torch.zeros_like(val))
            lib = lambda: torch.zeros(N, C, dtype=dt, device=dev).index_add_(0, dst, val_m)  # noqa: E731
            entry = {"E": shape[0], "C": C, "N": N, "masked": mask is not None,
                     "index_add_ms": device_time_ms(lib, dev),
                     "index_add_device_ms": sum(ms for ms, _ in kernel_ms(
                         lib, 20, TRACE_DIR / f"ab_k3_{case}_index_add.json").values()),
                     "plain_ms": device_time_ms(lambda: segment_sum_plain(val, dst, N, mask), dev),
                     "runs": []}
            for i, side in enumerate(order):
                fn = sides[side][0]
                call = lambda: fn(val, dst, N, mask)  # noqa: E731
                per_kernel = kernel_ms(call, 20, TRACE_DIR / f"ab_k3_{case}_{side}_{i}.json")
                entry["runs"].append({
                    "side": side, "ms": device_time_ms(call, dev),
                    "device_ms": sum(ms for ms, _ in per_kernel.values()),
                    "kernel_ms": sum(ms for k, (ms, _) in per_kernel.items() if K3_KERNEL in k),
                    "launches": sum(n for _, n in per_kernel.values()),
                    "rel_err": rel(call(), want)})
            name = f"{case}/{str(dt)[6:]}"
            report["K3"][name] = entry
            host_calls[name] = (lib, [(run, sides[run["side"]][0], (val, dst, N, mask))
                                      for run in entry["runs"]])
    # host times after every trace: a trace taken after many unsynchronized
    # calls has come back without kernels
    for name, (lib, runs) in host_calls.items():
        report["K3"][name]["index_add_host_us"] = host_us(lib)
        for run, fn, call_args in runs:
            run["host_us"] = host_us(lambda: fn(*call_args))
        print("K3", name, json.dumps(report["K3"][name]), flush=True)

    _, mask, _, (E, _) = cases["qm9-edge_deg"]
    n_live = int(mask.sum())
    plans = {side: dtp_plans(make(QM9[0])(max_edges=E, nodes_per_graph=QM9[2], seed=SEED,
                                            device=dev))
             for side, (_, _, make) in sides.items()}
    for site, plan in plans["package"].items():
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(SEED)
            rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)  # noqa: E731
            x = rnd(1, plan.d_x).expand(E, plan.d_x) if site == "edge_deg" else rnd(E, plan.d_x)
            sh, cot, W = rnd(E, plan.d_sh), rnd(E, plan.d_out), 0.05 * rnd(plan.w_numel)
            w = None if plan.shared_weights else rnd(E, plan.d_w)
            n = torch.tensor(n_live, dtype=torch.int32, device=dev)
            want = dtp_lin_bwd_plain(plan, x, sh, w, W, cot, n)
            entry = {"E": E, "n_live": n_live, "runs": []}
            for side in order:
                fn, p = sides[side][1], plans[side][site]
                call = lambda: fn(p, x, sh, w, W, cot, n)  # noqa: E731
                got = call()
                entry["runs"].append({
                    "side": side, "ms": device_time_ms(call, dev),
                    "scratch_mib": scratch_mib(call, dev),
                    "rel_err": max(rel(a, b) for a, b in zip(got, want) if a is not None)})
            name = f"{site}/{str(dt)[6:]}"
            report["K2"][name] = entry
            print("K2", name, json.dumps(entry), flush=True)

    text = json.dumps(report, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return report


if __name__ == "__main__":
    main()
