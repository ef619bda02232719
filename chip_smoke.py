#!/usr/bin/env python3
"""Drive the PyTorch port's QM9 inference path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and turned into success):

1. build  — compile ``equiformer_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
2. kernel — call each kernel's wrapper on CUDA tensors at the flagship's
   shapes (batch of 128 QM9-like graphs, 3840 node slots) in float32 and
   bfloat16, and hold it against its plain PyTorch version on the same
   inputs: max |kernel - plain| <= 1e-4 * max |plain| in float32 (sums in
   another order), <= 2e-2 * max |plain| in bfloat16 (the plain versions
   round intermediates such as the TP output z to bf16, the kernels keep
   them in fp32).  Times both with CUDA events (median of 7 runs of 10 calls).
3. slice  — build ``graph_attention_transformer_nonlinear_l2`` at full width
   from the port's registry with a seeded init, run ``evaluate`` on batches
   of 128 graphs in float32 and bfloat16, check the launch counts of one
   forward (13 DTP, 1 segment sum, 6 attention combine), finite outputs of
   shape [128], and the predictions of each precision against the same
   model and batch on the CPU through the plain path: max diff <= 1e-3 *
   max |cpu| in float32 (sums in another order through six blocks), <= 2e-2
   * max |cpu| in bfloat16 (the kernels keep intermediates such as z in
   fp32 where the plain path rounds them to bf16).  The bfloat16
   predictions must also lie more than 1e-4 * max |cpu| from the float32
   ones on the card, so a forward that skipped the bf16 casts fails.

The last two lines of stdout are the kernel table as JSON and
``{"ok": true, "device": {...}}``; before them come the compiler's register
report, every kernel comparison, the eval graphs/s, the peak memory and the
card's name and power limit.  Exits nonzero without CUDA.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

BATCH = 128
SLOTS = 30
N_BATCHES = 4
SEED = 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SLICE_CPU_RTOL = {"float32": 1e-3, "bfloat16": 2e-2}
BF16_MIN_SHIFT = 1e-4
EXPECTED_LAUNCHES = {"dtp_lin_fwd": 13, "csr_segment_sum": 1, "attn_combine": 6}
TPU_KERNELS = {
    "dtp_lin_fwd": "equiformer_tpu/kernels/dtp_lin_pallas.py:598",
    "csr_segment_sum": "equiformer_tpu/kernels/segment_csr_pallas.py:36",
    "attn_combine": "equiformer_tpu/kernels/attn_csr_pallas.py:109",
}
SOURCES = {
    "dtp_lin_fwd": "equiformer_tpu_torch/csrc/dtp_lin.cu",
    "csr_segment_sum": "equiformer_tpu_torch/csrc/segment_csr.cu",
    "attn_combine": "equiformer_tpu_torch/csrc/attn_csr.cu",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, torch, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def rel_err(a, b) -> tuple:
    a = a.float()
    b = b.float()
    if not bool(a.isfinite().all()):
        raise RuntimeError("kernel output is not finite")
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    return err, err / max(scale, 1e-30)


def kernel_phase(torch, model, batch, dev, records):
    """Each kernel against its plain version at the flagship's shapes."""
    from equiformer_tpu_torch.graph.radius_graph import radius_graph_dense, edge_vectors
    from equiformer_tpu_torch.graph.segment import active_edge_bound
    from equiformer_tpu_torch.core.spherical import spherical_harmonics_for_irreps
    from equiformer_tpu_torch.kernels import (
        attn_combine, attn_combine_plain, csr_segment_sum, dtp_lin, dtp_lin_plain,
        segment_sum_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    G = batch.graph_mask.shape[0]
    N = batch.pos.shape[0]
    edges = radius_graph_dense(batch.pos, batch.node_mask, G, model.max_radius, model.max_edges)
    vec, _ = edge_vectors(batch.pos, edges)
    sh32 = spherical_harmonics_for_irreps(model.irreps_sh, vec)
    n_edges = active_edge_bound(edges.mask)
    E = edges.dst.shape[0]
    ga = model.block_0.ga
    sites = {
        "sep_act": (ga.sep_act.plan, [ga.sep_act.lin, ga.sep_alpha], False),
        "sep_value": (ga.sep_value.plan, [ga.sep_value.lin], False),
        "edge_deg": (model.edge_deg_embed.plan, [model.edge_deg_embed.proj], True),
    }
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        sh = sh32.to(dt)
        for site, (plan, heads, broadcast_x) in sites.items():
            if broadcast_x:
                x = torch.randn(1, plan.d_x, generator=g, device=dev).to(dt).expand(E, plan.d_x)
            else:
                x = torch.randn(E, plan.d_x, generator=g, device=dev).to(dt)
            if plan.shared_weights:
                w = torch.randn(plan.d_w, generator=g, device=dev).to(dt)
            else:
                w = torch.randn(E, plan.d_w, generator=g, device=dev).to(dt)
            W = plan.pack_weights([[None if t is None else t.detach().to(dt)
                                    for t in h.weight_list()] for h in heads])
            before = dtp_lin.launches
            k = dtp_lin(plan, x, sh, w, W, n_edges)
            p = dtp_lin_plain(plan, x, sh, w, W, n_edges)
            torch.cuda.synchronize()
            err, rel = rel_err(k, p)
            ms = cuda_time_ms(lambda: dtp_lin(plan, x, sh, w, W, n_edges), torch)
            plain_ms = cuda_time_ms(lambda: dtp_lin_plain(plan, x, sh, w, W, n_edges), torch)
            dtp_lin.launches = before  # comparison launches do not count
            records.append(dict(kernel="dtp_lin_fwd", site=site, dtype=dt_name,
                                shape=f"E={E} d_x={plan.d_x} d_w={plan.d_w} d_out={plan.d_out}",
                                max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms))

        val = torch.randn(E, 480, generator=g, device=dev).to(dt)
        before = csr_segment_sum.launches
        k = csr_segment_sum(val, edges.dst, N, edges.mask)
        p = segment_sum_plain(val, edges.dst, N, edges.mask)
        torch.cuda.synchronize()
        err, rel = rel_err(k, p)
        ms = cuda_time_ms(lambda: csr_segment_sum(val, edges.dst, N, edges.mask), torch)
        plain_ms = cuda_time_ms(lambda: segment_sum_plain(val, edges.dst, N, edges.mask), torch)
        csr_segment_sum.launches = before
        records.append(dict(kernel="csr_segment_sum", site="edge_deg", dtype=dt_name,
                            shape=f"E={E} C=480 N={N}", max_abs_err=err, rel_err=rel,
                            ms=ms, plain_ms=plain_ms))

        scores = torch.randn(E, 4, generator=g, device=dev).to(dt)
        value = torch.randn(E, 4, 120, generator=g, device=dev).to(dt)
        before = attn_combine.launches
        k = attn_combine(scores, value, edges.dst, N, edges.mask)
        p = attn_combine_plain(scores, value, edges.dst, N, edges.mask)
        torch.cuda.synchronize()
        err, rel = rel_err(k, p)
        ms = cuda_time_ms(lambda: attn_combine(scores, value, edges.dst, N, edges.mask), torch)
        plain_ms = cuda_time_ms(
            lambda: attn_combine_plain(scores, value, edges.dst, N, edges.mask), torch)
        attn_combine.launches = before
        records.append(dict(kernel="attn_combine", site="ga", dtype=dt_name,
                            shape=f"E={E} H=4 D=120 N={N}", max_abs_err=err, rel_err=rel,
                            ms=ms, plain_ms=plain_ms))
    failed = [r for r in records if not r["rel_err"] <= TOL[r["dtype"]]]
    for r in records:
        print(f"kernel {r['kernel']:16s} {r['site']:9s} {r['dtype']:8s} {r['shape']}: "
              f"max_abs_err {r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}) "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms", flush=True)
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: {failed}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(torch, torch.device("cuda:0"))


def run(torch, dev) -> int:
    import equiformer_tpu_torch as pt
    from equiformer_tpu_torch.data import GraphLoader, qm9_like_dataset
    from equiformer_tpu_torch.graph.radius_graph import radius_graph_dense
    from equiformer_tpu_torch.kernels import (
        _build, attn_combine, csr_segment_sum, dtp_lin, reset_launch_counts,
    )

    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    lib = _build.build()
    _build.library()
    print(f"build: {time.time() - t0:.1f} s -> {lib}", flush=True)
    for ln in (lib.parent / "ptxas.log").read_text().splitlines():
        if "registers" in ln or "spill" in ln:
            print("ptxas:", ln.strip())

    data = qm9_like_dataset(BATCH * N_BATCHES, seed=SEED)
    batches = list(GraphLoader(data, BATCH, SLOTS, shuffle=False))
    # max_edges: the real edge count of the largest batch, rounded up to 128
    counts = [int(radius_graph_dense(b.pos, b.node_mask, BATCH, 5.0, BATCH * SLOTS * SLOTS)
                  .mask.sum()) for b in batches]
    max_edges = -(-max(counts) // 128) * 128
    print(f"batches: {N_BATCHES} x {BATCH} graphs, real edges {counts}, max_edges {max_edges}")

    make = pt.model_entrypoint("graph_attention_transformer_nonlinear_l2")
    model32 = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED).to(dev).eval()
    model16 = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED,
                   compute_dtype="bfloat16").to(dev).eval()
    gpu_batches = [b.to(dev) for b in batches]

    records = []
    kernel_phase(torch, model32, gpu_batches[0], dev, records)

    # ---- slice phase: the counted main-path run is one bf16 forward
    reset_launch_counts()
    pt.evaluate(model16, gpu_batches[0])
    torch.cuda.synchronize()
    launches = {"dtp_lin_fwd": dtp_lin.launches, "csr_segment_sum": csr_segment_sum.launches,
                "attn_combine": attn_combine.launches}
    print(f"launches in one forward: {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise RuntimeError(f"launch counts {launches} != expected {EXPECTED_LAUNCHES}")

    preds = {}
    for name, model in (("float32", model32), ("bfloat16", model16)):
        pt.evaluate(model, gpu_batches[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            results = [pt.evaluate(model, b) for b in gpu_batches]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        for r in results:
            if r["pred"].shape != (BATCH,) or not bool(r["pred"].isfinite().all()):
                raise RuntimeError(f"{name}: bad predictions {r['pred']}")
            if not bool(r["mae_sum"].isfinite()) or int(r["count"]) != BATCH:
                raise RuntimeError(f"{name}: bad MAE sums {r}")
        gps = BATCH * N_BATCHES / statistics.median(times)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        preds[name] = results[0]["pred"].float().cpu()
        print(f"slice {name}: eval {gps:.1f} graphs/s at batch {BATCH} "
              f"(median of 3 passes over {N_BATCHES} batches; pass seconds "
              f"{[round(t, 4) for t in times]}), peak memory {peak:.0f} MiB")

    # each precision on the card vs the same model and batch through the
    # plain path on the CPU
    for name, model in (("float32", model32), ("bfloat16", model16)):
        cpu_model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED,
                         compute_dtype=None if name == "float32" else name).eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        t = time.perf_counter()
        ref = pt.evaluate(cpu_model, batches[0])["pred"]
        cpu_s = time.perf_counter() - t
        diff = float((preds[name] - ref).abs().max())
        scale = max(float(ref.abs().max()), 1.0)
        print(f"slice {name} vs CPU plain path: max |diff| {diff:.3e} "
              f"(rel {diff / scale:.3e}, bound {SLICE_CPU_RTOL[name]:.0e}; "
              f"CPU forward {cpu_s:.1f} s)", flush=True)
        if not diff <= SLICE_CPU_RTOL[name] * scale:
            raise RuntimeError(f"{name} predictions on the card disagree with the CPU plain path")
    shift = float((preds["bfloat16"] - preds["float32"]).abs().max()) / scale
    print(f"slice bfloat16 vs float32 on the card: rel {shift:.3e} (must exceed {BF16_MIN_SHIFT:.0e})")
    if not shift > BF16_MIN_SHIFT:
        raise RuntimeError("bfloat16 predictions equal the float32 ones: compute_dtype was ignored")

    table = []
    for name in ("dtp_lin_fwd", "csr_segment_sum", "attn_combine"):
        # the bf16 row at the kernel's first (for K1: the two-head) call site
        r = next(r for r in records if r["kernel"] == name and r["dtype"] == "bfloat16")
        table.append({"name": name, "route": "cuda", "source": SOURCES[name],
                      "replaces": TPU_KERNELS[name], "launches": launches[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"]})
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
