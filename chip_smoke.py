#!/usr/bin/env python3
"""Drive the PyTorch port's QM9 training and inference paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and turned into success):

1. build  — compile ``equiformer_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
   one nvcc per source, all started together.
2. eval   — ``graph_attention_transformer_nonlinear_l2`` at full width from
   the port's registry with a seeded init, ``evaluate`` on batches of 128
   graphs in float32 and bfloat16: the launch counts of one forward (13 K1,
   1 K3, 6 K4, no K2), finite predictions of shape [128], eval graphs/s;
   the predictions of batch 0 against the same model on the CPU plain
   path: 1e-3 in float32, 2e-2 in bfloat16, with the bfloat16 ones more
   than 1e-4 away from the float32 ones on the card (a forward that skipped
   the bf16 casts fails).
3. kernel — call each kernel's wrapper on CUDA tensors at the flagship's
   shapes (batch of 128 QM9-like graphs, 3840 node slots) in float32 and
   bfloat16, and hold it against its plain PyTorch version on the same
   inputs: max |kernel - plain| <= 1e-4 * max |plain| in float32 (sums in
   another order), <= 2e-2 * max |plain| in bfloat16 (the plain versions
   round intermediates such as the TP output z and dz to bf16, the kernels
   keep them in fp32).  K1 and K2 at the three call sites (sep_act,
   sep_value with folded shared weights, the edge-degree embedding with its
   row-broadcast x), K2 on dx, dw and dW; K3; K4 with an alpha-dropout
   multiplier (the train path) and without (the eval path), on its output
   and its denominator.  Times both with CUDA events (median of 7 runs of
   10 calls), and the one PyTorch call that computes K3's function
   (``index_add_``).  Each kernel's bound is the
   larger of its bytes over 3.35 TB/s and its operations over 989 TFLOP/s
   (bf16 inputs) or 67 TFLOP/s (fp32), counted for this run's real edges.
4. train  — the same model in training mode through ``make_qm9_steps``
   (AdamW with the no-decay mask, ``cosine_warmup_schedule(5e-4, 100,
   100000)``, weight decay 5e-3, alpha dropout 0.2 drawn from a CUDA
   generator, EMA 0.999) at batch 128 in bfloat16 and float32: the launch
   counts of one step (13 K1, 13 K2, 13 K3, 6 K4), finite loss, MAE and
   gradient norm, parameters that moved, train graphs/s (median over 10
   steps after 3 warm-up steps) and the peak memory.
5. CPU    — one full-width training step on 16 graphs, on the card and on
   the CPU plain path, from the same weights and the same injected dropout
   masks: loss and gradient norm within 1e-3 relative and the updated
   parameters within 1e-3 of max |param| in float32, 2e-2 in bfloat16 (the
   first step's learning rate, 1e-4, bounds what Adam's sign-normalized
   update of a gradient that is zero up to rounding can add).

The last two lines of stdout are the kernel table as JSON and
``{"ok": true, "device": {...}}``; before them come the compiler's register
report, every comparison, the rates, the peak memory and the card's name and
power limit.  Exits nonzero without CUDA.
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
CPU_RTOL = {"float32": 1e-3, "bfloat16": 2e-2}
BF16_MIN_SHIFT = 1e-4
CPU_GRAPHS = 16
WARMUP_STEPS, TIMED_STEPS = 3, 10
EXPECTED_EVAL = {"dtp_lin_fwd": 13, "dtp_lin_bwd": 0, "csr_segment_sum": 1, "attn_combine": 6}
EXPECTED_TRAIN = {"dtp_lin_fwd": 13, "dtp_lin_bwd": 13, "csr_segment_sum": 13, "attn_combine": 6}
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TPU_KERNELS = {
    "dtp_lin_fwd": "equiformer_tpu/kernels/dtp_lin_pallas.py:598",
    "dtp_lin_bwd": "equiformer_tpu/kernels/dtp_lin_pallas.py:673",
    "csr_segment_sum": "equiformer_tpu/kernels/segment_csr_pallas.py:36",
    "attn_combine": "equiformer_tpu/kernels/attn_csr_pallas.py:109",
}
SOURCES = {
    "dtp_lin_fwd": "equiformer_tpu_torch/csrc/dtp_lin.cu",
    "dtp_lin_bwd": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
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


def bound(nbytes: float, flops: float, dt_name: str) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt_name] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def dtp_work(plan) -> tuple:
    """(TP term elements, z @ W multiply-adds) per real edge of one call."""
    return (sum(t.mul for t, _ in plan.terms),
            sum(g.ir.dim * g.fan * g.cols for g in plan.groups))


def kernel_phase(torch, model, batch, dev, records):
    """Each kernel against its plain version at the flagship's shapes."""
    from equiformer_tpu_torch.graph.radius_graph import radius_graph_dense, edge_vectors
    from equiformer_tpu_torch.graph.segment import active_edge_bound
    from equiformer_tpu_torch.core.spherical import spherical_harmonics_for_irreps
    from equiformer_tpu_torch.kernels import (
        KERNEL_WRAPPERS, attn_combine_fwd, attn_combine_plain, attn_den_plain,
        csr_segment_sum, dtp_lin_bwd, dtp_lin_bwd_plain, dtp_lin_fwd, dtp_lin_plain,
        segment_sum_plain,
    )

    saved = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    g = torch.Generator(device=dev).manual_seed(SEED)
    G = batch.graph_mask.shape[0]
    N = batch.pos.shape[0]
    edges = radius_graph_dense(batch.pos, batch.node_mask, G, model.max_radius, model.max_edges)
    vec, _ = edge_vectors(batch.pos, edges)
    sh32 = spherical_harmonics_for_irreps(model.irreps_sh, vec)
    n_edges = active_edge_bound(edges.mask)
    n = int(n_edges)
    n_real = int(edges.mask.sum())
    E = edges.dst.shape[0]
    ga = model.block_0.ga
    sites = {
        "sep_act": (ga.sep_act.plan, [ga.sep_act.lin, ga.sep_alpha], False),
        "sep_value": (ga.sep_value.plan, [ga.sep_value.lin], False),
        "edge_deg": (model.edge_deg_embed.plan, [model.edge_deg_embed.proj], True),
    }

    def record(kernel, site, dt_name, shape, errs, ms, plain_ms, nbytes, flops, library_ms=None):
        err = max(e for e, _ in errs)
        rel = max(r for _, r in errs)
        b_ms, b_by = bound(nbytes, flops, dt_name)
        records.append(dict(kernel=kernel, site=site, dtype=dt_name, shape=shape,
                            max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms))

    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        size = torch.finfo(dt).bits // 8
        sh = sh32.to(dt)
        for site, (plan, heads, broadcast_x) in sites.items():
            if broadcast_x:
                x = torch.randn(1, plan.d_x, generator=g, device=dev).to(dt).expand(E, plan.d_x)
            else:
                x = torch.randn(E, plan.d_x, generator=g, device=dev).to(dt)
            W = plan.pack_weights([[None if t is None else t.detach().to(dt)
                                    for t in h.weight_list()] for h in heads])
            if plan.shared_weights:  # folded into W before both kernels, as dtp_lin does
                W = plan.fold_shared(torch.randn(plan.d_w, generator=g, device=dev).to(dt), W)
                w = None
            else:
                w = torch.randn(E, plan.d_w, generator=g, device=dev).to(dt)
            cot = torch.randn(E, plan.d_out, generator=g, device=dev).to(dt)
            shape = f"E={E} d_x={plan.d_x} d_w={plan.d_w} d_out={plan.d_out}"
            tp_elems, macs = dtp_work(plan)
            in_bytes = size * ((plan.d_x if broadcast_x else n * plan.d_x) + n * plan.d_sh
                               + (0 if w is None else n * plan.d_w) + plan.w_numel)

            k = dtp_lin_fwd(plan, x, sh, w, W, n_edges)
            p = dtp_lin_plain(plan, x, sh, w, W, n_edges)
            torch.cuda.synchronize()
            errs = [rel_err(k, p)]
            ms = cuda_time_ms(lambda: dtp_lin_fwd(plan, x, sh, w, W, n_edges), torch)
            plain_ms = cuda_time_ms(lambda: dtp_lin_plain(plan, x, sh, w, W, n_edges), torch)
            record("dtp_lin_fwd", site, dt_name, shape, errs, ms, plain_ms,
                   in_bytes + size * E * plan.d_out, n * (2 * macs + 4 * tp_elems))

            k = dtp_lin_bwd(plan, x, sh, w, W, cot, n_edges)
            p = dtp_lin_bwd_plain(plan, x, sh, w, W, cot, n_edges)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(k, p) if a is not None]
            ms = cuda_time_ms(lambda: dtp_lin_bwd(plan, x, sh, w, W, cot, n_edges), torch)
            plain_ms = cuda_time_ms(
                lambda: dtp_lin_bwd_plain(plan, x, sh, w, W, cot, n_edges), torch, reps=3, inner=3)
            out_bytes = size * E * (plan.d_x + (0 if w is None else plan.d_w)) + 4 * plan.w_numel
            record("dtp_lin_bwd", site, dt_name, shape, errs, ms, plain_ms,
                   in_bytes + size * n * plan.d_out + out_bytes,
                   n * (4 * macs + 10 * tp_elems))

        C = 480
        val = torch.randn(E, C, generator=g, device=dev).to(dt)
        k = csr_segment_sum(val, edges.dst, N, edges.mask)
        p = segment_sum_plain(val, edges.dst, N, edges.mask)
        torch.cuda.synchronize()
        errs = [rel_err(k, p)]
        ms = cuda_time_ms(lambda: csr_segment_sum(val, edges.dst, N, edges.mask), torch)
        plain_ms = cuda_time_ms(lambda: segment_sum_plain(val, edges.dst, N, edges.mask), torch)
        val_m = torch.where(edges.mask[:, None], val, torch.zeros_like(val))
        lib_ms = cuda_time_ms(
            lambda: torch.zeros(N, C, dtype=dt, device=dev).index_add_(0, edges.dst, val_m), torch)
        record("csr_segment_sum", "edge_deg", dt_name, f"E={E} C={C} N={N}", errs, ms, plain_ms,
               size * (n_real * C + N * C) + E + 4 * (N + 1), n_real * C, lib_ms)

        H, D = 4, 120
        scores = torch.randn(E, H, generator=g, device=dev).to(dt)
        value = torch.randn(E, H, D, generator=g, device=dev).to(dt)
        keep = torch.rand(E, H, generator=g, device=dev) < 0.8
        drop = keep.to(dt) / 0.8
        masked = torch.where(edges.mask[:, None], scores, torch.full_like(scores, -1e30))
        k_out, k_den = attn_combine_fwd(masked, value, edges.dst, N, edges.mask, drop)
        p_out = attn_combine_plain(scores, value, edges.dst, N, edges.mask, drop)
        p_den = attn_den_plain(masked, edges.dst, N)
        torch.cuda.synchronize()
        errs = [rel_err(k_out, p_out), rel_err(k_den, p_den)]
        ms = cuda_time_ms(
            lambda: attn_combine_fwd(masked, value, edges.dst, N, edges.mask, drop), torch)
        plain_ms = cuda_time_ms(lambda: (
            attn_combine_plain(scores, value, edges.dst, N, edges.mask, drop),
            attn_den_plain(masked, edges.dst, N)), torch)
        record("attn_combine", "ga", dt_name, f"E={E} H={H} D={D} N={N}", errs, ms, plain_ms,
               size * (2 * E * H + n_real * H * D + N * H * D) + 4 * N * H,
               n_real * H * (3 * D + 2))
        # the eval path's call, without the dropout multiplier
        k_out, k_den = attn_combine_fwd(masked, value, edges.dst, N, edges.mask)
        errs = [rel_err(k_out, attn_combine_plain(scores, value, edges.dst, N, edges.mask)),
                rel_err(k_den, p_den)]
        ms = cuda_time_ms(lambda: attn_combine_fwd(masked, value, edges.dst, N, edges.mask), torch)
        plain_ms = cuda_time_ms(lambda: (
            attn_combine_plain(scores, value, edges.dst, N, edges.mask),
            attn_den_plain(masked, edges.dst, N)), torch)
        record("attn_combine", "ga-nodrop", dt_name, f"E={E} H={H} D={D} N={N}", errs, ms,
               plain_ms, size * (E * H + n_real * H * D + N * H * D) + 4 * N * H,
               n_real * H * (2 * D + 2))
    for name, fn in KERNEL_WRAPPERS.items():  # comparison launches do not count
        fn.launches = saved[name]
    failed = [r for r in records if not r["rel_err"] <= TOL[r["dtype"]]]
    for r in records:
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        print(f"kernel {r['kernel']:16s} {r['site']:9s} {r['dtype']:8s} {r['shape']}: "
              f"max_abs_err {r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}) "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms{lib}; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: {failed}")


def counted(torch, fn):
    """Run ``fn`` with every launch count set to 0 just before; returns
    (its result, the counts just after)."""
    from equiformer_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def max_edges_for(batches, graphs):
    """The real edge count of the largest batch, rounded up to 128."""
    from equiformer_tpu_torch.graph.radius_graph import radius_graph_dense

    counts = [int(radius_graph_dense(b.pos, b.node_mask, graphs, 5.0, graphs * SLOTS * SLOTS)
                  .mask.sum()) for b in batches]
    return counts, -(-max(counts) // 128) * 128


def train_setup(pt, model):
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000), weight_decay=5e-3)
    train_step, _ = pt.make_qm9_steps(model, opt, 0.0, 1.0, "l1", ema_decay=0.999)
    return train_step, pt.TrainState.create(model, opt)


def train_phase(pt, torch, make, max_edges, gpu_batches, dev, out):
    """Full-width training steps at batch 128 in bf16 and fp32 on the card."""
    for name in ("bfloat16", "float32"):
        model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED,
                     compute_dtype=None if name == "float32" else name)
        step, state = train_setup(pt, model)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        (state, metrics), launches = counted(torch, lambda: step(state, gpu_batches[0], gen))
        print(f"train {name}: launches in one step: {launches}")
        if launches != EXPECTED_TRAIN:
            raise RuntimeError(f"launch counts {launches} != expected {EXPECTED_TRAIN}")
        out["train_launches"] = launches
        for i in range(1, WARMUP_STEPS):
            state, metrics = step(state, gpu_batches[i % len(gpu_batches)], gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for i in range(TIMED_STEPS):
            t = time.perf_counter()
            state, metrics = step(state, gpu_batches[i % len(gpu_batches)], gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(v == v and abs(v) < float("inf") for v in vals.values()):
            raise RuntimeError(f"{name}: non-finite training metrics {vals}")
        moved = max(float((p.detach() - before[n]).abs().max())
                    for n, p in model.named_parameters())
        ema_moved = max(float((state.ema[n] - before[n]).abs().max()) for n in before)
        if not (moved > 0 and ema_moved > 0) or state.step != WARMUP_STEPS + TIMED_STEPS:
            raise RuntimeError(f"{name}: parameters or EMA did not move ({moved}, {ema_moved})")
        gps = BATCH / statistics.median(times)
        out[f"train_{name}"] = gps
        print(f"train {name}: {gps:.1f} graphs/s at batch {BATCH} (median of {TIMED_STEPS} "
              f"steps after {WARMUP_STEPS} warm-up; step seconds "
              f"{[round(t, 4) for t in times]}), peak memory {peak:.0f} MiB, last step "
              f"loss {vals['loss']:.4f} mae {vals['mae']:.4f} grad_norm {vals['grad_norm']:.4f}, "
              f"max parameter move {moved:.3e}", flush=True)
        del model, state


def train_vs_cpu(pt, torch, make, data, dev):
    """One full-width training step of CPU_GRAPHS graphs on the card and on the
    CPU plain path, same weights and same injected dropout masks."""
    from equiformer_tpu_torch.data import GraphLoader

    batch = next(iter(GraphLoader(data[:CPU_GRAPHS], CPU_GRAPHS, SLOTS, shuffle=False)))
    _, max_edges = max_edges_for([batch], CPU_GRAPHS)
    mask_gen = torch.Generator().manual_seed(SEED + 1)
    keep = None
    for name in ("float32", "bfloat16"):
        results = []
        for d in (dev, "cpu"):
            model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED, device=d,
                         compute_dtype=None if name == "float32" else name)
            if keep is None:  # one alpha-dropout mask [E, H] per block
                keep = [torch.rand(max_edges, model.block_0.ga.num_heads, generator=mask_gen)
                        < 0.8 for _ in range(model.num_layers)]
            step, state = train_setup(pt, model)
            masks = iter(keep)
            t = time.perf_counter()
            state, m = step(state, batch.to(d), masks)
            if d != "cpu":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t
            if next(masks, None) is not None:
                raise RuntimeError("the step used fewer dropout masks than it has blocks")
            results.append(({k: float(v) for k, v in m.items()}, secs,
                            {n: p.detach().float().cpu() for n, p in model.named_parameters()}))
            del model, state
        (mg, sg, pg), (mc, sc, pc) = results
        tol = CPU_RTOL[name]
        errs = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in ("loss", "grad_norm")}
        scale = max(float(p.abs().max()) for p in pc.values())
        perr = max(float((pg[n] - pc[n]).abs().max()) for n in pc) / scale
        print(f"train {name} card vs CPU plain path ({CPU_GRAPHS} graphs, max_edges "
              f"{max_edges}): loss {mg['loss']:.6f} / {mc['loss']:.6f}, grad_norm "
              f"{mg['grad_norm']:.6f} / {mc['grad_norm']:.6f}, rel {errs}, updated params "
              f"{perr:.3e} of max |param| (bound {tol:.0e}); step {sg:.2f} s card, "
              f"{sc:.1f} s CPU", flush=True)
        if not (max(errs.values()) <= tol and perr <= tol):
            raise RuntimeError(f"{name} training step on the card disagrees with the CPU")


def eval_phase(pt, torch, make, max_edges, batches, gpu_batches, dev, out):
    models = {name: make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED,
                         compute_dtype=None if name == "float32" else name).eval()
              for name in ("float32", "bfloat16")}
    _, launches = counted(torch, lambda: pt.evaluate(models["bfloat16"], gpu_batches[0]))
    print(f"eval: launches in one forward: {launches}")
    if launches != EXPECTED_EVAL:
        raise RuntimeError(f"launch counts {launches} != expected {EXPECTED_EVAL}")
    preds = {}
    for name, model in models.items():
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
        gps = BATCH * len(gpu_batches) / statistics.median(times)
        out[f"eval_{name}"] = gps
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        preds[name] = results[0]["pred"].float().cpu()
        print(f"eval {name}: {gps:.1f} graphs/s at batch {BATCH} "
              f"(median of 3 passes over {len(gpu_batches)} batches; pass seconds "
              f"{[round(t, 4) for t in times]}), peak memory {peak:.0f} MiB")

    # each precision on the card vs the same model and batch through the
    # plain path on the CPU
    for name, model in models.items():
        cpu_model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED, device="cpu",
                         compute_dtype=None if name == "float32" else name).eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        t = time.perf_counter()
        ref = pt.evaluate(cpu_model, batches[0])["pred"]
        cpu_s = time.perf_counter() - t
        diff = float((preds[name] - ref).abs().max())
        scale = max(float(ref.abs().max()), 1.0)
        print(f"eval {name} vs CPU plain path: max |diff| {diff:.3e} "
              f"(rel {diff / scale:.3e}, bound {CPU_RTOL[name]:.0e}; "
              f"CPU forward {cpu_s:.1f} s)", flush=True)
        if not diff <= CPU_RTOL[name] * scale:
            raise RuntimeError(f"{name} predictions on the card disagree with the CPU plain path")
    shift = float((preds["bfloat16"] - preds["float32"]).abs().max()) / scale
    print(f"eval bfloat16 vs float32 on the card: rel {shift:.3e} (must exceed {BF16_MIN_SHIFT:.0e})")
    if not shift > BF16_MIN_SHIFT:
        raise RuntimeError("bfloat16 predictions equal the float32 ones: compute_dtype was ignored")
    return models["float32"]


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
    from equiformer_tpu_torch.kernels import _build

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
    counts, max_edges = max_edges_for(batches, BATCH)
    print(f"batches: {N_BATCHES} x {BATCH} graphs, real edges {counts}, max_edges {max_edges}")
    make = pt.model_entrypoint("graph_attention_transformer_nonlinear_l2")  # on the card
    gpu_batches = [b.to(dev) for b in batches]

    out, records = {}, []
    t = time.time()
    model32 = eval_phase(pt, torch, make, max_edges, batches, gpu_batches, dev, out)
    print(f"eval phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    kernel_phase(torch, model32, gpu_batches[0], dev, records)
    del model32
    print(f"kernel phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    train_phase(pt, torch, make, max_edges, gpu_batches, dev, out)
    print(f"train phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    train_vs_cpu(pt, torch, make, data, dev)
    print(f"train vs CPU phase: {time.time() - t:.1f} s", flush=True)

    table = []
    for name in SOURCES:
        # the bf16 row at the kernel's first (for K1/K2: the two-head) call site
        r = next(r for r in records if r["kernel"] == name and r["dtype"] == "bfloat16")
        table.append({"name": name, "route": "cuda", "source": SOURCES[name],
                      "replaces": TPU_KERNELS[name], "launches": out["train_launches"][name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
