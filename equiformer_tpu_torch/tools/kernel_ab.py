"""K1 (the fused DTP + linear forward), K2 (its backward), K3 (the CSR
segment sum), K4 (the attention combine), K7-F (the radial-folded
forward), K7-B (its backward), K5a (the force backward: dx, dsh and dw of
the force models' fused op), K5b (its edge legs), K5c (its head-weight
leg), K7-L, K7-Wr and K7-LW (the folded op's x / sh / h, [Wr; offset] and
head-weight legs), K7-B3 (its force backward), K8-F and K8-B (the
kron-basis forward and backward), K6-T (the unfused route's T primitive),
K6-FB (its first-order backward in one launch), K6-R (its R primitive),
S1-A (kbench's staged T) and S2 (``chip_peaks``' FMA probe) of this
package against another tree's, in turns, on one GPU.

    python -m equiformer_tpu_torch.tools.kernel_ab [--against DIR [DIR ...]]
        [--kernels K1,K4] [--out FILE]

Each ``DIR`` is the root of another copy of the repository (the parent
commit unpacked with ``git archive``, or a variant of a kernel's source);
its ``equiformer_tpu_torch`` is loaded as another package, whose wrappers
build their own kernels (into ``DIR/build/``) and launch them, so each
side runs its own wrapper and kernel on the same input tensors.  The sides
run in turns (package, the DIRs in order, then back: package, a, b, b, a,
package), so they compare within one call on one card; a side is named
by its directory.  ``--kernels`` picks the sections (all by default).

The shapes are ``chip_smoke.py``'s: batch 0 of the QM9 geometry (128
QM9-like graphs of 30 slots, seed 0, radius 5; ``max_edges`` the largest
of 4 batches' real edge counts rounded up to 128) and of the MD17 one (8
md17-like molecules of 21 slots).  K3 runs at its shapes: at QM9 the
edge-degree scatter [E, 480] (masked) and the message gathers' backward
[E, 480] (unmasked: the 3464 padding edges on the last node are summed),
at MD17 the edge-degree scatter [E, 864], the attention sums [E, 4, 216]
(both masked) and the gathers' backward [E, 864]; K1 and K2 at the QM9
flagship's three sites (sep_act, sep_value with shared weights folded into
W, the edge-degree embedding with its row-broadcast x), K1 also at MD17
L3's sep_act; K4 at QM9's [E, 4, 120] with and without the alpha-dropout
multiplier, the padding edges masked; K7-F at the folded flagship's
sep_act and the folded exp_l3's; K7-B at the folded flagship's sep_act and
edge degree; K7-L's x, sh and h legs, K7-Wr (h's ones column 1) and K7-LW
at the folded exp_l3's sep_act and edge degree (K7-F and K7-L with this
package's unfolded pair beside them as ``pair_ms``: cuBLAS ``w = h @ Wr +
offset`` then K1 or K5b's leg, or K5b's w leg then cuBLAS ``dw Wr^T``);
K7-B3 at the folded exp_l3's sep_act and edge degree with each caller's
outputs (``K7B3_NEEDS``), its unfolded pair beside it (cuBLAS w, K5a with
the same outputs, cuBLAS ``dh = dw Wr^T``); K8-F and K8-B at the kron
flagship's three sites (G built by each side's ``kron_meta``, this
package's K1 or K2 on the same inputs beside it as ``k1_ms`` or
``k2_ms``); K5a with each caller's outputs (``K5A_NEEDS``), K5b's x, sh and
w legs (no w leg at sep_value, whose weights are shared) and K5c at MD17
exp_l3's three sites (sep_act, sep_value, the edge degree), a leg's own
operand None; K6-T (forward, x leg, w leg) and K6-FB at the unfused
flagship's three sites and exp_l3's sep_act, every row live, each side on
its own models' term lists, K6-FB beside the sum of its three parts on the
same side (``parts_ms``: K6-T's x and w legs and K6-R) and ``bitwise`` the
outputs equal in every bit to the first other tree's; K6-R at the same
sites with ``fb_dsh_bitwise`` (its output K6-FB's dsh in every bit) and its
``layouts`` (as K6-FB's); S1-A at kbench's shapes (E = 40960), dense and in
slots, beside this package's K6-T (``k6t_ms``, ``k6t_bitwise``) and at each
edge tile (``tiles``); S2 at ``chip_peaks``' two shapes (``FMA_SHAPES``, grid
64) on 1 + 0.1 N(0, 1) inputs, ``bitwise`` against the first other tree,
and the narrow shape also at K = ``S2_RATE_K``, where the loads and stores
are a small share and the kernel time is the FMA rate.  K5a's (dx, dw)
runs beside K2's own launch 1 on the same inputs (S3 ``dtp_lin_bwd_stage``
at ``DXDW_STAGE``: the compile-time dx / dw code, whole tiles), where its
shared memory fits.  Random operands from
seed 0, the batch's real edges live.  Per shape and dtype (float32, bfloat16):

* ``ms``: each side's wrapper, CUDA events (median of 5 runs of 5 calls);
  ``host_us`` (K3): its host time a call (median of 5 runs of 100 calls
  without a synchronize), which bounds ``ms`` at the small MD17 shapes;
* ``device_ms`` (K3, K4, K5a-c, K7-F, K7-L, K7-B, K7-B3, K7-Wr, K7-LW,
  K8-F, K8-B, K6-T, K6-FB, K6-R, S1-A): each side's device time per call, all its kernels (gathers
  too), ``kernel_ms`` the kernel alone (K5a-c, K7-L, K7-B, K7-B3, K7-Wr,
  K7-LW, K8-B: their launches and sums) and
  ``by_kernel`` each of those by name,
  from a profiler trace of 20 calls;
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
import importlib
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
from .. import kernels
from ..kernels.dtp_lin import DXDW_STAGE
from ..kernels import (
    attn_combine_plain,
    attn_den_plain,
    dtp_lin_bwd_plain,
    dtp_lin_plain,
    dtp_lin_rad_plain,
    segment_sum_plain,
)
from ..utils.profiling import card_line, device_time_ms, kernel_ms, resolve_device

SEED = 0
# model, graphs per batch, node slots per graph
QM9 = ("graph_attention_transformer_nonlinear_l2", 128, 30)
MD17 = ("graph_attention_transformer_nonlinear_exp_l3_md17", 8, 21)
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"
K3_KERNEL = "csr_segment_sum_kernel"
K4_KERNEL = "attn_combine_kernel"
# the K5a-c kernels of this design (k2::; the split partials' sum, named
# sum_dx_kernel and bwd3_sum_kernel before K7-B3 shared it) and of the first
# one
SPLIT_SUMS = ("split_sum_kernel", "sum_dx_kernel", "bwd3_sum_kernel")
K5A_KERNELS = ("bwd3_kernel", *SPLIT_SUMS)
K5B_KERNELS = ("edge_leg_kernel", "sh_leg_kernel", *SPLIT_SUMS, "dtp_lin_leg_kernel")
K5C_KERNELS = ("W_leg_kernel", "sum_partial_rows_kernel")
# K7-F's, K7-L's, K7-B's, K7-B3's, K7-Wr's and K7-LW's kernels, of this
# design (k1::, k2::) and of the first one
K7_KERNELS = {"K7F": ("rad_fwd_kernel", "dtp_lin_fwd_kernel"),
              "K7L": ("rad_leg_kernel", *SPLIT_SUMS, "dtp_lin_leg_kernel"),
              "K7B3": ("rad_bwd3_kernel", *SPLIT_SUMS, "dtp_lin_bwd3_kernel"),
              "K7B": ("rad_dxdw_kernel", "rad_dW_kernel", "sum_partial_rows_kernel",
                      "dtp_lin_bwd_kernel"),
              "K7Wr": ("edge_leg_kernel", "Wr_leg_kernel", "sum_partial_rows_kernel",
                       "dtp_lin_leg_kernel"),
              "K7LW": ("rad_W_leg_kernel", "sum_partial_rows_kernel", "dtp_lin_legW_kernel")}
# K8-B's kernels, of this design (k2::, K2's launches) and of the first one;
# K8-F's (k1::, and the first design's, of one name)
K8B_KERNELS = ("kron_dxdw_kernel", "kron_dG_kernel", "sum_partial_rows_kernel",
               "kron_bwd_dx_kernel")
K8F_KERNEL = "kron_fwd_kernel"
# K6-T's, K6-R's and K6-FB's kernels
K6_KERNELS = {"K6T": "dtp_t_kernel", "K6R": "dtp_r_kernel", "K6FB": "dtp_fused_bwd_kernel"}
S1A_KERNEL = "dtp_t_staged_kernel"
S2_KERNEL = "fma_"  # fma_kernel; the parent's fma_f32 / fma_bf16_kernel
S2_RATE_K = 4096
SECTIONS = ("K3", "K2", "K1", "K4", "K7F", "K7L", "K7B", "K5a", "K5b", "K5c", "K7Wr", "K7LW",
            "K7B3", "K8F", "K8B", "K6T", "K6FB", "K6R", "S1A", "S2")
# the edge tiles kernel_ab times K6-R at (those whose block fits the card;
# K6-FB's layouts are kernels.dtp.FB_LAYOUTS)
R_TILES = (16, 8, 4, 2, 1)
FB_SMEM_MAX = 227 << 10  # a block's shared memory on the H100
S1A_EDGES = 40960  # kbench's edge count
S1A_TILES = (1, 2, 4, 8)  # the edge tiles kernel_ab times S1-A at
# K6-T's members at each site: name -> (the member of a TermList, its
# operands (a, col, b) from the DTP's x, sh, w and the cotangent ct)
K6T_MEMBERS = {"fwd": (lambda kd, tl: tl, lambda x, sh, w, ct: (x, sh, w)),
               "x": (lambda kd, tl: kd.perm_a(tl), lambda x, sh, w, ct: (ct, sh, w)),
               "w": (lambda kd, tl: kd.perm_b(tl), lambda x, sh, w, ct: (x, sh, ct))}
# the outputs each caller of K5a asks for at MD17's sites: the force pass and
# (dx, dw) the parameter pass of training
K5A_NEEDS = {"md17-sep_act": (("x", "sh", "w"), ("x", "w")), "md17-sep_value": (("x", "sh"),),
             "md17-edge_deg": (("sh", "w"), ("x", "w"))}
# and of K7-B3 at the folded sites (dh for dw)
K7B3_NEEDS = {"md17-sep_act": (("x", "sh", "h"), ("x", "h")),
              "md17-edge_deg": (("sh", "h"), ("x", "h"))}


def load_tree(root: Path, name: str):
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
    batches = list(GraphLoader(dataset, graphs, dense_slots=slots, shuffle=False))
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


def dtp_operands(plan, site, E, dt, dev):
    """Random (x, sh, w or None, W, cotangent) of one fused DTP site, seed 0;
    the edge degree's x is a broadcast row."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)  # noqa: E731
    x = rnd(1, plan.d_x).expand(E, plan.d_x) if "edge_deg" in site else rnd(E, plan.d_x)
    sh, cot, W = rnd(E, plan.d_sh), rnd(E, plan.d_out), 0.05 * rnd(plan.w_numel)
    w = None if plan.shared_weights else rnd(E, plan.d_w)
    return x, sh, w, W, cot


def traced_run(call, tag, kernel):
    """Device time and launches per call of ``call``, and of its ``kernel``
    (a name, or a tuple of names) alone, and ``by_kernel`` each of those
    names' ms a call (the sum over the kernels whose names hold it), from a
    trace of 20 calls."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    per_kernel = kernel_ms(call, 20, TRACE_DIR / f"ab_{tag}.json")
    return {"device_ms": sum(ms for ms, _ in per_kernel.values()),
            "kernel_ms": sum(ms for k, (ms, _) in per_kernel.items()
                             if any(n in k for n in names)),
            "launches": sum(n for _, n in per_kernel.values()),
            "by_kernel": {n: sum(ms for k, (ms, _) in per_kernel.items() if n in k)
                          for n in names if any(n in k for k in per_kernel)}}


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


def k3_section(sides, order, cases, dev, report):
    host_calls = {}
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
                fn = sides[side][0].csr_segment_sum
                call = lambda: fn(val, dst, N, mask)  # noqa: E731
                entry["runs"].append({"side": side, "ms": device_time_ms(call, dev),
                                      **traced_run(call, f"k3_{case}_{side}_{i}", K3_KERNEL),
                                      "rel_err": rel(call(), want)})
            name = f"{case}/{str(dt)[6:]}"
            report["K3"][name] = entry
            host_calls[name] = (lib, [(run, sides[run["side"]][0].csr_segment_sum,
                                       (val, dst, N, mask)) for run in entry["runs"]])
    # host times after every trace: a trace taken after many unsynchronized
    # calls has come back without kernels
    for name, (lib, runs) in host_calls.items():
        report["K3"][name]["index_add_host_us"] = host_us(lib)
        for run, fn, call_args in runs:
            run["host_us"] = host_us(lambda: fn(*call_args))
        print("K3", name, json.dumps(report["K3"][name]), flush=True)


def dtp_section(key, sides, order, plans, rows, dev, report, run_fn, plain_fn, extra=None):
    """One fused DTP kernel (``run_fn(kernels module)``) at each site of
    ``plans[side]``, against ``plain_fn`` of this package, both dtypes."""
    for site, plan in plans["package"].items():
        E, n_live = rows[site]
        for dt in (torch.float32, torch.bfloat16):
            ops = dtp_operands(plan, site, E, dt, dev)
            n = torch.tensor(n_live, dtype=torch.int32, device=dev)
            want = plain_fn(plan, ops, n)
            entry = {"E": E, "n_live": n_live, "runs": []}
            for side in order:
                fn, p = run_fn(sides[side][0]), plans[side][site]
                call = lambda: fn(p, ops, n)  # noqa: E731
                got = call()
                got = got if isinstance(got, tuple) else (got,)
                want_t = want if isinstance(want, tuple) else (want,)
                run = {"side": side, "ms": device_time_ms(call, dev),
                       "rel_err": max(rel(a, b) for a, b in zip(got, want_t) if a is not None)}
                if extra is not None:
                    run.update(extra(call))
                entry["runs"].append(run)
            name = f"{site}/{str(dt)[6:]}"
            report[key][name] = entry
            print(key, name, json.dumps(entry), flush=True)


def k4_section(sides, order, case, dev, report):
    dst, mask, N, (E, _) = case
    n_live, H, D = int(mask.sum()), 4, 120
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(SEED)
        scores = torch.randn(E, H, generator=g, device=dev).to(dt)
        value = torch.randn(E, H, D, generator=g, device=dev).to(dt)
        drop = (torch.rand(E, H, generator=g, device=dev) < 0.8).to(dt) / 0.8
        masked = torch.where(mask[:, None], scores, torch.full_like(scores, -1e30))
        for site, dm in (("qm9-drop", drop), ("qm9-nodrop", None)):
            want = (attn_combine_plain(scores, value, dst, N, mask, dm),
                    attn_den_plain(masked, dst, N))
            entry = {"E": E, "n_live": n_live, "N": N, "H": H, "D": D,
                     "plain_ms": device_time_ms(lambda: (
                         attn_combine_plain(scores, value, dst, N, mask, dm),
                         attn_den_plain(masked, dst, N)), dev), "runs": []}
            for i, side in enumerate(order):
                fn = sides[side][0].attn_combine_fwd
                call = lambda: fn(masked, value, dst, N, mask, dm)  # noqa: E731
                entry["runs"].append({
                    "side": side, "ms": device_time_ms(call, dev),
                    **traced_run(call, f"k4_{site}_{str(dt)[6:]}_{side}_{i}", K4_KERNEL),
                    "rel_err": max(rel(a, b) for a, b in zip(call(), want))})
            name = f"{site}/{str(dt)[6:]}"
            report["K4"][name] = entry
            print("K4", name, json.dumps(entry), flush=True)


def k5a_section(sides, order, plans, rows, dev, report):
    """K5a at each site of ``plans[side]`` with each caller's outputs,
    against this package's plain version, both dtypes; with (dx, dw) also
    K2's own launch 1 on this package (where its shared memory fits)."""
    for site, plan in plans["package"].items():
        E, n_live = rows[site]
        for need in K5A_NEEDS[site]:
            flags = {f"need_d{k}": k in need for k in ("x", "sh", "w")}
            for dt in (torch.float32, torch.bfloat16):
                x, sh, w, W, cot = dtp_operands(plan, site, E, dt, dev)
                n = torch.tensor(n_live, dtype=torch.int32, device=dev)
                want = [o for o, k in zip(kernels.dtp_lin_bwd3_plain(plan, x, sh, w, W, cot, n),
                                          ("x", "sh", "w")) if k in need]
                entry = {"E": E, "n_live": n_live, "runs": []}
                for i, side in enumerate(order):
                    m, p = sides[side][0], plans[side][site]
                    call = lambda m=m, p=p: m.dtp_lin_bwd3(  # noqa: E731
                        p, x, sh, w, W, cot, n, **flags)
                    tag = f"K5a_{site}_{''.join(need)}_{str(dt)[6:]}_{side}_{i}"
                    got = [o for o in call() if o is not None]
                    entry["runs"].append({
                        "side": side, "ms": device_time_ms(call, dev),
                        **traced_run(call, tag, K5A_KERNELS),
                        "rel_err": max(rel(a, b) for a, b in zip(got, want))})
                if need == ("x", "w"):
                    call = lambda: kernels.dtp_lin_bwd_stage(  # noqa: E731
                        plan, x, sh, w, W, cot, DXDW_STAGE, n)
                    try:
                        entry["k2_launch1_ms"] = device_time_ms(call, dev)
                    except RuntimeError as err:  # a yardstick only: its tile may not fit
                        entry["k2_launch1_ms"] = f"not run: {err}"
                name = f"{site}/{''.join(need)}/{str(dt)[6:]}"
                report["K5a"][name] = entry
                print("K5a", name, json.dumps(entry), flush=True)


def k5_section(key, sides, order, plans, rows, dev, report):
    """K5b's x, sh and w legs (``key`` "K5b") or K5c ("K5c") at each site of
    ``plans[side]``, against this package's plain versions, both dtypes."""
    legs = ("x", "sh", "w") if key == "K5b" else ("W",)
    for site, plan in plans["package"].items():
        E, n_live = rows[site]
        for leg in legs:
            if leg == "w" and plan.shared_weights:
                continue
            for dt in (torch.float32, torch.bfloat16):
                x, sh, w, W, cot = dtp_operands(plan, site, E, dt, dev)
                n = torch.tensor(n_live, dtype=torch.int32, device=dev)
                ops = {"x": x, "sh": sh, "w": w, leg: None}
                if leg == "W":
                    want = kernels.dtp_lin_legW_plain(plan, cot, x, sh, w, n)
                else:
                    want = kernels.dtp_lin_leg_plain(plan, leg, cot, ops["x"], ops["sh"],
                                                     ops["w"], W, n)
                entry = {"E": E, "n_live": n_live, "runs": []}
                for i, side in enumerate(order):
                    m, p = sides[side][0], plans[side][site]
                    if leg == "W":
                        call = lambda m=m, p=p: m.dtp_lin_legW(p, cot, x, sh, w, n)  # noqa: E731
                    else:
                        call = lambda m=m, p=p: m.dtp_lin_leg(  # noqa: E731
                            p, leg, cot, ops["x"], ops["sh"], ops["w"], W, n)
                    tag = f"{key}_{site}_{leg}_{str(dt)[6:]}_{side}_{i}"
                    entry["runs"].append({
                        "side": side, "ms": device_time_ms(call, dev),
                        **traced_run(call, tag, K5B_KERNELS if key == "K5b" else K5C_KERNELS),
                        "rel_err": rel(call(), want)})
                name = f"{site}/{leg}/{str(dt)[6:]}"
                report[key][name] = entry
                print(key, name, json.dumps(entry), flush=True)


def k7_calls(key, m, p, ops, n):
    """Side ``m``'s call(s) of K7 kernel ``key`` on plan ``p`` and ``ops`` =
    (x, sh, h, Wrs, W, cot): name suffix -> a call returning a tuple."""
    x, sh, h, Wrs, W, cot = ops
    if key == "K7F":
        return {"": lambda: (m.dtp_lin_rad_fwd(p, x, sh, h, Wrs, W, n),)}
    if key == "K7L":
        legs = {}
        for leg in ("x", "sh", "h"):
            o = {"x": x, "sh": sh, "h": h, leg: None}
            legs[f"/{leg}"] = lambda o=o, leg=leg: (m.dtp_lin_rad_leg(
                p, leg, cot, o["x"], o["sh"], o["h"], Wrs, W, n),)
        return legs
    if key == "K7B":
        return {"": lambda: m.dtp_lin_rad_bwd(p, x, sh, h, Wrs, W, cot, n)}
    if key == "K7B3":  # the outputs by flag: the parent's wrapper took no need_dh
        return {"/" + "".join(need): lambda need=need: tuple(o for o in m.dtp_lin_rad_bwd3(
            p, x, sh, h, Wrs, W, cot, n, need_dx="x" in need, need_dsh="sh" in need)
            if o is not None) for need in K7B3_NEEDS[site_of(p, x)]}
    if key == "K7LW":
        return {"": lambda: (m.dtp_lin_rad_legW(p, cot, x, sh, h, Wrs, n),)}
    return {"": lambda: (m.dtp_lin_rad_legWr(p, cot, x, sh, h, W, n),)}


def site_of(plan, x) -> str:
    """The folded MD17 site of K7-B3's operands: the edge degree's x is a
    row-broadcast."""
    return "md17-edge_deg" if x.stride(0) == 0 else "md17-sep_act"


def k7_pairs(key, plan, ops, n):
    """This package's unfolded pair of K7-F (cuBLAS ``w = h @ Wr + offset``,
    then K1) or of K7-L's legs (cuBLAS w, then K5b's x or sh leg; K5b's w
    leg, then cuBLAS ``dh = dw Wr^T``), by name suffix; none for the
    others."""
    x, sh, h, Wrs, W, cot = ops
    unf = kernels.DTPLinPlan(plan.tp, plan.head_irreps)  # the same op, w given
    w = lambda: torch.addmm(Wrs[-1], h, Wrs[:-1])  # noqa: E731
    if key == "K7F":
        return {"": lambda: kernels.dtp_lin_fwd(unf, x, sh, w(), W, n)}
    if key == "K7B3":
        def pair(need):
            dx, dsh, dw = kernels.dtp_lin_bwd3(unf, x, sh, w(), W, cot, n, "x" in need,
                                               "sh" in need)
            return tuple(o for o in (dx, dsh, dw @ Wrs[:-1].t()) if o is not None)

        return {"/" + "".join(need): lambda need=need: pair(need)
                for need in K7B3_NEEDS[site_of(plan, x)]}
    if key != "K7L":
        return {}
    return {"/x": lambda: kernels.dtp_lin_leg(unf, "x", cot, None, sh, w(), W, n),
            "/sh": lambda: kernels.dtp_lin_leg(unf, "sh", cot, x, None, w(), W, n),
            "/h": lambda: kernels.dtp_lin_leg(unf, "w", cot, x, sh, None, W, n) @ Wrs[:-1].t()}


def k7_wants(key, plan, ops, n):
    """This package's plain versions, by name suffix (tuples)."""
    x, sh, h, Wrs, W, cot = ops
    if key == "K7F":
        return {"": (dtp_lin_rad_plain(plan, x, sh, h, Wrs, W, n),)}
    if key == "K7L":
        want = {}
        for leg in ("x", "sh", "h"):
            o = {"x": x, "sh": sh, "h": h, leg: None}
            want[f"/{leg}"] = (kernels.dtp_lin_rad_leg_plain(plan, leg, cot, o["x"], o["sh"],
                                                             o["h"], Wrs, W, n),)
        return want
    if key == "K7B":
        return {"": kernels.dtp_lin_rad_bwd_plain(plan, x, sh, h, Wrs, W, cot, n)}
    if key == "K7B3":
        p = dict(zip(("x", "sh", "h"), kernels.dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wrs, W,
                                                                     cot, n)))
        return {"/" + "".join(need): tuple(p[k] for k in need)
                for need in K7B3_NEEDS[site_of(plan, x)]}
    if key == "K7LW":
        return {"": (kernels.dtp_lin_rad_legW_plain(plan, cot, x, sh, h, Wrs, n),)}
    return {"": (kernels.dtp_lin_rad_legWr_plain(plan, cot, x, sh, h, W, n),)}


def k7_section(key, sides, order, plans, rows, dev, report):
    """K7-F (``key`` "K7F"), K7-L ("K7L": the x, sh and h legs, a leg's own
    operand None), K7-B ("K7B": dx, dh, d[Wr; offset], dW), K7-B3 ("K7B3":
    each caller's outputs), K7-Wr ("K7Wr", h's ones column 1) or K7-LW
    ("K7LW") at each folded site of ``plans[side]``, against this package's
    plain version, both dtypes, with this package's unfolded pair (K7-F,
    K7-L, K7-B3) as ``pair_ms``; h and [Wr; offset] random from seed 1, made
    once per site and dtype."""
    for site, plan in plans["package"].items():
        E, n_live = rows[site]
        hd = plan.radial_fold
        for dt in (torch.float32, torch.bfloat16):
            x, sh, _, W, cot = dtp_operands(plan, site, E, dt, dev)
            g = torch.Generator(device=dev).manual_seed(SEED + 1)
            h = torch.randn(E, hd, generator=g, device=dev).to(dt)
            Wrs = 0.1 * torch.randn(hd + 1, plan.d_w, generator=g, device=dev).to(dt)
            n = torch.tensor(n_live, dtype=torch.int32, device=dev)
            ops = (x, sh, h, Wrs, W, cot)
            pairs = k7_pairs(key, plan, ops, n)
            for suffix, want in k7_wants(key, plan, ops, n).items():
                entry = {"E": E, "n_live": n_live, "runs": []}
                if suffix in pairs:
                    entry["pair_ms"] = device_time_ms(pairs[suffix], dev)
                for i, side in enumerate(order):
                    call = k7_calls(key, sides[side][0], plans[side][site], ops, n)[suffix]
                    tag = f"{key}_{site}{suffix.replace('/', '_')}_{str(dt)[6:]}_{side}_{i}"
                    entry["runs"].append({
                        "side": side, "ms": device_time_ms(call, dev),
                        **traced_run(call, tag, K7_KERNELS[key]),
                        "rel_err": max(rel(a, b) for a, b in zip(call(), want))})
                name = f"{site}{suffix}/{str(dt)[6:]}"
                report[key][name] = entry
                print(key, name, json.dumps(entry), flush=True)


def k8f_section(sides, order, plans, rows, dev, report):
    """K8-F at each kron site of ``plans[side]`` (G from each side's
    ``kron_meta(plan).build_G``), against this package's plain version,
    both dtypes, with this package's K1 on the same inputs (W in G's place)
    as ``k1_ms``."""
    for site, plan in plans["package"].items():
        E, n_live = rows[site]
        for dt in (torch.float32, torch.bfloat16):
            x, sh, w, W, _ = dtp_operands(plan, site, E, dt, dev)
            n = torch.tensor(n_live, dtype=torch.int32, device=dev)
            meta = kernels.kron_meta(plan)
            want = kernels.dtp_lin_kron_plain(meta, x, sh, w, meta.build_G(W), n)
            entry = {"E": E, "n_live": n_live, "numel": meta.numel, "runs": [],
                     "k1_ms": device_time_ms(
                         lambda: kernels.dtp_lin_fwd(plan, x, sh, w, W, n), dev)}
            for i, side in enumerate(order):
                m, p = sides[side][0], plans[side][site]
                G = m.kron_meta(p).build_G(W)
                call = lambda m=m, p=p, G=G: m.dtp_lin_kron_fwd(  # noqa: E731
                    m.kron_meta(p), x, sh, w, G, n)
                tag = f"K8F_{site}_{str(dt)[6:]}_{side}_{i}"
                entry["runs"].append({
                    "side": side, "ms": device_time_ms(call, dev),
                    **traced_run(call, tag, K8F_KERNEL), "rel_err": rel(call(), want)})
            name = f"{site}/{str(dt)[6:]}"
            report["K8F"][name] = entry
            print("K8F", name, json.dumps(entry), flush=True)


def k8b_section(sides, order, plans, rows, dev, report):
    """K8-B at each kron site of ``plans[side]`` (G from each side's
    ``kron_meta(plan).build_G``), against this package's plain version,
    both dtypes, with this package's K2 on the same inputs (W in G's place)
    as ``k2_ms``."""
    for site, plan in plans["package"].items():
        E, n_live = rows[site]
        for dt in (torch.float32, torch.bfloat16):
            x, sh, w, W, cot = dtp_operands(plan, site, E, dt, dev)
            n = torch.tensor(n_live, dtype=torch.int32, device=dev)
            meta = kernels.kron_meta(plan)
            want = kernels.dtp_lin_kron_bwd_plain(meta, x, sh, w, meta.build_G(W), cot, n)
            entry = {"E": E, "n_live": n_live, "numel": meta.numel, "runs": [],
                     "k2_ms": device_time_ms(
                         lambda: kernels.dtp_lin_bwd(plan, x, sh, w, W, cot, n), dev)}
            for i, side in enumerate(order):
                m, p = sides[side][0], plans[side][site]
                G = m.kron_meta(p).build_G(W)
                call = lambda m=m, p=p, G=G: m.dtp_lin_kron_bwd(  # noqa: E731
                    m.kron_meta(p), x, sh, w, G, cot, n)
                tag = f"K8B_{site}_{str(dt)[6:]}_{side}_{i}"
                entry["runs"].append({
                    "side": side, "ms": device_time_ms(call, dev),
                    **traced_run(call, tag, K8B_KERNELS),
                    "rel_err": max(rel(a, b) for a, b in zip(call(), want) if a is not None)})
            name = f"{site}/{str(dt)[6:]}"
            report["K8B"][name] = entry
            print("K8B", name, json.dumps(entry), flush=True)


def k6_lists(sides, E, mE, dev):
    """Each side's K6 term lists from its unfused models: {side: {site:
    (TermList, x broadcast, w broadcast)}} at the QM9 flagship's three
    sites and MD17 exp_l3's sep_act."""
    lists = {}
    for side, (_, make) in sides.items():
        q = make(QM9[0])(max_edges=E, nodes_per_graph=QM9[2], seed=SEED, device=dev,
                         fused_dtp_lin=False)
        m = make(MD17[0])(max_edges=mE, nodes_per_graph=MD17[2], seed=SEED, device=dev,
                          fused_dtp_lin=False)
        ga = q.block_0.ga
        lists[side] = {"sep_act": (ga.sep_act.dtp.terms, False, False),
                       "sep_value": (ga.sep_value.dtp.terms, False, True),
                       "edge_deg": (q.edge_deg_embed.dw.terms, True, False),
                       "md17-sep_act": (m.block_0.ga.sep_act.dtp.terms, False, False)}
    return lists


def k6_operands(tl, shared_x, shared_w, E, dt, dev):
    """Random (x, sh, w, cotangent) of one K6 site, seed 0, every row live
    (the unfused route computes the padding rows too): the edge degree's x
    an expanded row, sep_value's w one row."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)  # noqa: E731
    x = rnd(1, tl.d_a).expand(E, tl.d_a) if shared_x else rnd(E, tl.d_a)
    sh = rnd(E, tl.d_col)
    w = rnd(1, tl.d_b) if shared_w else rnd(E, tl.d_b)
    return x, sh, w, rnd(E, tl.d_out)


def _bitwise(runs, outs, names):
    """Each run's ``bitwise``: its outputs equal in every bit to those of
    the first other tree's first run (None without another tree)."""
    ref = next((o for run, o in zip(runs, outs) if run["side"] == names[0]), None) \
        if names else None
    for run, o in zip(runs, outs):
        run["bitwise"] = None if ref is None else all(
            torch.equal(a, b) for a, b in zip(o, ref))


def k6t_section(sides, order, lists, rows, dev, report):
    """K6-T's forward and x and w legs at each site of ``lists[side]``,
    against this package's plain version, both dtypes; ``bitwise``: the
    output equal to the first other tree's K6-T."""
    names = [s for s in order if s != "package"]
    for site, (tl, sx, sw) in lists["package"].items():
        E = rows[site][0]
        for dt in (torch.float32, torch.bfloat16):
            x, sh, w, ct = k6_operands(tl, sx, sw, E, dt, dev)
            for member, (perm, args) in K6T_MEMBERS.items():
                ops = args(x, sh, w, ct)
                want = kernels.dtp.dtp_t_plain(perm(kernels.dtp, tl), *ops)
                entry, outs = {"E": E, "runs": []}, []
                for i, side in enumerate(order):
                    kd = sides[side][0].dtp
                    m = perm(kd, lists[side][site][0])
                    call = lambda kd=kd, m=m: kd.dtp_t(m, *ops)  # noqa: E731
                    tag = f"K6T_{site}_{member}_{str(dt)[6:]}_{side}_{i}"
                    outs.append((call(),))
                    entry["runs"].append({
                        "side": side, "ms": device_time_ms(call, dev),
                        **traced_run(call, tag, K6_KERNELS["K6T"]),
                        "rel_err": rel(outs[-1][0], want)})
                _bitwise(entry["runs"], outs, names)
                name = f"{site}-{member}/{str(dt)[6:]}"
                report["K6T"][name] = entry
                print("K6T", name, json.dumps(entry), flush=True)
                del outs


def k6fb_section(sides, order, lists, rows, dev, report):
    """K6-FB at each site of ``lists[side]`` beside the sum of its three
    parts on the same side (K6-T's x and w legs, K6-R), against this
    package's plain version, both dtypes; ``legs_bitwise``: dx and dw equal
    in every bit to the legs' outputs; ``bitwise``: all three to the first
    other tree's K6-FB; ``layouts``: this package's K6-FB kernel ms at each
    of ``kernels.dtp.FB_LAYOUTS`` that fits, and whether its outputs are the same bits
    (the first design took no layout: none there)."""
    names = [s for s in order if s != "package"]
    for site, (tl, sx, sw) in lists["package"].items():
        E = rows[site][0]
        for dt in (torch.float32, torch.bfloat16):
            x, sh, w, ct = k6_operands(tl, sx, sw, E, dt, dev)
            want = kernels.dtp.dtp_fused_bwd_plain(tl, x, sh, w, ct)
            entry, outs = {"E": E, "runs": []}, []
            for i, side in enumerate(order):
                kd, stl = sides[side][0].dtp, lists[side][site][0]
                call = lambda kd=kd, stl=stl: kd.dtp_fused_bwd(stl, x, sh, w, ct)  # noqa: E731
                parts = lambda kd=kd, stl=stl: (  # noqa: E731
                    kd.dtp_t(kd.perm_a(stl), ct, sh, w), kd.dtp_r(stl, x, w, ct),
                    kd.dtp_t(kd.perm_b(stl), x, sh, ct))
                tag = f"K6FB_{site}_{str(dt)[6:]}_{side}_{i}"
                outs.append(call())
                legs = parts()
                traced = traced_run(parts, f"{tag}_parts", (K6_KERNELS["K6T"], K6_KERNELS["K6R"]))
                entry["runs"].append({
                    "side": side, "ms": device_time_ms(call, dev),
                    **traced_run(call, tag, K6_KERNELS["K6FB"]),
                    "parts_ms": device_time_ms(parts, dev), "parts_kernel_ms": traced["kernel_ms"],
                    "parts_by_kernel": traced["by_kernel"],
                    "legs_bitwise": all(torch.equal(outs[-1][i], legs[i]) for i in (0, 2)),
                    "rel_err": max(rel(a, b) for a, b in zip(outs[-1], want))})
            _bitwise(entry["runs"], outs, names)
            entry["layouts"] = {}  # this package's K6-FB at each (edge tile, g staged) that fits
            n_slots = tl.fb_plan(torch.device("cpu"), 4, 1)[5]
            for tile, gs in kernels.dtp.FB_LAYOUTS:
                if kernels.dtp._fb_bytes(tile, x.element_size(), sx, sw, gs, tl.d_a, tl.d_b,
                                         tl.d_out, tl.d_col, n_slots) > FB_SMEM_MAX:
                    continue
                call = lambda: kernels.dtp.dtp_fused_bwd(tl, x, sh, w, ct, (tile, gs))  # noqa: E731
                same = all(torch.equal(a, b) for a, b in zip(call(), outs[0]))
                entry["layouts"][f"{tile}{'g' if gs else ''}"] = [traced_run(
                    call, f"K6FB_{site}_{str(dt)[6:]}_{tile}{gs}", K6_KERNELS["K6FB"])[
                        "kernel_ms"], same]
            name = f"{site}/{str(dt)[6:]}"
            report["K6FB"][name] = entry
            print("K6FB", name, json.dumps(entry), flush=True)
            del outs


def k6r_section(sides, order, lists, rows, dev, report):
    """K6-R at each site of ``lists[side]`` against this package's plain
    version, both dtypes; ``fb_dsh_bitwise``: its output equal in every bit
    to K6-FB's dsh on the same side and operands; ``bitwise``: to the first
    other tree's K6-R; ``layouts``: this package's K6-R kernel ms (traced)
    and wrapper ms (CUDA events) at each of ``R_TILES`` that fits, and
    whether its output is the same bits
    (the first design took no layout: none there)."""
    names = [s for s in order if s != "package"]
    for site, (tl, sx, sw) in lists["package"].items():
        E = rows[site][0]
        for dt in (torch.float32, torch.bfloat16):
            x, sh, w, ct = k6_operands(tl, sx, sw, E, dt, dev)
            want = kernels.dtp.dtp_r_plain(tl, x, w, ct)
            entry, outs = {"E": E, "runs": []}, []
            for i, side in enumerate(order):
                kd, stl = sides[side][0].dtp, lists[side][site][0]
                call = lambda kd=kd, stl=stl: kd.dtp_r(stl, x, w, ct)  # noqa: E731
                tag = f"K6R_{site}_{str(dt)[6:]}_{side}_{i}"
                outs.append((call(),))
                entry["runs"].append({
                    "side": side, "ms": device_time_ms(call, dev),
                    **traced_run(call, tag, K6_KERNELS["K6R"]),
                    "fb_dsh_bitwise": torch.equal(outs[-1][0],
                                                  kd.dtp_fused_bwd(stl, x, sh, w, ct)[1]),
                    "rel_err": rel(outs[-1][0], want)})
            _bitwise(entry["runs"], outs, names)
            entry["layouts"] = {}  # this package's K6-R at each edge tile that fits
            n_slots = tl.r_plan(torch.device("cpu"), 4, 1)[3]
            for tile in R_TILES:
                if kernels.dtp._fb_bytes(tile, x.element_size(), sx, False, False, tl.d_a, 0,
                                         tl.d_out, 0, n_slots) > FB_SMEM_MAX:
                    continue
                call = lambda: kernels.dtp.dtp_r(tl, x, w, ct, tile)  # noqa: E731
                entry["layouts"][str(tile)] = [traced_run(
                    call, f"K6R_{site}_{str(dt)[6:]}_{tile}", K6_KERNELS["K6R"])[
                        "kernel_ms"], device_time_ms(call, dev), torch.equal(call(), outs[0][0])]
            name = f"{site}/{str(dt)[6:]}"
            report["K6R"][name] = entry
            print("K6R", name, json.dumps(entry), flush=True)
            del outs


def s1a_section(sides, order, dev, report):
    """S1-A at kbench's shapes (the flagship's sep_act DTP, E = S1A_EDGES),
    dense and in 128-column slots, against this package's plain version,
    both dtypes, beside this package's K6-T on the same inputs (``k6t_ms``,
    kernel device time); ``k6t_bitwise``: the dense output equal in every
    bit to that K6-T's; ``bitwise``: to the first other tree's S1-A;
    ``tiles``: this package's S1-A kernel ms (traced) and wrapper ms (CUDA
    events) at each of ``S1A_TILES``, and whether its output is the same
    bits (the first design took no tile)."""
    from .kbench import flagship_tp

    names = [s for s in order if s != "package"]
    tp = flagship_tp()
    tl = kernels.TermList.for_plan(tp, fold_rescale=True)
    z_slots = kernels.make_layouts(tp)[4]
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(SEED)
        x, sh, w = (torch.randn(S1A_EDGES, d, generator=g, device=dev).to(dt)
                    for d in (tl.d_a, tl.d_col, tl.d_b))
        k6t = lambda: kernels.dtp_t(tl, x, sh, w)  # noqa: E731
        for layout, slots in (("dense", None), ("slots", z_slots)):
            want = kernels.dtp_t_staged_plain(tl, x, sh, w, slots)
            entry, outs = {"E": S1A_EDGES, "runs": [], "k6t_ms": traced_run(
                k6t, f"S1A_{layout}_{str(dt)[6:]}_k6t", K6_KERNELS["K6T"])["kernel_ms"]}, []
            for i, side in enumerate(order):
                m = sides[side][0]  # each side on its own term list and slots
                stp = importlib.import_module(
                    f"{m.__name__.rpartition('.')[0]}.tools.kbench").flagship_tp()
                stl, ss = m.TermList.for_plan(stp, True), slots and m.make_layouts(stp)[4]
                call = lambda m=m, stl=stl, ss=ss: m.dtp_t_staged(stl, x, sh, w, ss)  # noqa: E731
                tag = f"S1A_{layout}_{str(dt)[6:]}_{side}_{i}"
                outs.append((call(),))
                entry["runs"].append({
                    "side": side, "ms": device_time_ms(call, dev),
                    **traced_run(call, tag, S1A_KERNEL), "rel_err": rel(outs[-1][0], want)})
            _bitwise(entry["runs"], outs, names)
            if slots is None:
                entry["k6t_bitwise"] = torch.equal(outs[0][0], k6t())
            entry["tiles"] = {}
            for tile in S1A_TILES:
                call = lambda: kernels.dtp_t_staged(tl, x, sh, w, slots, tile)  # noqa: E731
                entry["tiles"][str(tile)] = [traced_run(
                    call, f"S1A_{layout}_{str(dt)[6:]}_{tile}", S1A_KERNEL)["kernel_ms"],
                    device_time_ms(call, dev), torch.equal(call(), outs[0][0])]
            name = f"kbench-{layout}/{str(dt)[6:]}"
            report["S1A"][name] = entry
            print("S1A", name, json.dumps(entry), flush=True)
            del outs


def s2_section(sides, order, dev, report):
    """S2 (the FMA probe) at chip_peaks' shapes and, narrow, at K =
    S2_RATE_K, both dtypes: each side in turns (wrapper ms by CUDA events,
    kernel ms traced, ``rel_err`` against the plain version, ``bitwise``
    against the first other tree)."""
    from .chip_peaks import FMA_SHAPES
    from ..kernels import peaks

    names = [s for s in order if s != "package"]
    cases = [(v, t, w, k) for v, t, w, k in FMA_SHAPES]
    cases += [(f"{v}-k{S2_RATE_K}", t, w, S2_RATE_K) for v, t, w, _ in FMA_SHAPES if v == "narrow"]
    for dt in (torch.float32, torch.bfloat16):
        for variant, t, width, k in cases:
            g = torch.Generator(device=dev).manual_seed(SEED)
            x = (1.0 + 0.1 * torch.randn(64 * t, width, generator=g, device=dev)).to(dt)
            want = peaks.fma_probe_plain(x, k)
            tag = f"S2_{variant}_{str(dt)[6:]}"
            entry, outs = {"shape": [64 * t, width], "k": k, "runs": []}, []
            for i, side in enumerate(order):
                call = lambda m=sides[side][0]: m.fma_probe(x, k)  # noqa: E731
                outs.append((call(),))
                entry["runs"].append({
                    "side": side, "ms": device_time_ms(call, dev),
                    **traced_run(call, f"{tag}_{side}_{i}", S2_KERNEL),
                    "rel_err": rel(outs[-1][0], want)})
            _bitwise(entry["runs"], outs, names)
            name = f"{variant}/{str(dt)[6:]}"
            report["S2"][name] = entry
            print("S2", name, json.dumps(entry), flush=True)
            del outs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", default=[],
                    help="roots of other copies whose kernels run in turns with these")
    ap.add_argument("--kernels", default=",".join(SECTIONS),
                    help=f"comma-separated sections, of {', '.join(SECTIONS)}")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    want = args.kernels.split(",")
    if not set(want) <= set(SECTIONS):
        ap.error(f"--kernels takes {', '.join(SECTIONS)}")
    dev = resolve_device(None)
    card = card_line()
    print(card, flush=True)
    sides = {"package": (kernels, model_entrypoint)}
    for i, root in enumerate(args.against):
        other = load_tree(root.resolve(), f"eqt_other{i}")
        sides[root.name] = (other.kernels, other.model_entrypoint)
    names = list(sides)[1:]
    if len(names) != len(args.against) or "package" in names:
        ap.error("the --against directories need distinct names other than 'package'")
    order = ["package", *names, *names[::-1], "package"] if names else ["package"]
    report = {"card": card, "torch": torch.__version__, "order": order,
              **{k: {} for k in SECTIONS if k in want}}

    cases = k3_cases(dev)
    if "K3" in want:
        k3_section(sides, order, cases, dev, report)
    _, mask, _, (E, _) = cases["qm9-edge_deg"]
    _, mmask, _, (mE, _) = cases["md17-edge_deg"]
    rows = {**dict.fromkeys(("sep_act", "sep_value", "edge_deg"), (E, int(mask.sum()))),
            "md17-sep_act": (mE, int(mmask.sum()))}
    if {"K1", "K2"} & set(want):
        plans = {side: dtp_plans(make(QM9[0])(max_edges=E, nodes_per_graph=QM9[2], seed=SEED,
                                              device=dev))
                 for side, (_, make) in sides.items()}
    if "K2" in want:
        dtp_section("K2", sides, order, plans, rows, dev, report, lambda m: (
            lambda p, o, n: m.dtp_lin_bwd(p, o[0], o[1], o[2], o[3], o[4], n)),
            lambda p, o, n: dtp_lin_bwd_plain(p, o[0], o[1], o[2], o[3], o[4], n),
            lambda call: {"scratch_mib": scratch_mib(call, dev)})
    if "K1" in want:
        for side, (_, make) in sides.items():
            md17 = make(MD17[0])(max_edges=mE, nodes_per_graph=MD17[2], seed=SEED, device=dev)
            plans[side]["md17-sep_act"] = md17.block_0.ga.sep_act.plan
        dtp_section("K1", sides, order, plans, rows, dev, report, lambda m: (
            lambda p, o, n: m.dtp_lin_fwd(p, o[0], o[1], o[2], o[3], n)),
            lambda p, o, n: dtp_lin_plain(p, o[0], o[1], o[2], o[3], n))
    if "K4" in want:
        k4_section(sides, order, cases["qm9-edge_deg"], dev, report)
    if "K7F" in want:
        fold = {}
        for side, (_, make) in sides.items():
            q = make(QM9[0])(max_edges=E, nodes_per_graph=QM9[2], seed=SEED, device=dev,
                             radial_fold=True)
            m = make(MD17[0])(max_edges=mE, nodes_per_graph=MD17[2], seed=SEED, device=dev,
                              radial_fold=True, radial_fold_ho=True)
            fold[side] = {"sep_act": q.block_0.ga.sep_act.plan,
                          "md17-sep_act": m.block_0.ga.sep_act.plan}
        k7_section("K7F", sides, order, fold, rows, dev, report)
    if "K7B" in want:
        fold = {}
        for side, (_, make) in sides.items():
            m = make(QM9[0])(max_edges=E, nodes_per_graph=QM9[2], seed=SEED, device=dev,
                             radial_fold=True)
            fold[side] = {k: v for k, v in dtp_plans(m).items() if k != "sep_value"}
        k7_section("K7B", sides, order, fold, rows, dev, report)
    if "K7L" in want:
        fold = {}
        for side, (_, make) in sides.items():
            m = make(MD17[0])(max_edges=mE, nodes_per_graph=MD17[2], seed=SEED, device=dev,
                              radial_fold=True, radial_fold_ho=True)
            fold[side] = {f"md17-{k}": v for k, v in dtp_plans(m).items() if k != "sep_value"}
        md17_rows = {site: (mE, int(mmask.sum())) for site in fold["package"]}
        k7_section("K7L", sides, order, fold, md17_rows, dev, report)
    if "K7Wr" in want:
        fold = {}
        for side, (_, make) in sides.items():
            m = make(MD17[0])(max_edges=mE, nodes_per_graph=MD17[2], seed=SEED, device=dev,
                              radial_fold=True, radial_fold_ho=True)
            fold[side] = {f"md17-{k}": v for k, v in dtp_plans(m).items() if k != "sep_value"}
        md17_rows = {site: (mE, int(mmask.sum())) for site in fold["package"]}
        k7_section("K7Wr", sides, order, fold, md17_rows, dev, report)
    if "K7LW" in want:
        fold = {}
        for side, (_, make) in sides.items():
            m = make(MD17[0])(max_edges=mE, nodes_per_graph=MD17[2], seed=SEED, device=dev,
                              radial_fold=True, radial_fold_ho=True)
            fold[side] = {f"md17-{k}": v for k, v in dtp_plans(m).items() if k != "sep_value"}
        md17_rows = {site: (mE, int(mmask.sum())) for site in fold["package"]}
        k7_section("K7LW", sides, order, fold, md17_rows, dev, report)
    if "K7B3" in want:
        fold = {}
        for side, (_, make) in sides.items():
            m = make(MD17[0])(max_edges=mE, nodes_per_graph=MD17[2], seed=SEED, device=dev,
                              radial_fold=True, radial_fold_ho=True)
            fold[side] = {f"md17-{k}": v for k, v in dtp_plans(m).items() if k != "sep_value"}
        md17_rows = {site: (mE, int(mmask.sum())) for site in fold["package"]}
        k7_section("K7B3", sides, order, fold, md17_rows, dev, report)
    if {"K8F", "K8B"} & set(want):
        kron = {side: dtp_plans(make(QM9[0])(max_edges=E, nodes_per_graph=QM9[2], seed=SEED,
                                             device=dev, kron_g=True))
                for side, (_, make) in sides.items()}
        if "K8F" in want:
            k8f_section(sides, order, kron, rows, dev, report)
        if "K8B" in want:
            k8b_section(sides, order, kron, rows, dev, report)

    if {"K6T", "K6FB", "K6R"} & set(want):
        lists = k6_lists(sides, E, mE, dev)
        if "K6T" in want:
            k6t_section(sides, order, lists, rows, dev, report)
        if "K6FB" in want:
            k6fb_section(sides, order, lists, rows, dev, report)
        if "K6R" in want:
            k6r_section(sides, order, lists, rows, dev, report)
    if "S1A" in want:
        s1a_section(sides, order, dev, report)
    if "S2" in want:
        s2_section(sides, order, dev, report)

    if {"K5a", "K5b", "K5c"} & set(want):
        mrows = {f"md17-{site}": (mE, int(mmask.sum())) for site in ("sep_act", "sep_value",
                                                                      "edge_deg")}
        mplans = {}
        for side, (_, make) in sides.items():
            md17 = make(MD17[0])(max_edges=mE, nodes_per_graph=MD17[2], seed=SEED, device=dev)
            mplans[side] = {f"md17-{k}": v for k, v in dtp_plans(md17).items()}
        if "K5a" in want:
            k5a_section(sides, order, mplans, mrows, dev, report)
        for key in ("K5b", "K5c"):
            if key in want:
                k5_section(key, sides, order, mplans, mrows, dev, report)

    text = json.dumps(report, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return report


if __name__ == "__main__":
    main()
