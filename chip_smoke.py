#!/usr/bin/env python3
"""Drive the PyTorch port's QM9 training and inference paths, its MD17
energy + force evaluation and training and its DeNS training once on one
NVIDIA GPU, on the fused DTP + linear route, the unfused DTP route, the
radial fold and (QM9) the kron-basis route, in the fixed-slot batch layout,
the QM9 step, MD17 force training and the DeNS step again in the packed
layout that the JAX models default to and the CLIs load, the CLIs'
training recipe there (remat, a binding gradient clip, checkpoints), and
the training CLIs themselves through their ``main``s.

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
   row-broadcast x), K2 on dx, dw and dW; K3 masked (the edge-degree
   scatter) and unmasked (the gathers' backward, which sums the padding
   edges on the last node); K4 with an alpha-dropout
   multiplier (the train path) and without (the eval path), on its output
   and its denominator.  Two K2 calls, and two K4 calls, on the same inputs
   must give equal bits.  Times both with CUDA events (median of 7 runs of
   10 calls), and the one PyTorch call that computes K3's function
   (``index_add_``); K3's and K4's device time per call (from a profiler
   trace: K3's one launch, K4's with the shift's) is printed beside the
   wrapper's.  Each kernel's bound is the
   larger of its bytes over 3.35 TB/s and its operations over 989 TFLOP/s
   (bf16 inputs) or 67 TFLOP/s (fp32), counted for this run's real edges;
   for the kernels whose bf16 operations run on the CUDA cores
   (CUDA_CORE_KERNELS: the FMA probe's ``__hfma2``) over 134 TFLOP/s.
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

6. md17     — ``graph_attention_transformer_nonlinear_exp_l3_md17`` at full
   width from the registry with a seeded init, ``evaluate_md17`` (energies
   and forces = -dE/dpos) on 4 batches of 8 md17-like molecules (21 atom
   slots, seed 0) in float32 and bfloat16: the launch counts of one force
   evaluation (13 K1, 13 K5a, 19 K3, no K2 or K4), energies [8] and forces
   [168, 3] finite and zero on padded slots, molecules/s (median of 3
   passes over the 4 batches), the peak memory, two evaluations bitwise
   equal, batch 0 against the same weights on the CPU plain path, and
   rotated positions giving rotated forces (float32, 1e-3 of max |F|).  The
   CPU check: float32 within 1e-3 of the largest |value|; in bfloat16 the
   card, the CPU plain path and the JAX package's own bf16 force model all
   lie ~3e-2 from the float64 values (bf16 features, and the exp basis's
   cancelling derivative; ``tests/test_torch_md17.py`` measures JAX's at
   3.3e-2 on a reduced model), so the card's distance to a float64 CPU
   evaluation must be at most MD17_BF16_FACTOR times the bfloat16 CPU plain
   path's.
7. md17 kernels — K1 and K5a (``dtp_lin_bwd3``, on K2's launch 1) at the
   exp_l3 shapes of batch 0 at the three call sites (sep_act; sep_value
   with folded shared weights; the edge-degree embedding with its
   row-broadcast x), K5a with each caller's outputs (``K5A_NEEDS``: the
   force pass's, and the training parameter pass's dx and dw), two calls
   giving equal bits, and K3 at the path's width (864 columns) in its three
   forms (the edge-degree scatter and the attention sums [E, 4, 216],
   masked; the message gathers' backward, unmasked), float32 and bfloat16,
   against their plain versions with the tolerances of phase 3, timed the
   same way, with their bounds and, for K3, ``index_add_``.

8. md17 train kernels — K5b (``dtp_lin_leg``: the x, sh and w legs on K2's
   launch 1) and K5c (``dtp_lin_legW``, K2's launch 2) at the
   three call sites at batch 0's shapes, float32 and bfloat16, against their
   plain versions with the tolerances of phase 3, timed the same way, with
   their bounds, each call's device time (a profiler trace of 20 calls)
   beside its wrapper time, two calls giving equal bits, and the legs' grid
   of (tile, irrep group) blocks (and the sh leg's resident blocks per SM).
9. md17 train — the same force model in training mode through
   ``make_md17_steps`` (``energy_weight=1``, ``force_weight=80``, AdamW with
   the no-decay mask, ``cosine_warmup_schedule(5e-4, 100, 100000)``, weight
   decay 1e-6, EMA 0.999; no dropout, so the step draws no random numbers)
   at batch 8 in float32 and bfloat16: the launch counts of one step (45 K1,
   20 K5a, 39 K5b, 45 K5c, 38 K3, no K2 or K4), finite loss, ``loss_e``,
   ``loss_f``, ``mae_e``, ``mae_f`` and gradient norm, parameters and EMA
   that moved, trained molecules/s (median over 10 steps after 3 warm-up
   steps), the peak memory, and two first steps from the same weights giving
   bitwise equal parameters.
10. md17 train vs CPU — one full-width step on MD17_CPU_MOLECULES molecules
   on the card and on the CPU plain path from the same weights: float32
   loss and gradient norm within 1e-3 relative and the updated parameters
   within 1e-3 of max |param|; bfloat16 judged as the forces of phase 6: the
   card's distance to a float64 CPU step at most MD17_BF16_FACTOR times the
   bfloat16 CPU plain path's, with a floor of 2e-2 for the two scalars (one
   number of the CPU path can land near its float64 value by chance).

10a. K7 kernels — the radial fold's K7-F (``dtp_lin_rad_fwd``; also with
   [Wr; 0], and twice for equal bits) with K7-B (``dtp_lin_rad_bwd``) at the
   QM9 sep_act and edge-degree sites and with K7-B3 (``dtp_lin_rad_bwd3``:
   every set of two or three of dx, dsh and dh, twice for equal bits, the
   three also with [Wr; 0]) at the exp_l3 sep_act and edge-degree sites,
   float32 and bfloat16, against their plain versions with the tolerances
   of phase 3, each beside the unfolded pair on the same inputs (cuBLAS
   ``h @ Wr + offset`` then K1; K2, K5a with the same outputs then cuBLAS
   for dh and d[Wr; offset]).
10b. fold — the QM9 flagship and the exp_l3 force model built with
   ``radial_fold`` (and ``radial_fold_ho``): the eval forward (7 K7-F + 6
   K1, 1 K3, 6 K4; predictions against the fused route), phase 4 (7 K7-F +
   6 K1, 7 K7-B + 6 K2; peak memory beside the fused step's), one fp32 step
   against the fused route's (ROUTE_RTOL), phase 5, and phase 6 (7 K7-F + 6
   K1, 7 K7-B3 + 6 K5a) against the fused phases' float64 references.
10c. K7 legs — the fold's leg kernels K7-L (``dtp_lin_rad_leg``: the x, sh
   and h legs, also with [Wr; 0], and twice for equal bits), K7-LW
   (``dtp_lin_rad_legW``) and K7-Wr (``dtp_lin_rad_legWr``) at the exp_l3
   sep_act and edge-degree sites of batch 0, float32 and bfloat16, against
   their plain versions with the tolerances of phase 3, timed the same way,
   each beside the unfolded pair on the same inputs (cuBLAS ``h @ Wr +
   offset`` then K5b or K5c; K5b's w leg then cuBLAS ``dw Wr^T`` or ``[h,
   1]^T dw``), with their bounds (all three run on K2's launches: K7-L K5b's
   legs with w built or dh taken on chip; K7-LW K5c's dW tiles with w
   rebuilt from h; K7-Wr K5b's w leg, then the d[Wr; offset] tiles).
10d. fold md17 train — phase 9 with ``radial_fold`` and ``radial_fold_ho``
   (18 K1 + 27 K7-F, 6 K5a + 14 K7-B3, 12 K5b + 27 K7-L, 18 K5c + 27 K7-LW,
   27 K7-Wr, 38 K3 per step; FOLD_TIMED_STEPS timed steps; peak memory
   beside the fused step's), then phase 10 on the folded route against the
   fused phase's float64 CPU step (the same seed gives the same parameters,
   so the same function).

11. K6 kernels — the unfused DTP route's kernels at the term lists of the
   QM9 flagship's three call sites (batch 0 of phase 2, E = max_edges) and
   of the exp_l3 sep_act site (batch 0 of phase 6), float32 and bfloat16:
   K6-T (``dtp_t``) on the DTP's terms and on the x and w legs'
   permutations (a broadcast x at the edge degree, a shared w at
   sep_value), K6-R (``dtp_r``) and K6-FB (``dtp_fused_bwd``), against their
   plain versions with the tolerances of phase 3, timed the same way; the
   route computes every row, so the bounds count all E rows.  K6-T, K6-R
   and K6-FB repeat their bits, K6-FB's dx and dw are K6-T's legs' bits and
   K6-R's output is K6-FB's dsh ("K6-R = K6-FB dsh"), at every site and
   dtype.
12. unfused train — the QM9 flagship built with ``fused_dtp_lin=False``:
   the launch counts of one eval forward (13 K6-T, 1 K3, 6 K4), then phase
   4 on that route (39 K6-T, 13 K3, 6 K4 per step) and with
   ``dtp_first_order_bwd=True`` (13 K6-T + 13 K6-FB); one fp32 step of each
   route from the same seed, batch and dropout masks, whose loss, gradient
   norm and updated parameters lie within ROUTE_RTOL of the fused route's;
   phase 5 on the unfused route.
13. unfused md17 — phases 6, 9 and 10 with ``fused_dtp_lin=False``: 32 K6-T
   and 13 K6-R per force evaluation, 135 K6-T and 13 K6-R per training step
   (the parameter pass runs no R), 19 / 38 K3; equivariance, bitwise
   repeats and the CPU checks as on the fused route, against the fused
   phases' float64 CPU references (the same seed gives the same parameters,
   so the same function); bf16 forces and energies are held to
   MD17_BF16_FACTOR times the larger of the bf16 CPU path's and the fused
   route's card distance to float64 (two samples of the model's bf16 noise,
   ~3e-2 of the largest value on either route).

14. K8 kernels — the kron-basis op's K8-F (``dtp_lin_kron_fwd``: K1's
   product over the kron tables on a 64-edge tile, twice for equal bits)
   and K8-B
   (``dtp_lin_kron_bwd``: dx, dw and dG on K2's two launches over the kron
   tables) at the QM9 flagship's three sites
   (batch 0 of phase 2, n_edges below E), float32 and bfloat16, against their
   plain versions with the tolerances of phase 3 (out, dx, dw, dG), timed the
   same way, each beside K1 or K2 on the same inputs (the same function on
   the fused route; no single PyTorch call computes it).  The bounds count
   the contraction with G (2 operations per G element and real edge forward,
   4 backward) and Kop's products.
15. kron — the QM9 flagship built with ``kron_g=True``: the eval forward (13
   K8-F, 1 K3, 6 K4; predictions against the fused route), phase 4 (13 K8-F,
   13 K8-B, 13 K3, 6 K4 per step; peak memory beside the fused step's), one
   fp32 step against the fused route's (ROUTE_RTOL), two first steps from one
   seed bitwise equal (dG is summed in a fixed order), phase 5, and a model
   built with ``kron_g`` and ``radial_fold`` that warns and launches no K7.

16. measurement — the port's tools and their kernels (S1-S3), which no model
   path launches (every phase above expects 0 of them).  Each tool's
   ``main`` at its default sizes, with the launch counts set to 0 just
   before and read just after (the kernels' launches): ``chip_peaks`` (the
   CUDA-core FMA probe ``fma_probe`` in fp32 and bf16, HBM streaming, the
   bf16 tensor cores, K6-T's byte floor ``dtp_t_floor``), ``kbench`` in
   bf16 and fp32 (K6-T beside ``dtp_t_floor``, the staged T
   ``dtp_t_staged`` in both layouts, K1 and the unfused composition) and
   ``bwd_attr --qm9`` (K2 cut after each phase, ``dtp_lin_bwd_stage``, on
   batch 0's QM9 geometry); the measured peaks and K2's stage times are
   printed.  Then each kernel against its plain version on the same inputs
   in float32 and bfloat16: the probe at both of the script's shapes within
   1e-5 (fp32) and 1e-2 (bf16) of max |plain|, the floor and the staged T
   at kbench's shapes (E = 40960) with phase 3's tolerances (the dense
   staged T also bitwise equal to K6-T, and timed beside K6-T on the same
   inputs), and ``dtp_lin_bwd_stage`` at the
   QM9 sep_act site: its full stage bitwise equal to ``dtp_lin_bwd``, its
   stages from the transposes on (K2's first launch whole) K2's dx and dw
   bitwise with dW = 0, the earlier stages zeros; timed as phase 3.  The
   probe also gives its first design's output (``fma_probe_first``) in
   every bit, at both shapes and in both dtypes.

17. dens train (run after phase 10, on its batches) — the aspirin L3 recipe
   (``models.dens.ASPIRIN_L3``, the model of
   ``configs/md17_dens/equiformer_dens_l3.yml``; ``ASPIRIN_L3_TRAIN``,
   ``bench.py --task dens``: e : f : dp = 1 : 80 : 5, noise std 0.05, probability
   0.25, corrupt ratio 0.25, ``cosine_warmup_schedule(2e-4, 100, 100000)``,
   weight decay 1e-6, EMA 0.999) at full width and depth from the registry
   with a seeded init, through ``make_dens_steps`` on the md17 batches (8
   molecules of 21 slots, ``max_edges`` 3456: every ordered pair (``every_pair_edges``),
   as the radius graph is rebuilt from noised positions inside the step;
   the noise drawn from a CUDA generator) in float32 and bfloat16: the
   launch counts of one step (47 K1, 21 K5a, 40 K5b, 47 K5c, 41 K3; the
   denoising head adds 2 K1 sites to the trunk's 13, whose backward runs in
   the parameter pass only), finite ``loss``, ``loss_e``, ``loss_f``,
   ``loss_dp`` and gradient norm, parameters and EMA that moved, trained
   molecules/s (median over 10 steps after 3 warm-up steps), the peak
   memory, and two first steps from one seed (weights and noise) giving
   bitwise equal metrics and parameters.
18. dens vs CPU — one full-width step of ``train_step.noised`` on
   MD17_CPU_MOLECULES molecules, its depth cut to DENS_CPU_LAYERS blocks
   (the first and the wide last), on the card and on the CPU plain path,
   from the same weights and the same noise (drawn on the CPU from a seed
   with probability 1, so that both force terms are live, then moved to the
   card), held as phase 10 holds the MD17 step: float32 within 1e-3, bfloat16
   no further from a float64 CPU step than MD17_BF16_FACTOR times the
   bfloat16 CPU path (floor 2e-2 for the two scalars).

19. packed — the QM9 flagship on the packed layout (``nodes_per_graph=0``:
   ``collate`` by the port's ``GraphLoader(data, 128, 3840)``, the [N, N]
   radius graph, the src side of the gathers' backward through the
   src-sort plan) at the QM9 CLI's capacities (3840 node rows, ``max_edges``
   65280: ``cli/train_qm9.py:58-59``) on the same molecules as phase 2: the
   radius graph's time and memory beside the fixed-slot one's, the launch
   counts of one eval forward (13 K1, 1 K3, 6 K4) and its float32
   predictions against the fixed-slot layout's from the same weights
   (within LAYOUT_PRED_RTOL of max |pred|, equal bits printed), phase 4 on
   the packed batches (13 K1, 13 K2, 13 K3, 6 K4 a step), two first steps
   from one seed bitwise equal, and phase 5 on a packed batch of 16 graphs
   (480 node rows, 17 edges a row: 8192).
20. packed md17 — the exp_l3 force model on the packed layout at the MD17
   CLI's capacities (256 node rows, ``max_edges`` 5632:
   ``cli/train_md17.py:83-84``): the launch counts of one force evaluation
   (13 K1, 13 K5a, 19 K3), its float32 energies and forces against the
   fixed-slot layout's (within LAYOUT_FORCE_RTOL of the largest, equal bits
   printed), phase 9 (45 K1, 20 K5a, 39 K5b, 45 K5c, 38 K3 a step;
   PACKED_TIMED_STEPS timed steps; two first steps bitwise equal) and phase
   10 on a packed batch of 2 molecules (42 node rows, 22 edges a row: 1024)
   against the fixed-slot phase's float64 CPU step (the same function).
21. packed dens — the aspirin L3 DeNS recipe at full width and depth on the
   packed layout (``max_edges`` 5632): the launch counts of one
   ``make_dens_steps`` step with the noise drawn on the card (47 K1, 21 K5a,
   40 K5b, 47 K5c, 41 K3), then one float32 ``train_step.noised`` of each
   layout from one seed on the same noise (drawn on the fixed-slot batch 0,
   then packed by ``collate``): metrics and updated parameters within
   ROUTE_RTOL of each other, equal bits printed.
22. recipe — the CLIs' training recipe on the packed batches of phases 19
   and 20: the QM9 flagship with ``task_mean`` / ``task_std`` set and the
   exp_l3 force model, each with ``remat=True`` (every TransBlock under
   ``torch.utils.checkpoint``, its dropout masks replayed) and a
   ``grad_clip_norm`` that binds (CLIP_SHARE of the un-rematted step's
   gradient norm; the clip factor printed), in float32 and bfloat16: one
   step against the un-rematted step from one seed (metrics and parameters
   within ROUTE_RTOL, equal bits printed, the generators in one state), the
   launch counts of a rematted step (EXPECTED_REMAT_TRAIN: 25 K1, 13 K2, 13
   K3, 12 K4; EXPECTED_REMAT_MD17_TRAIN: 69 K1, 20 K5a, 39 K5b, 45 K5c, 50
   K3), how often block_0 runs a step (the forward and its recomputes), the
   peak memory above the model and state with and without remat, and
   PACKED_TIMED_STEPS timed rematted steps.  Then checkpoints on the card:
   ``CheckpointManager`` saves the QM9 rematted fp32 state after step 2 and
   restores it into a fresh state (other weights), and step 3 on both gives
   equal bits in the metrics, parameters, Adam moments, EMA and step; the
   EMA written by ``save_params`` (JAX's npz) and read by ``load_params``
   into a CPU model predicts CPU_GRAPHS graphs within CPU_RTOL of the card's
   model loaded from the same file.

23. cli — the training CLIs through their ``main``s on the card, each with
   every launch count set to 0 just before and read just after, each
   train step's launches read too (the step maker wrapped): ``train_qm9
   --synthetic --epochs 1`` at the defaults (the flagship at full width,
   batch 128, the CLI's capacities 3840 / 65280, remat, bf16, AdamW with EMA:
   4 steps of phase 22's rematted counts, then val and test, 2 eval
   forwards of phase 2's counts), its epoch's graphs/s from its own log
   line, the three npz files, and ``final.npz`` loaded by ``load_params``
   into a CPU model, which predicts CPU_GRAPHS graphs within CPU_RTOL of
   the card; ``train_qm9`` on a copy of ``tests/fixtures/qm9_raw`` with the
   bessel entrypoint (2 steps at batch 4; the 11 molecules all fall into
   train, so no evaluation: ``--eval-interval 2``); the e3 entrypoint at
   full width (4 steps), then K1 and K2 at its odd-parity sep_act site
   against their plain versions with phase 3's tolerances; ``train_md17``
   on ``tests/fixtures/md17_raw`` with the attention head (2 force training
   steps of EXPECTED_ATTN_MD17_TRAIN, val and test), then K1, K5a, K5b and
   K5c at the head's sep_act site (512x0e in) as phases 7 and 8 check
   them; one exp_l3_e3 force training step and the same checks at its
   sep_act site; ``train_md17 --use-dens --config-yml
   configs/md17_dens/equiformer_dens_l3.yml`` (the port's YAML reader) with
   the linear decay: 2 steps of phase 21's counts, ``dp_weight`` 1.0 and
   0.5 logged per epoch; ``compute_stats`` on the MD17 fixture: the native
   ``radius_stats`` equal to numpy's ``compute_stats``.

The phases run in the order 1-10, 17-23, 10a-16.  Phases 3 and 7 also
time the model's segment sums too narrow for K3
(``fixed_order_segment_sum``, an ``index_put_`` that repeats its bits)
against ``index_add_`` at the shapes of the readout and the softmax
denominators, and print what the fixed order costs per QM9 step and per
force evaluation.

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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 128
SLOTS = 30
N_BATCHES = 4
SEED = 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CPU_RTOL = {"float32": 1e-3, "bfloat16": 2e-2}
BF16_MIN_SHIFT = 1e-4
CPU_GRAPHS = 16
WARMUP_STEPS, TIMED_STEPS = 3, 10
TPU_KERNELS = {
    "dtp_lin_fwd": "equiformer_tpu/kernels/dtp_lin_pallas.py:598",
    "dtp_lin_bwd": "equiformer_tpu/kernels/dtp_lin_pallas.py:673",
    "dtp_lin_bwd3": "equiformer_tpu/kernels/dtp_lin_ho.py:451",
    "dtp_lin_leg": "equiformer_tpu/kernels/dtp_lin_ho.py:163",
    "dtp_lin_legW": "equiformer_tpu/kernels/dtp_lin_ho.py:402",
    "dtp_lin_rad_fwd": "equiformer_tpu/kernels/dtp_lin_pallas.py:604",
    "dtp_lin_rad_bwd": "equiformer_tpu/kernels/dtp_lin_pallas.py:675",
    "dtp_lin_rad_bwd3": "equiformer_tpu/kernels/dtp_lin_ho.py:458",
    "dtp_lin_rad_leg": "equiformer_tpu/kernels/dtp_lin_ho.py:255",
    "dtp_lin_rad_legW": "equiformer_tpu/kernels/dtp_lin_ho.py:439",
    "dtp_lin_rad_legWr": "equiformer_tpu/kernels/dtp_lin_ho.py:344",
    "dtp_lin_kron_fwd": "equiformer_tpu/kernels/dtp_lin_kron.py:191",
    "dtp_lin_kron_bwd": "equiformer_tpu/kernels/dtp_lin_kron.py:231",
    "dtp_t": "equiformer_tpu/kernels/dtp_pallas.py:54",
    "dtp_r": "equiformer_tpu/kernels/dtp_pallas.py:72",
    "dtp_fused_bwd": "equiformer_tpu/kernels/dtp_pallas.py:405",
    "csr_segment_sum": "equiformer_tpu/kernels/segment_csr_pallas.py:36",
    "attn_combine": "equiformer_tpu/kernels/attn_csr_pallas.py:109",
    "fma_probe": "scripts/chip_peaks.py:62",
    "dtp_t_floor": "scripts/kbench.py:125",
    "dtp_t_staged": "scripts/kbench.py:175",
    "dtp_lin_bwd_stage": "scripts/bwd_attr.py:200",
}
SOURCES = {
    "dtp_lin_fwd": "equiformer_tpu_torch/csrc/dtp_lin.cu",
    "dtp_lin_bwd": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_lin_bwd3": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_lin_leg": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_lin_legW": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_lin_rad_fwd": "equiformer_tpu_torch/csrc/dtp_lin.cu",
    "dtp_lin_rad_bwd": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_lin_rad_bwd3": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_lin_rad_leg": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_lin_rad_legW": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_lin_rad_legWr": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_lin_kron_fwd": "equiformer_tpu_torch/csrc/dtp_lin.cu",
    "dtp_lin_kron_bwd": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
    "dtp_t": "equiformer_tpu_torch/csrc/dtp_t.cu",
    "dtp_r": "equiformer_tpu_torch/csrc/dtp_r.cu",
    "dtp_fused_bwd": "equiformer_tpu_torch/csrc/dtp_fused_bwd.cu",
    "csr_segment_sum": "equiformer_tpu_torch/csrc/segment_csr.cu",
    "attn_combine": "equiformer_tpu_torch/csrc/attn_csr.cu",
    "fma_probe": "equiformer_tpu_torch/csrc/peaks.cu",
    "dtp_t_floor": "equiformer_tpu_torch/csrc/dtp_t_variants.cu",
    "dtp_t_staged": "equiformer_tpu_torch/csrc/dtp_t_variants.cu",
    "dtp_lin_bwd_stage": "equiformer_tpu_torch/csrc/dtp_lin_bwd.cu",
}
NONE = dict.fromkeys(SOURCES, 0)
EXPECTED_EVAL = {**NONE, "dtp_lin_fwd": 13, "csr_segment_sum": 1, "attn_combine": 6}
EXPECTED_TRAIN = {**NONE, "dtp_lin_fwd": 13, "dtp_lin_bwd": 13, "csr_segment_sum": 13,
                  "attn_combine": 6}
# one force evaluation: a K1 and a K5a per fused DTP (edge degree + 2 per
# block); K3 for the edge-degree scatter and the 6 attention sums, and 12 in
# the message gathers' backward; the composed attention tail, no K4
EXPECTED_MD17 = {**NONE, "dtp_lin_fwd": 13, "dtp_lin_bwd3": 13, "csr_segment_sum": 19}
# one training step: forward 13 K1; force pass 13 K5a; parameter pass: per
# per-edge-w site (6 sep_act) the K5a node's backward is 3 K1 (out legs), 2 x
# legs + 2 w legs (K5b; the sh legs are skipped: sh depends on positions
# alone) and 3 K5c, at the edge-degree site (no dx cotangent) 2 K1, 2 x legs
# + 1 w leg, 2 K5c, per shared-weight site (6 sep_value) 2 K1, 1 x leg, 2
# K5c; then the 13 forward nodes again: K5a (dx, dw) + K5c at the 7
# per-edge-w sites, one x leg + K5c at the 6 shared ones.  K3: 7 forward, 12
# in the force pass (the message gathers' backward), and in the parameter
# pass 7 (the backward of the force pass's gathers) + 12 (the forward
# gathers' backward)
EXPECTED_MD17_TRAIN = {**NONE, "dtp_lin_fwd": 45, "dtp_lin_bwd3": 20, "dtp_lin_leg": 39,
                       "dtp_lin_legW": 45, "csr_segment_sum": 38}
# The unfused route (fused_dtp_lin=False): every DTP site (edge degree + 2
# per block) is a K6-T forward; the linear heads are cuBLAS matmuls.  A QM9
# step adds T's x and w legs at each site (the edge degree's x is its
# broadcast constant feature; QM9 positions need no gradient, so no R), or
# one K6-FB per site with dtp_first_order_bwd.  A force evaluation adds the
# w leg at the 7 per-edge-w sites, the x leg at the 12 block sites (the
# edge degree's feature is a function of the detached parameters) and an R
# per site.  A force training step: 135 T and the force pass's 13 R
# (counted on the CPU as 9 + 21 per block; the parameter pass runs no R).
# K3 and K4 as on the fused route.
UNFUSED = {"fused_dtp_lin": False}
FIRST_ORDER_BWD = {"fused_dtp_lin": False, "dtp_first_order_bwd": True}
EXPECTED_UNFUSED_EVAL = {**NONE, "dtp_t": 13, "csr_segment_sum": 1, "attn_combine": 6}
EXPECTED_UNFUSED_TRAIN = {**NONE, "dtp_t": 39, "csr_segment_sum": 13, "attn_combine": 6}
EXPECTED_FIRST_ORDER_TRAIN = {**NONE, "dtp_t": 13, "dtp_fused_bwd": 13, "csr_segment_sum": 13,
                              "attn_combine": 6}
EXPECTED_UNFUSED_MD17 = {**NONE, "dtp_t": 32, "dtp_r": 13, "csr_segment_sum": 19}
EXPECTED_UNFUSED_MD17_TRAIN = {**NONE, "dtp_t": 135, "dtp_r": 13, "csr_segment_sum": 38}
ROUTE_RTOL = 1e-3  # one fp32 step, unfused (or folded) vs fused route on the card
# The radial fold (K7): the radial MLP's final linear layer inside the fused
# op at the 7 per-edge-weight sites (6 sep_act + the edge degree); the 6
# shared-weight sep_value sites stay on K1 / K2 / K5a.  K3 and K4 as on the
# fused route.
FOLD = {"radial_fold": True}
FOLD_HO = {"radial_fold": True, "radial_fold_ho": True}
EXPECTED_FOLD_EVAL = {**NONE, "dtp_lin_fwd": 6, "dtp_lin_rad_fwd": 7, "csr_segment_sum": 1,
                      "attn_combine": 6}
EXPECTED_FOLD_TRAIN = {**NONE, "dtp_lin_fwd": 6, "dtp_lin_rad_fwd": 7, "dtp_lin_bwd": 6,
                       "dtp_lin_rad_bwd": 7, "csr_segment_sum": 13, "attn_combine": 6}
EXPECTED_FOLD_MD17 = {**NONE, "dtp_lin_fwd": 6, "dtp_lin_rad_fwd": 7, "dtp_lin_bwd3": 6,
                      "dtp_lin_rad_bwd3": 7, "csr_segment_sum": 19}
# one folded force training step (counted on the CPU with the wrappers
# patched, 2 and 3 blocks of a reduced model): what EXPECTED_MD17_TRAIN's
# per-edge-w sites launch moves to the folded kernels, site for site.  Per
# sep_act site (6) the forward's K7-F, 2 K7-B3 (force pass; parameter pass
# for x and h), 3 K7-F out legs below the K7-B3 node, 4 K7-L (2 x legs, 2 h
# legs), 4 K7-LW; the edge degree 3 K7-F, 2 K7-B3, 3 K7-L, 3 K7-LW; and a
# K7-Wr beside every K7-LW (27).  The 6 sep_value sites keep 3 K1, 1 K5a, 2
# K5b x legs and 3 K5c each.  K3 as on the fused route.
EXPECTED_FOLD_MD17_TRAIN = {**NONE, "dtp_lin_fwd": 18, "dtp_lin_rad_fwd": 27, "dtp_lin_bwd3": 6,
                            "dtp_lin_rad_bwd3": 14, "dtp_lin_leg": 12, "dtp_lin_rad_leg": 27,
                            "dtp_lin_legW": 18, "dtp_lin_rad_legW": 27, "dtp_lin_rad_legWr": 27,
                            "csr_segment_sum": 38}
FOLD_TIMED_STEPS = 5  # the folded force training phase's timed steps (3 warm-up)
# The kron route (K8): all 13 fused DTP sites of the QM9 flagship on K8-F /
# K8-B in place of K1 / K2; K3 and K4 as on the fused route.
KRON = {"kron_g": True}
EXPECTED_KRON_EVAL = {**NONE, "dtp_lin_kron_fwd": 13, "csr_segment_sum": 1, "attn_combine": 6}
EXPECTED_KRON_TRAIN = {**NONE, "dtp_lin_kron_fwd": 13, "dtp_lin_kron_bwd": 13,
                       "csr_segment_sum": 13, "attn_combine": 6}
# the outputs each caller of K5a asks for at MD17's three sites: the force
# pass first (no dw at sep_value, whose weights are shared; no dx at the edge
# degree, whose x is a constant row), then the parameter pass of training
# (dx, dw at the per-edge-w sites)
K5A_NEEDS = {"sep_act": (("x", "sh", "w"), ("x", "w")), "sep_value": (("x", "sh"),),
             "edge_deg": (("sh", "w"), ("x", "w"))}
MD17_CPU_MOLECULES = 2
BF16_SCALAR_FLOOR = 2e-2
MD17_MODEL = "graph_attention_transformer_nonlinear_exp_l3_md17"
MD17_BATCH, MD17_SLOTS = 8, 21
EQUIV_TOL = 1e-3
MD17_BF16_FACTOR = 2.0  # card / CPU distance to fp64: measured 1.1 (energies), 0.9 (forces)
# DeNS at the aspirin L3 recipe (models/dens.py ASPIRIN_L3 and
# ASPIRIN_L3_TRAIN: configs/md17_dens/equiformer_dens_l3.yml's model and
# bench.py --task dens' training settings).  One step is the MD17 step's kernels plus the
# denoising head's two DTP sites: their forward K1 and, in the parameter
# pass only (the energy does not depend on them), K5a (dx, dw) + K5c at
# sep_act, a K5b x leg + K5c at sep_value; K3 the head's attention sum and
# the backward of its two message gathers (counted on the CPU with the
# wrappers patched, 2 and 3 blocks of a reduced model whose sums take K3
# where the full width's do).
DENS_MODEL = "equiformer_md17_dens"
EXPECTED_DENS_TRAIN = {**NONE, "dtp_lin_fwd": 47, "dtp_lin_bwd3": 21, "dtp_lin_leg": 40,
                       "dtp_lin_legW": 47, "csr_segment_sum": 41}
DENS_METRICS = {"loss", "loss_e", "loss_f", "loss_dp", "grad_norm"}
DENS_CPU_LAYERS = 2  # phase 18's depth
# The packed layout (``collate``, the [N, N] radius graph, the src side of
# the gathers' backward through the src-sort plan): the JAX models' default
# and what both CLIs load, at the CLIs' capacities: node rows 30 a graph and
# 17 edges a node row for QM9 (cli/train_qm9.py:58-59: 3840 and 65280 at
# batch 128), the atoms and atoms + 1 edges a node row for MD17 and DeNS
# (cli/train_md17.py:83-84: 256 and 5632 at batch 8).  The paths launch the
# fixed-slot layout's kernels as often: the src side's sums are K3 where the
# twins' were (the message gathers, 480 or 864 columns) and narrow where
# theirs were (edge_vectors' 3 columns).
PACKED = {"nodes_per_graph": 0}
QM9_EDGES_PER_NODE = 17
LAYOUT_PRED_RTOL = 1e-5  # QM9 eval predictions, packed vs fixed-slot, fp32
LAYOUT_FORCE_RTOL = 1e-3  # MD17 energies and forces, packed vs fixed-slot, fp32
PACKED_TIMED_STEPS = 5  # the packed force training phase's timed steps (3 warm-up)
DENS_NODE_KEYS = ("force", "noise_mask", "denoising_pos_mask", "noise_vec")
# The CLIs' training recipe (phase 22): remat=True (each TransBlock's forward
# recomputed in the backward; the QM9 step's backward runs it once more:
# the blocks' 12 K1 and 6 K4; force training twice, in the force pass and in
# the parameter pass: the blocks' 12 K1 and 6 K3 twice more), task_mean /
# task_std on the model, a grad_clip_norm that binds (CLIP_SHARE of the
# un-rematted step's gradient norm), on the packed batches of phases 19-20
EXPECTED_REMAT_TRAIN = {**EXPECTED_TRAIN, "dtp_lin_fwd": 13 + 12, "attn_combine": 6 + 6}
EXPECTED_REMAT_MD17_TRAIN = {**EXPECTED_MD17_TRAIN, "dtp_lin_fwd": 45 + 24,
                             "csr_segment_sum": 38 + 12}
CLIP_SHARE = 0.5
QM9_MEAN, QM9_STD = 0.3, 1.7
# The measurement kernels (S1-S3) of the port's tools, each launched by the
# tool named; no model path launches them.  The probe's plain version rounds
# each product and sum where the kernel's FMA rounds once.
MEASURE_TOOLS = {"chip_peaks": [], "kbench": [], "kbench-fp32": ["--fp32"],
                 "bwd_attr": ["--qm9"]}
MEASURE_KERNELS = {"fma_probe": "chip_peaks", "dtp_t_floor": "kbench",
                   "dtp_t_staged": "kbench", "dtp_lin_bwd_stage": "bwd_attr"}
FMA_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
FMA_GRID, KBENCH_EDGES = 64, 40960  # the tools' default sizes
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# The CUDA cores' rates (NVIDIA H100 Tensor Core GPU Architecture whitepaper,
# SXM5, non-tensor: 66.9 TFLOP/s fp32, 133.8 bf16: __hfma2 does two bf16
# FMAs where fmaf does one fp32 FMA), for the kernels whose bf16 operations
# run there and not on the tensor cores: S2's bf16 path.
CUDA_CORE_FLOPS = {"float32": 67e12, "bfloat16": 134e12}
CUDA_CORE_KERNELS = ("fma_probe",)


CARD = ""  # the card's name and power limit, set by card_line(), printed beside the numbers


def card_line() -> str:
    global CARD
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    CARD = out.stdout.strip().splitlines()[0]
    return CARD


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


def bound(nbytes: float, flops: float, dt_name: str, kernel: str = "") -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take;
    the operations at the CUDA cores' rate for CUDA_CORE_KERNELS, else at
    PEAK_FLOPS."""
    peak = CUDA_CORE_FLOPS if kernel in CUDA_CORE_KERNELS else PEAK_FLOPS
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak[dt_name] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def dtp_work(plan) -> tuple:
    """(TP term elements, z @ W multiply-adds) per real edge of one call."""
    return (sum(t.mul for t, _ in plan.terms),
            sum(g.ir.dim * g.fan * g.cols for g in plan.groups))


def record(records, kernel, site, dt_name, shape, errs, ms, plain_ms, nbytes, flops,
           library_ms=None, pair_ms=None, pair="unfolded pair", tol=None):
    """``pair_ms``: the time of the same function on another route and the
    same inputs, named ``pair``: for a radial-folded kernel the unfolded
    route's kernel and cuBLAS calls, for a kron kernel K1 or K2.  ``tol``:
    the bound on the error relative to max |plain| (TOL by default)."""
    err = max(e for e, _ in errs)
    rel = max(r for _, r in errs)
    b_ms, b_by = bound(nbytes, flops, dt_name, kernel)
    records.append(dict(kernel=kernel, site=site, dtype=dt_name, shape=shape,
                        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, pair_ms=pair_ms,
                        pair=pair, tol=TOL[dt_name] if tol is None else tol))


def report_kernels(records):
    """Print each comparison; fail if a kernel disagrees with its plain version."""
    failed = [r for r in records if not r["rel_err"] <= r["tol"]]
    for r in records:
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        if r["pair_ms"] is not None:
            lib += f", {r['pair']} {r['pair_ms']:.4f} ms"
        print(f"{CARD}: kernel {r['kernel']:16s} {r['site']:17s} {r['dtype']:8s} {r['shape']}: "
              f"max_abs_err {r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}) "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms{lib}; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: {failed}")


def device_line(torch, kernel, site, dt_name, ms, call, lib_ms=None, lib_call=None):
    """Print a kernel's device time per call (its launches, from a profiler
    trace of 20 calls) beside its wrapper's time, and, where there is one
    (K3's ``index_add_``, zeros + add), the library call's in both
    regimes."""
    from equiformer_tpu_torch.utils.profiling import kernel_ms

    def device(fn, tag):
        per_kernel = kernel_ms(fn, 20, ROOT / "build" / "profile" / f"smoke_{tag}.json")
        return sum(t for t, _ in per_kernel.values()), sum(n for _, n in per_kernel.values())

    dev_ms, launches = device(call, f"{kernel}_{site}_{dt_name}")
    lib = ""
    if lib_call is not None:
        lib_dev_ms, _ = device(lib_call, f"{kernel}_{site}_{dt_name}_library")
        lib = f"; index_add_ {lib_ms:.4f} ms, device {lib_dev_ms:.4f} ms"
    print(f"{kernel} {site} {dt_name}: wrapper {ms:.4f} ms, device {dev_ms:.4f} ms in "
          f"{launches:g} launch(es) a call{lib}", flush=True)


def dtp_sites(model):
    """The fused DTP's call sites in block 0 and the edge-degree embedding:
    name -> (plan, head modules, row-broadcast x)."""
    ga = model.block_0.ga
    return {
        "sep_act": (ga.sep_act.plan, [ga.sep_act.lin, ga.sep_alpha], False),
        "sep_value": (ga.sep_value.plan, [ga.sep_value.lin], False),
        "edge_deg": (model.edge_deg_embed.plan, [model.edge_deg_embed.proj], True),
    }


def batch_geometry(model, batch):
    """(edges, float32 SH, n_edges device scalar, its value) of a batch."""
    from equiformer_tpu_torch.core.spherical import spherical_harmonics_for_irreps
    from equiformer_tpu_torch.graph.radius_graph import build_edges, edge_vectors
    from equiformer_tpu_torch.graph.segment import active_edge_bound

    edges = build_edges(batch.pos, batch.batch, batch.node_mask, batch.graph_mask.shape[0],
                        model.max_radius, model.max_edges, model.nodes_per_graph)
    vec, _ = edge_vectors(batch.pos, edges)
    n_edges = active_edge_bound(edges.mask)
    return edges, spherical_harmonics_for_irreps(model.irreps_sh, vec), n_edges, int(n_edges)


def dtp_operands(torch, plan, heads, broadcast_x, E, n, dt, g, dev):
    """Random operands of one call site in ``dt``: (x, w or None, the packed
    W with a shared w folded in as dtp_lin does, a cotangent, the bytes of
    the inputs over the n real edges)."""
    if broadcast_x:
        x = torch.randn(1, plan.d_x, generator=g, device=dev).to(dt).expand(E, plan.d_x)
    else:
        x = torch.randn(E, plan.d_x, generator=g, device=dev).to(dt)
    W = plan.pack_weights([[None if t is None else t.detach().to(dt)
                            for t in h.weight_list()] for h in heads])
    if plan.shared_weights:
        W = plan.fold_shared(torch.randn(plan.d_w, generator=g, device=dev).to(dt), W)
        w = None
    else:
        w = torch.randn(E, plan.d_w, generator=g, device=dev).to(dt)
    cot = torch.randn(E, plan.d_out, generator=g, device=dev).to(dt)
    size = torch.finfo(dt).bits // 8
    in_bytes = size * ((plan.d_x if broadcast_x else n * plan.d_x) + n * plan.d_sh
                       + (0 if w is None else n * plan.d_w) + plan.w_numel)
    return x, w, W, cot, in_bytes


def kernel_phase(torch, model, batch, dev, records, sites=None, prefix="", dtp_only=False):
    """Each kernel against its plain version at the flagship's shapes.
    ``sites`` (name -> site, ``dtp_sites``' by default) picks the DTP call
    sites, their records named ``prefix + name``; ``dtp_only`` checks K1 and
    K2 there and nothing else."""
    from equiformer_tpu_torch.kernels import (
        KERNEL_WRAPPERS, attn_combine_fwd, attn_combine_plain, attn_den_plain,
        csr_segment_sum, dtp_lin_bwd, dtp_lin_bwd_plain, dtp_lin_fwd, dtp_lin_plain,
        segment_sum_plain,
    )

    saved = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    g = torch.Generator(device=dev).manual_seed(SEED)
    N = batch.pos.shape[0]
    edges, sh32, n_edges, n = batch_geometry(model, batch)
    n_real = int(edges.mask.sum())
    E = edges.dst.shape[0]

    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        size = torch.finfo(dt).bits // 8
        sh = sh32.to(dt)
        for site, (plan, heads, broadcast_x) in (sites or dtp_sites(model)).items():
            site = prefix + site
            x, w, W, cot, in_bytes = dtp_operands(torch, plan, heads, broadcast_x, E, n, dt, g,
                                                  dev)
            shape = f"E={E} d_x={plan.d_x} d_w={plan.d_w} d_out={plan.d_out}"
            tp_elems, macs = dtp_work(plan)

            k = dtp_lin_fwd(plan, x, sh, w, W, n_edges)
            p = dtp_lin_plain(plan, x, sh, w, W, n_edges)
            torch.cuda.synchronize()
            errs = [rel_err(k, p)]
            ms = cuda_time_ms(lambda: dtp_lin_fwd(plan, x, sh, w, W, n_edges), torch)
            plain_ms = cuda_time_ms(lambda: dtp_lin_plain(plan, x, sh, w, W, n_edges), torch)
            record(records, "dtp_lin_fwd", site, dt_name, shape, errs, ms, plain_ms,
                   in_bytes + size * E * plan.d_out, n * (2 * macs + 4 * tp_elems))

            k = dtp_lin_bwd(plan, x, sh, w, W, cot, n_edges)
            p = dtp_lin_bwd_plain(plan, x, sh, w, W, cot, n_edges)
            again = dtp_lin_bwd(plan, x, sh, w, W, cot, n_edges)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(k, again) if a is not None)
            print(f"dtp_lin_bwd {site} {dt_name}: two calls bitwise equal (dx, dw, dW): {same}",
                  flush=True)
            if not same:
                raise RuntimeError(f"dtp_lin_bwd {site} {dt_name} does not repeat its bits")
            errs = [rel_err(a, b) for a, b in zip(k, p) if a is not None]
            ms = cuda_time_ms(lambda: dtp_lin_bwd(plan, x, sh, w, W, cot, n_edges), torch)
            plain_ms = cuda_time_ms(
                lambda: dtp_lin_bwd_plain(plan, x, sh, w, W, cot, n_edges), torch, reps=3, inner=3)
            out_bytes = size * E * (plan.d_x + (0 if w is None else plan.d_w)) + 4 * plan.w_numel
            record(records, "dtp_lin_bwd", site, dt_name, shape, errs, ms, plain_ms,
                   in_bytes + size * n * plan.d_out + out_bytes,
                   n * (4 * macs + 10 * tp_elems))
        if dtp_only:
            continue

        C = 480
        val = torch.randn(E, C, generator=g, device=dev).to(dt)
        k = csr_segment_sum(val, edges.dst, N, edges.mask)
        p = segment_sum_plain(val, edges.dst, N, edges.mask)
        torch.cuda.synchronize()
        errs = [rel_err(k, p)]
        ms = cuda_time_ms(lambda: csr_segment_sum(val, edges.dst, N, edges.mask), torch)
        plain_ms = cuda_time_ms(lambda: segment_sum_plain(val, edges.dst, N, edges.mask), torch)
        val_m = torch.where(edges.mask[:, None], val, torch.zeros_like(val))
        lib = lambda: torch.zeros(N, C, dtype=dt, device=dev).index_add_(0, edges.dst, val_m)  # noqa: E731
        lib_ms = cuda_time_ms(lib, torch)
        record(records, "csr_segment_sum", "edge_deg", dt_name, f"E={E} C={C} N={N}", errs, ms,
               plain_ms, size * (n_real * C + N * C) + E + 8 * E, n_real * C, lib_ms)
        device_line(torch, "K3", "edge_deg", dt_name, ms,
                    lambda: csr_segment_sum(val, edges.dst, N, edges.mask), lib_ms, lib)
        # the gathers' backward: unmasked, so the padding edges on the last node are summed
        k = csr_segment_sum(val, edges.dst, N)
        p = segment_sum_plain(val, edges.dst, N)
        torch.cuda.synchronize()
        ms = cuda_time_ms(lambda: csr_segment_sum(val, edges.dst, N), torch)
        plain_ms = cuda_time_ms(lambda: segment_sum_plain(val, edges.dst, N), torch)
        lib = lambda: torch.zeros(N, C, dtype=dt, device=dev).index_add_(0, edges.dst, val)  # noqa: E731
        lib_ms = cuda_time_ms(lib, torch)
        record(records, "csr_segment_sum", "gather", dt_name, f"E={E} C={C} N={N}", [rel_err(k, p)],
               ms, plain_ms, size * (E * C + N * C) + 8 * E, E * C, lib_ms)
        device_line(torch, "K3", "gather", dt_name, ms,
                    lambda: csr_segment_sum(val, edges.dst, N), lib_ms, lib)

        H, D = 4, 120
        scores = torch.randn(E, H, generator=g, device=dev).to(dt)
        value = torch.randn(E, H, D, generator=g, device=dev).to(dt)
        keep = torch.rand(E, H, generator=g, device=dev) < 0.8
        drop = keep.to(dt) / 0.8
        masked = torch.where(edges.mask[:, None], scores, torch.full_like(scores, -1e30))
        p_den = attn_den_plain(masked, edges.dst, N)
        # the train path's call (the alpha-dropout multiplier), then the eval
        # path's (none); the kernel reads the live edges' scores, multipliers
        # and values, the mask and dst
        for site, dm in (("ga", drop), ("ga-nodrop", None)):
            call = lambda: attn_combine_fwd(masked, value, edges.dst, N, edges.mask, dm)  # noqa: E731
            k_out, k_den = call()
            again = call()
            p_out = attn_combine_plain(scores, value, edges.dst, N, edges.mask, dm)
            torch.cuda.synchronize()
            if not (torch.equal(k_out, again[0]) and torch.equal(k_den, again[1])):
                raise RuntimeError(f"attn_combine {site} {dt_name} does not repeat its bits")
            errs = [rel_err(k_out, p_out), rel_err(k_den, p_den)]
            ms = cuda_time_ms(call, torch)
            plain_ms = cuda_time_ms(lambda: (
                attn_combine_plain(scores, value, edges.dst, N, edges.mask, dm),
                attn_den_plain(masked, edges.dst, N)), torch)
            per_edge = (2 if dm is not None else 1) * H + H * D
            record(records, "attn_combine", site, dt_name, f"E={E} H={H} D={D} N={N}", errs, ms,
                   plain_ms, size * (n_real * per_edge + N * H * D) + 4 * N * H + 9 * E,
                   n_real * H * ((3 if dm is not None else 2) * D + 2))
            device_line(torch, "K4", site, dt_name, ms, call)
    for name, fn in KERNEL_WRAPPERS.items():  # comparison launches do not count
        fn.launches = saved[name]
    report_kernels(records)
    if dtp_only:
        return
    # the step's one narrow sum: the readout [N, 1] by graph
    readout = torch.randn(N, 1, generator=g, device=dev)
    narrow_sums(torch, "QM9 step", {"qm9-readout": (
        readout, batch.batch, batch.graph_mask.shape[0], batch.node_mask, 1)})


def counted(torch, fn):
    """Run ``fn`` with every launch count set to 0 just before; returns
    (its result, the counts just after)."""
    from equiformer_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def max_edges_for(batches, graphs):
    """The real edge count of each fixed-slot batch, and the largest rounded
    up to 128."""
    from equiformer_tpu_torch.graph.radius_graph import radius_graph_dense

    counts = [int(radius_graph_dense(b.pos, b.node_mask, graphs, 5.0, graphs * SLOTS * SLOTS)
                  .mask.sum()) for b in batches]
    return counts, -(-max(counts) // 128) * 128


def with_route(route, **kw):
    """Model keywords: ``kw`` with ``route``'s switches, the layout among
    them, over it."""
    return {**kw, **(route or {})}


def cpu_batch(data, slots, route, edges_per_node, with_forces=False):
    """One CPU batch of all of ``data`` in ``route``'s layout and its
    ``max_edges``: packed into ``slots`` node rows a graph with the CLIs'
    ``edges_per_node`` edges a row (the node rows not rounded up to 128,
    which would triple the CPU step's edges at 2 molecules), or fixed-slot
    with the real edge count rounded up to 128."""
    from equiformer_tpu_torch.data import GraphLoader

    if (route or {}).get("nodes_per_graph") == 0:
        nodes = len(data) * slots
        return next(iter(GraphLoader(data, len(data), nodes, shuffle=False,
                                     with_forces=with_forces))), \
            -(-nodes * edges_per_node // 128) * 128
    batch = next(iter(GraphLoader(data, len(data), dense_slots=slots, shuffle=False,
                                  with_forces=with_forces)))
    return batch, max_edges_for([batch], len(data))[1]


def train_setup(pt, model):
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000), weight_decay=5e-3)
    train_step, _ = pt.make_qm9_steps(model, opt, 0.0, 1.0, "l1", ema_decay=0.999)
    return train_step, pt.TrainState.create(model, opt)


def train_phase(pt, torch, make, max_edges, gpu_batches, dev, out, tag="train",
                expected=EXPECTED_TRAIN, route=None):
    """Full-width training steps at batch 128 in bf16 and fp32 on the card;
    ``route`` holds the DTP switches the model is built with."""
    for name in ("bfloat16", "float32"):
        model = make(**with_route(route, max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED,
                                  compute_dtype=None if name == "float32" else name))
        step, state = train_setup(pt, model)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        (state, metrics), launches = counted(torch, lambda: step(state, gpu_batches[0], gen))
        print(f"{tag} {name}: launches in one step: {launches}")
        if launches != expected:
            raise RuntimeError(f"launch counts {launches} != expected {expected}")
        out[f"{tag}_launches"] = launches
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
        out[f"{tag}_{name}_peak_mib"] = peak
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(v == v and abs(v) < float("inf") for v in vals.values()):
            raise RuntimeError(f"{name}: non-finite training metrics {vals}")
        moved = max(float((p.detach() - before[n]).abs().max())
                    for n, p in model.named_parameters())
        ema_moved = max(float((state.ema[n] - before[n]).abs().max()) for n in before)
        if not (moved > 0 and ema_moved > 0) or state.step != WARMUP_STEPS + TIMED_STEPS:
            raise RuntimeError(f"{name}: parameters or EMA did not move ({moved}, {ema_moved})")
        gps = BATCH / statistics.median(times)
        out[f"{tag}_{name}"] = gps
        print(f"{tag} {name}: {gps:.1f} graphs/s at batch {BATCH} (median of {TIMED_STEPS} "
              f"steps after {WARMUP_STEPS} warm-up; step seconds "
              f"{[round(t, 4) for t in times]}), peak memory {peak:.0f} MiB, last step "
              f"loss {vals['loss']:.4f} mae {vals['mae']:.4f} grad_norm {vals['grad_norm']:.4f}, "
              f"max parameter move {moved:.3e}", flush=True)
        del model, state


def train_vs_cpu(pt, torch, make, data, dev, tag="train", route=None):
    """One full-width training step of CPU_GRAPHS graphs on the card and on the
    CPU plain path, same weights and same injected dropout masks; the batch
    in ``route``'s layout."""
    batch, max_edges = cpu_batch(data[:CPU_GRAPHS], SLOTS, route, QM9_EDGES_PER_NODE)
    mask_gen = torch.Generator().manual_seed(SEED + 1)
    keep = None
    for name in ("float32", "bfloat16"):
        results = []
        for d in (dev, "cpu"):
            model = make(**with_route(route, max_edges=max_edges, nodes_per_graph=SLOTS,
                                      seed=SEED, device=d,
                                      compute_dtype=None if name == "float32" else name))
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
        print(f"{tag} {name} card vs CPU plain path ({CPU_GRAPHS} graphs, max_edges "
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


def narrow_sums(torch, unit, cases):
    """The model's segment sums too narrow for K3 (``fixed_order_segment_sum``:
    ``index_put_`` on the card) against ``index_add_`` (``segment_sum_plain``)
    on the same inputs: within TOL, the same bits in two calls, and what the
    fixed order costs per ``unit``.  ``cases``: site -> (val, ids, rows,
    mask, calls per unit)."""
    from equiformer_tpu_torch.graph.segment import fixed_order_segment_sum
    from equiformer_tpu_torch.kernels import segment_sum_plain

    for site, (val, ids, rows, mask, calls) in cases.items():
        a = fixed_order_segment_sum(val, ids, rows, mask)
        again = fixed_order_segment_sum(val, ids, rows, mask)
        err = rel_err(a, segment_sum_plain(val, ids, rows, mask))[1]
        ms = cuda_time_ms(lambda: fixed_order_segment_sum(val, ids, rows, mask), torch)
        add_ms = cuda_time_ms(lambda: segment_sum_plain(val, ids, rows, mask), torch)
        print(f"narrow sum {site} {tuple(val.shape)} {str(val.dtype)[6:]} -> {rows} rows: "
              f"fixed order {ms:.4f} ms vs index_add_ {add_ms:.4f} ms (rel {err:.1e}); "
              f"{calls} per {unit}: {calls * (ms - add_ms):+.4f} ms per {unit}", flush=True)
        if not (torch.equal(a, again) and err <= TOL[str(val.dtype)[6:]]):
            raise RuntimeError(f"the fixed-order narrow sum {site} disagrees or repeats no bits")


def md17_kernel_phase(torch, model, batch, dev, records, sites=None, prefix="md17-",
                      dtp_only=False):
    """K1 and K5a against their plain versions at the exp_l3 shapes of one
    batch of 8 md17-like molecules, at the three call sites; K3 at the
    path's width in its edge-degree, attention and gather-backward forms;
    the narrow sums.  ``sites``, ``prefix`` and ``dtp_only`` as in
    ``kernel_phase`` (K1 and K5a alone)."""
    from equiformer_tpu_torch.kernels import (
        KERNEL_WRAPPERS, csr_segment_sum, dtp_lin_bwd3, dtp_lin_bwd3_plain, dtp_lin_fwd,
        dtp_lin_plain, segment_sum_plain,
    )
    from equiformer_tpu_torch.kernels.dtp_lin_ho import bwd3_occupancy

    saved = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    edges, sh32, n_edges, n = batch_geometry(model, batch)
    E, N = edges.dst.shape[0], batch.pos.shape[0]
    n_real = int(edges.mask.sum())
    C = model.edge_deg_embed.plan.d_out  # the node width, which every K3 call of the path sums
    H = model.block_0.ga.num_heads
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        size = torch.finfo(dt).bits // 8
        sh = sh32.to(dt)
        for site, (plan, heads, broadcast_x) in (sites or dtp_sites(model)).items():
            x, w, W, cot, in_bytes = dtp_operands(torch, plan, heads, broadcast_x, E, n, dt, g,
                                                  dev)
            shape = f"E={E} d_x={plan.d_x} d_w={plan.d_w} d_out={plan.d_out}"
            tp_elems, macs = dtp_work(plan)

            k = dtp_lin_fwd(plan, x, sh, w, W, n_edges)
            p = dtp_lin_plain(plan, x, sh, w, W, n_edges)
            torch.cuda.synchronize()
            ms = cuda_time_ms(lambda: dtp_lin_fwd(plan, x, sh, w, W, n_edges), torch)
            plain_ms = cuda_time_ms(lambda: dtp_lin_plain(plan, x, sh, w, W, n_edges), torch)
            record(records, "dtp_lin_fwd", prefix + site, dt_name, shape, [rel_err(k, p)], ms,
                   plain_ms, in_bytes + size * E * plan.d_out, n * (2 * macs + 4 * tp_elems))

            plain = lambda: dtp_lin_bwd3_plain(plan, x, sh, w, W, cot, n_edges)  # noqa: E731
            p = dict(zip(("x", "sh", "w"), plain()))
            plain_ms = cuda_time_ms(plain, torch, reps=3, inner=3)
            widths = {"x": plan.d_x, "sh": plan.d_sh, "w": plan.d_w}
            for need in K5A_NEEDS[site]:
                flags = {f"need_d{key}": key in need for key in widths}
                call = lambda flags=flags: dtp_lin_bwd3(  # noqa: E731
                    plan, x, sh, w, W, cot, n_edges, **flags)
                k, again = dict(zip(widths, call())), call()
                torch.cuda.synchronize()
                if sorted(key for key, v in k.items() if v is not None) != sorted(need):
                    raise RuntimeError(f"K5a at {site} returned other outputs than {need}")
                if not all(torch.equal(k[key], b) for key, b in zip(widths, again)
                           if key in need):
                    raise RuntimeError(f"K5a at {site} {dt_name} {need} repeats no bits")
                errs = [rel_err(k[key], p[key]) for key in need]
                ms = cuda_time_ms(call, torch)
                # dz product, then 3 operations per term element for each output
                record(records, "dtp_lin_bwd3",
                       f"{prefix}{site}" + ("" if need == K5A_NEEDS[site][0] else
                                         "-" + "".join("d" + key for key in need)),
                       dt_name, shape, errs, ms, plain_ms,
                       in_bytes + size * n * plan.d_out
                       + size * E * sum(widths[key] for key in need),
                       n * (2 * macs + 3 * len(need) * tp_elems))
                occ = bwd3_occupancy(plan, dt, "x" in need, "w" in need, need_dsh="sh" in need,
                                     x_rows=not broadcast_x)
                print(f"dtp_lin_bwd3 {site} {dt_name} {'/'.join(need)}: {occ} resident blocks "
                      f"per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
                      f"{-(-E // 16)} tiles x {len(plan.groups)} irrep groups")
        if dtp_only:
            continue

        # K3: the edge-degree scatter [E, C] and the attention sums [E, H, D]
        # (reshaped to [E, H*D] as segment_sum does), masked; the gathers'
        # backward, unmasked
        for site, shape, mask in (("md17-edge_deg", (E, C), edges.mask),
                                  ("md17-attn", (E, H, C // H), edges.mask),
                                  ("md17-gather", (E, C), None)):
            val = torch.randn(*shape, generator=g, device=dev).to(dt)
            flat = val.reshape(E, -1)
            k = csr_segment_sum(flat, edges.dst, N, mask)
            p = segment_sum_plain(val, edges.dst, N, mask).reshape(N, -1)
            torch.cuda.synchronize()
            ms = cuda_time_ms(lambda: csr_segment_sum(flat, edges.dst, N, mask), torch)
            plain_ms = cuda_time_ms(lambda: segment_sum_plain(val, edges.dst, N, mask), torch)
            val_m = flat if mask is None else torch.where(mask[:, None], flat,
                                                          torch.zeros_like(flat))
            lib = lambda: torch.zeros(N, C, dtype=dt, device=dev).index_add_(  # noqa: E731
                0, edges.dst, val_m)
            lib_ms = cuda_time_ms(lib, torch)
            rows = E if mask is None else n_real
            record(records, "csr_segment_sum", site, dt_name,
                   f"E={E} C={'x'.join(map(str, shape[1:]))} N={N}", [rel_err(k, p)], ms,
                   plain_ms, size * (rows * C + N * C) + (0 if mask is None else E) + 8 * E,
                   rows * C, lib_ms)
            device_line(torch, "K3", site, dt_name, ms,
                        lambda: csr_segment_sum(flat, edges.dst, N, mask), lib_ms, lib)
    for name, fn in KERNEL_WRAPPERS.items():  # comparison launches do not count
        fn.launches = saved[name]
    if dtp_only:
        return

    # the readout [N, 1] by graph (position dtype) and the 6 softmax
    # denominators [E, H] (feature dtype) of one force evaluation
    G = batch.graph_mask.shape[0]
    readout = torch.randn(N, 1, generator=g, device=dev)
    cases = {"md17-readout": (readout, batch.batch, G, batch.node_mask, 1)}
    for dt_name in ("float32", "bfloat16"):
        ex = torch.rand(E, H, generator=g, device=dev).to(getattr(torch, dt_name))
        cases[f"md17-softmax-den-{dt_name}"] = (ex, edges.dst, N, None, 6)
    narrow_sums(torch, "force evaluation", cases)


def md17_phase(pt, torch, dev, out, tag="md17", expected=EXPECTED_MD17, route=None, ref=None):
    """Energies and forces of the exp_l3 force model on the card: launch
    counts, rates, memory, determinism, the CPU plain path and equivariance.
    ``route`` holds the DTP switches.  ``ref``, from an earlier call on
    another route with the same seed (the same parameters, so the same
    function), gives the float64 CPU evaluation of batch 0 and that route's
    bf16 card distances to it: another bf16 sample of the function's
    rounding noise, so bf16 is held to MD17_BF16_FACTOR times the larger of
    the two samples' distances.  Returns the float32 model, the card
    batches, max_edges and this call's ``ref``."""
    import dataclasses

    import numpy as np

    from equiformer_tpu_torch.core.rotations import random_rotation
    from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset

    data = md17_like_dataset(MD17_BATCH * N_BATCHES, num_atoms=MD17_SLOTS, seed=SEED)
    batches = list(GraphLoader(data, MD17_BATCH, dense_slots=MD17_SLOTS, shuffle=False,
                               with_forces=True))
    counts, max_edges = max_edges_for(batches, MD17_BATCH)
    print(f"md17: {N_BATCHES} x {MD17_BATCH} molecules of {MD17_SLOTS} atoms, real edges "
          f"{counts}, max_edges {max_edges}")
    gpu_batches = [b.to(dev) for b in batches]
    route = route or {}
    entry = pt.model_entrypoint(MD17_MODEL)  # on the card
    make = lambda **kw: entry(**kw, **route)  # noqa: E731
    models = {name: make(max_edges=max_edges, nodes_per_graph=MD17_SLOTS, seed=SEED,
                         compute_dtype=None if name == "float32" else name)
              for name in ("float32", "bfloat16")}
    _, launches = counted(torch, lambda: pt.evaluate_md17(models["bfloat16"], gpu_batches[0]))
    print(f"{tag}: launches in one force evaluation: {launches}")
    if launches != expected:
        raise RuntimeError(f"launch counts {launches} != expected {expected}")
    out[f"{tag}_launches"] = launches
    n_nodes = MD17_BATCH * MD17_SLOTS
    results0 = {}
    for name, model in models.items():
        first = pt.evaluate_md17(model, gpu_batches[0])  # warm-up
        again = pt.evaluate_md17(model, gpu_batches[0])
        torch.cuda.synchronize()
        same = all(torch.equal(first[k], again[k]) for k in ("energy", "forces"))
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            results = [pt.evaluate_md17(model, b) for b in gpu_batches]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        out[f"{tag}_{name}_peak_mib"] = peak
        for b, r in zip(gpu_batches, results):
            e, f = r["energy"], r["forces"]
            if e.shape != (MD17_BATCH,) or f.shape != (n_nodes, 3) or not (
                    bool(e.isfinite().all()) and bool(f.isfinite().all())):
                raise RuntimeError(f"{name}: bad energies or forces {e.shape} {f.shape}")
            if bool((f[~b.node_mask] != 0).any()) or not bool(r["mae_f_sum"].isfinite()):
                raise RuntimeError(f"{name}: forces on padded slots or bad MAE sums")
        if not same:
            raise RuntimeError(f"{name}: two force evaluations of one batch differ in their bits")
        mps = MD17_BATCH * len(gpu_batches) / statistics.median(times)
        out[f"{tag}_{name}"] = mps
        results0[name] = {k: results[0][k].float().cpu() for k in ("energy", "forces")}
        print(f"{tag} eval {name}: {mps:.1f} molecules/s at batch {MD17_BATCH} (median of 3 "
              f"passes over {len(gpu_batches)} batches; pass seconds "
              f"{[round(t, 4) for t in times]}), peak memory {peak:.0f} MiB, two evaluations "
              f"bitwise equal", flush=True)

    if ref is None:
        model64 = make(max_edges=max_edges, nodes_per_graph=MD17_SLOTS, seed=SEED,
                       device="cpu").double()
        model64.load_state_dict({k: v.cpu() for k, v in models["float32"].state_dict().items()})
        ref = (pt.evaluate_md17(model64, batches[0].to(dtype=torch.float64)), {})
        del model64
    ref64, peer = ref
    bf16_dist = {}
    for name, model in models.items():
        cpu_model = make(max_edges=max_edges, nodes_per_graph=MD17_SLOTS, seed=SEED, device="cpu",
                         compute_dtype=None if name == "float32" else name)
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        t = time.perf_counter()
        ref = pt.evaluate_md17(cpu_model, batches[0])
        cpu_s = time.perf_counter() - t
        ok = True
        for k in ("energy", "forces"):
            card, cpu, f64 = results0[name][k], ref[k], ref64[k]
            vs_cpu, card64, cpu64 = (rel_err(a, b)[1] for a, b in
                                     ((card, cpu), (card, f64), (cpu, f64)))
            if name == "float32":
                ok &= vs_cpu <= CPU_RTOL[name]
                rule = f"bound {CPU_RTOL[name]:.0e}"
            else:
                bf16_dist[k] = card64
                ok &= card64 <= MD17_BF16_FACTOR * max(cpu64, peer.get(k, 0.0))
                rule = f"card vs float64 bound {MD17_BF16_FACTOR} x CPU vs float64"
                if k in peer:
                    rule += f" or x the other route's card vs float64, {peer[k]:.3e}"
            print(f"{tag} {name} {k}: card vs CPU plain path {vs_cpu:.3e} of the largest "
                  f"|value|; vs float64 card {card64:.3e}, CPU {cpu64:.3e} ({rule}; CPU "
                  f"force evaluation {cpu_s:.1f} s)", flush=True)
        if not ok:
            raise RuntimeError(f"{name} energies or forces on the card disagree with the CPU")

    R = torch.from_numpy(random_rotation(np.random.default_rng(SEED)))
    b0 = gpu_batches[0]
    rotated = dataclasses.replace(b0, pos=b0.pos @ R.T.to(dev, b0.pos.dtype))
    fr = pt.evaluate_md17(models["float32"], rotated)["forces"].float().cpu()
    f0 = results0["float32"]["forces"]
    rel = float((fr - f0 @ R.T.float()).abs().max()) / float(f0.abs().max())
    print(f"{tag} float32 equivariance on the card: |F(R x) - R F(x)| {rel:.3e} of max |F| "
          f"(bound {EQUIV_TOL:.0e})", flush=True)
    if not rel <= EQUIV_TOL:
        raise RuntimeError("forces on the card are not equivariant")
    model32 = models["float32"]
    del models
    return model32, gpu_batches, max_edges, (ref64, bf16_dist)


def md17_train_setup(pt, model):
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000), weight_decay=1e-6)
    train_step, _ = pt.make_md17_steps(model, opt, energy_weight=1.0, force_weight=80.0,
                                       ema_decay=0.999)
    return train_step, pt.TrainState.create(model, opt)


def md17_train_phase(pt, torch, max_edges, gpu_batches, dev, out, tag="md17_train",
                     expected=EXPECTED_MD17_TRAIN, route=None, timed=TIMED_STEPS):
    """Full-width force training steps at batch 8 in fp32 and bf16 on the
    card (``timed`` of them timed, after WARMUP_STEPS); ``route`` holds the
    DTP switches."""
    make = pt.model_entrypoint(MD17_MODEL)  # on the card
    for name in ("float32", "bfloat16"):
        kw = with_route(route, max_edges=max_edges, nodes_per_graph=MD17_SLOTS, seed=SEED,
                        compute_dtype=None if name == "float32" else name)
        model = make(**kw)
        step, state = md17_train_setup(pt, model)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        (state, metrics), launches = counted(torch, lambda: step(state, gpu_batches[0]))
        print(f"{tag} {name}: launches in one step: {launches}")
        if launches != expected:
            raise RuntimeError(f"launch counts {launches} != expected {expected}")
        out[f"{tag}_launches"] = launches
        # a second model from the same seed takes the same first step
        twin = make(**kw)
        twin_step, twin_state = md17_train_setup(pt, twin)
        twin_step(twin_state, gpu_batches[0])
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(model.parameters(), twin.parameters()))
        del twin, twin_step, twin_state
        if not same:
            raise RuntimeError(f"{name}: two first steps from the same weights differ in "
                               f"their bits")
        for i in range(1, WARMUP_STEPS):
            state, metrics = step(state, gpu_batches[i % len(gpu_batches)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for i in range(timed):
            t = time.perf_counter()
            state, metrics = step(state, gpu_batches[i % len(gpu_batches)])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        out[f"{tag}_{name}_peak_mib"] = peak
        vals = {k: float(v) for k, v in metrics.items()}
        if set(vals) != {"loss", "loss_e", "loss_f", "mae_e", "mae_f", "grad_norm"} or not all(
                v == v and abs(v) < float("inf") for v in vals.values()):
            raise RuntimeError(f"{name}: missing or non-finite training metrics {vals}")
        moved = max(float((p.detach() - before[n]).abs().max())
                    for n, p in model.named_parameters())
        ema_moved = max(float((state.ema[n] - before[n]).abs().max()) for n in before)
        if not (moved > 0 and ema_moved > 0) or state.step != WARMUP_STEPS + timed:
            raise RuntimeError(f"{name}: parameters or EMA did not move ({moved}, {ema_moved})")
        mps = MD17_BATCH / statistics.median(times)
        out[f"{tag}_{name}"] = mps
        print(f"{tag} {name}: {mps:.1f} molecules/s at batch {MD17_BATCH} (median of "
              f"{timed} steps after {WARMUP_STEPS} warm-up; step seconds "
              f"{[round(t, 4) for t in times]}), peak memory {peak:.0f} MiB, last step "
              f"{ {k: round(v, 4) for k, v in vals.items()} }, max parameter move {moved:.3e}, "
              f"two first steps bitwise equal", flush=True)
        del model, state


def md17_train_vs_cpu(pt, torch, dev, tag="md17_train", route=None, ref64=None):
    """One full-width force training step of MD17_CPU_MOLECULES molecules on
    the card and on the CPU plain path, from the same weights.  ``ref64``:
    the float64 CPU step of an earlier call on another route or layout (the
    same function); returns the one this call used.  The batch is in
    ``route``'s layout."""
    from equiformer_tpu_torch.data import md17_like_dataset

    data = md17_like_dataset(MD17_CPU_MOLECULES, num_atoms=MD17_SLOTS, seed=SEED)
    batch, max_edges = cpu_batch(data, MD17_SLOTS, route, MD17_SLOTS + 1, with_forces=True)
    make = pt.model_entrypoint(MD17_MODEL)

    def one_step(d, name, double=False):
        model = make(**with_route(route, max_edges=max_edges, nodes_per_graph=MD17_SLOTS,
                                  seed=SEED, device=d,
                                  compute_dtype="bfloat16" if name == "bfloat16" else None))
        b = batch.to(d)
        if double:
            model, b = model.double(), b.to(dtype=torch.float64)
        step, state = md17_train_setup(pt, model)
        t = time.perf_counter()
        state, m = step(state, b)
        if d != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        return ({k: float(v) for k, v in m.items()}, secs,
                {n: p.detach().double().cpu() for n, p in model.named_parameters()})

    return step_vs_cpu(torch, dev, tag, one_step, ref64,
                       f"{MD17_CPU_MOLECULES} molecules, max_edges {max_edges}")


def step_vs_cpu(torch, dev, tag, one_step, ref64, what):
    """Hold one training step on the card against the CPU plain path:
    ``one_step(device, dtype name, double=False)`` gives (metrics, seconds,
    float64 copies of the updated parameters).  float32 within CPU_RTOL;
    bfloat16 no further from the float64 CPU step (``ref64``, taken here when
    None) than MD17_BF16_FACTOR times the bfloat16 CPU path, with a floor of
    BF16_SCALAR_FLOOR for the two scalars.  Returns ``ref64``."""

    def dist(a, b):
        """Relative distance of the two scalars, and of the parameters
        against max |param|."""
        (ma, _, pa), (mb, _, pb) = a, b
        scale = max(float(p.abs().max()) for p in pb.values())
        return ({k: abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30) for k in ("loss", "grad_norm")},
                max(float((pa[n] - pb[n]).abs().max()) for n in pb) / scale)

    if ref64 is None:
        ref64 = one_step("cpu", "float32", double=True)
    print(f"{tag} float64 CPU step ({what}): {ref64[1]:.1f} s, {ref64[0]}", flush=True)
    for name in ("float32", "bfloat16"):
        card, cpu = one_step(dev, name), one_step("cpu", name)
        (errs, perr), (c64, pc64), (u64, pu64) = dist(card, cpu), dist(card, ref64), \
            dist(cpu, ref64)
        if name == "float32":
            tol = CPU_RTOL[name]
            ok = max(errs.values()) <= tol and perr <= tol
            rule = f"bound {tol:.0e}"
        else:
            ok = pc64 <= MD17_BF16_FACTOR * pu64 and all(
                c64[k] <= max(MD17_BF16_FACTOR * u64[k], BF16_SCALAR_FLOOR) for k in c64)
            rule = (f"card vs float64 bound {MD17_BF16_FACTOR} x CPU vs float64, floor "
                    f"{BF16_SCALAR_FLOOR:.0e} for the scalars")
        print(f"{tag} {name} card vs CPU plain path: loss {card[0]['loss']:.6f} / "
              f"{cpu[0]['loss']:.6f}, grad_norm {card[0]['grad_norm']:.6f} / "
              f"{cpu[0]['grad_norm']:.6f}, rel {errs}, updated params {perr:.3e} of max "
              f"|param|; vs float64: card {c64} params {pc64:.3e}, CPU {u64} params "
              f"{pu64:.3e} ({rule}); step {card[1]:.2f} s card, {cpu[1]:.1f} s CPU",
              flush=True)
        if not ok:
            raise RuntimeError(f"{tag} {name} training step on the card disagrees with the CPU")
    return ref64


def dens_train_setup(pt, model):
    from equiformer_tpu_torch.models.dens import ASPIRIN_L3_TRAIN as recipe

    opt = pt.create_optimizer(pt.cosine_warmup_schedule(*recipe["schedule"]),
                              weight_decay=recipe["weight_decay"])
    train_step, _ = pt.make_dens_steps(model, opt, **recipe["steps"])
    return train_step, pt.TrainState.create(model, opt)


def dens_train_phase(pt, torch, gpu_batches, dev, out, tag="dens_train",
                     expected=EXPECTED_DENS_TRAIN):
    """Full-width DeNS training steps at batch 8 in fp32 and bf16 on the
    card (TIMED_STEPS timed after WARMUP_STEPS), the noise drawn from a
    CUDA generator seeded with SEED."""
    from equiformer_tpu_torch.models.dens import ASPIRIN_L3, ASPIRIN_L3_TRAIN, every_pair_edges

    dp_weight = ASPIRIN_L3_TRAIN["dp_weight"]
    make = pt.model_entrypoint(DENS_MODEL)  # on the card
    for name in ("float32", "bfloat16"):
        kw = dict(**ASPIRIN_L3, max_edges=every_pair_edges(MD17_BATCH, MD17_SLOTS),
                  nodes_per_graph=MD17_SLOTS, seed=SEED,
                  compute_dtype=None if name == "float32" else name)
        runs = []
        for _ in range(2):  # the second model from the same seed takes the same first step
            model = make(**kw)
            step, state = dens_train_setup(pt, model)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            (state, metrics), launches = counted(
                torch, lambda: step(state, gpu_batches[0], gen, dp_weight))
            runs.append(({k: float(v) for k, v in metrics.items()},
                         [p.detach().clone() for p in model.parameters()]))
        print(f"{tag} {name}: launches in one step: {launches}")
        if launches != expected:
            raise RuntimeError(f"launch counts {launches} != expected {expected}")
        out[f"{tag}_launches"] = launches
        (m1, p1), (m2, p2) = runs
        if m1 != m2 or not all(torch.equal(a, b) for a, b in zip(p1, p2)):
            raise RuntimeError(f"{name}: two first DeNS steps from one seed differ in their bits")
        del runs, p1, p2
        for i in range(1, WARMUP_STEPS):
            state, metrics = step(state, gpu_batches[i % len(gpu_batches)], gen, dp_weight)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times, dp_live = [], 0
        for i in range(TIMED_STEPS):
            t = time.perf_counter()
            state, metrics = step(state, gpu_batches[i % len(gpu_batches)], gen, dp_weight)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            dp_live += float(metrics["loss_dp"]) > 0
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        out[f"{tag}_{name}_peak_mib"] = peak
        vals = {k: float(v) for k, v in metrics.items()}
        if set(vals) != DENS_METRICS or not all(
                v == v and abs(v) < float("inf") for v in vals.values()):
            raise RuntimeError(f"{name}: missing or non-finite DeNS metrics {vals}")
        moved = max(float((p.detach() - before[n]).abs().max())
                    for n, p in model.named_parameters())
        ema_moved = max(float((state.ema[n] - before[n]).abs().max()) for n in before)
        if not (moved > 0 and ema_moved > 0) or state.step != WARMUP_STEPS + TIMED_STEPS:
            raise RuntimeError(f"{name}: parameters or EMA did not move ({moved}, {ema_moved})")
        mps = MD17_BATCH / statistics.median(times)
        out[f"{tag}_{name}"] = mps
        print(f"{tag} {name}: {mps:.1f} molecules/s at batch {MD17_BATCH} (median of "
              f"{TIMED_STEPS} steps after {WARMUP_STEPS} warm-up; step seconds "
              f"{[round(t, 4) for t in times]}), peak memory {peak:.0f} MiB, last step "
              f"{ {k: round(v, 4) for k, v in vals.items()} }, loss_dp > 0 in {dp_live} of "
              f"{TIMED_STEPS} steps, max parameter move {moved:.3e}, two first steps from one "
              f"seed bitwise equal", flush=True)
        del model, state


def dens_vs_cpu(pt, torch, dev, tag="dens_train"):
    """One full-width DeNS step (``train_step.noised``) of
    MD17_CPU_MOLECULES molecules on the card and on the CPU plain path, from
    the same weights and the same noise: drawn on the CPU from a seed with
    probability 1 and the recipe's corrupt ratio (both force terms live),
    then moved to the card.  The model's depth is cut to DENS_CPU_LAYERS
    blocks (the first and the wide last): the CPU's bfloat16 step at full
    depth took ~68 s of the run's time limit."""
    from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset
    from equiformer_tpu_torch.models.dens import ASPIRIN_L3, ASPIRIN_L3_TRAIN, every_pair_edges

    recipe = ASPIRIN_L3_TRAIN["steps"]
    data = md17_like_dataset(MD17_CPU_MOLECULES, num_atoms=MD17_SLOTS, seed=SEED)
    batch = next(iter(GraphLoader(data, MD17_CPU_MOLECULES, dense_slots=MD17_SLOTS,
                                  shuffle=False, with_forces=True)))
    batch = pt.add_masked_gaussian_noise(
        batch, torch.Generator().manual_seed(SEED), recipe["denoising_pos_std"], 1.0,
        recipe["corrupt_ratio"])
    noised = int(batch.extras["noise_mask"].sum())
    max_edges = every_pair_edges(MD17_CPU_MOLECULES, MD17_SLOTS)
    make = pt.model_entrypoint(DENS_MODEL)

    def one_step(d, name, double=False):
        model = make(**{**ASPIRIN_L3, "num_layers": DENS_CPU_LAYERS}, max_edges=max_edges,
                     nodes_per_graph=MD17_SLOTS, seed=SEED, device=d,
                     compute_dtype="bfloat16" if name == "bfloat16" else None)
        b = batch.to(d)
        if double:
            model, b = model.double(), b.to(dtype=torch.float64)
        step, state = dens_train_setup(pt, model)
        t = time.perf_counter()
        state, m = step.noised(state, b, ASPIRIN_L3_TRAIN["dp_weight"])
        if d != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        return ({k: float(v) for k, v in m.items()}, secs,
                {n: p.detach().double().cpu() for n, p in model.named_parameters()})

    return step_vs_cpu(torch, dev, tag, one_step, None,
                       f"{MD17_CPU_MOLECULES} molecules, {noised} atoms noised, max_edges "
                       f"{max_edges}")


def to_packed(batch, slots, node_capacity, node_keys=()):
    """The packed batch of a fixed-slot one (``slots`` node slots a graph):
    each graph's real atoms, forces, targets and the extras ``node_keys``,
    collated by ``collate`` into ``node_capacity`` rows on the CPU."""
    from equiformer_tpu_torch.graph.batching import collate

    b = batch.to("cpu")
    graphs = []
    for g in range(b.graph_mask.shape[0]):
        rows = slice(g * slots, (g + 1) * slots)
        n = int(b.node_mask[rows].sum())
        graph = {"pos": b.pos[rows][:n].numpy(), "species": b.species[rows][:n].numpy(),
                 "y": float(b.y[g]), "forces": b.forces[rows][:n].numpy()}
        graph.update({k: b.extras[k][rows][:n].numpy() for k in node_keys})
        graphs.append(graph)
    return collate(graphs, node_capacity, len(graphs), with_forces=True,
                   extra_node_keys=node_keys)


def packed_geometry(torch, build_edges, layouts, dev):
    """Each layout's radius graph and backward plan (``build_edges``) on
    batch 0: CUDA-event ms a call and the peak memory above the batch."""
    for label, args in layouts.items():
        fn = lambda: build_edges(*args)  # noqa: E731
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        print(f"{label} radius graph + backward plan at batch 0: {cuda_time_ms(fn, torch):.4f} ms "
              f"a call, peak {peak:.1f} MiB above the batch", flush=True)


def packed_qm9_phase(pt, torch, make, data, counts, dense_max_edges, dense_gpu, dev, out):
    """Phase 19: the QM9 flagship on the packed layout at the CLI's
    capacities: the radius graph's time and memory beside the fixed-slot
    one's, the eval forward's launch counts and its predictions against the
    fixed-slot layout's on the same molecules and weights, phase 4 on the
    packed batches, two first steps from one seed bitwise equal, and
    phase 5."""
    from equiformer_tpu_torch.data import GraphLoader
    from equiformer_tpu_torch.graph.batching import cli_capacities
    from equiformer_tpu_torch.graph.radius_graph import build_edges

    nodes, max_edges = cli_capacities(BATCH, SLOTS, QM9_EDGES_PER_NODE)
    if max(counts) > max_edges:
        raise RuntimeError(f"real edges {counts} exceed the packed capacity {max_edges}")
    gpu = [b.to(dev) for b in GraphLoader(data, BATCH, nodes, shuffle=False)]
    print(f"packed: {N_BATCHES} x {BATCH} graphs in {nodes} node rows, max_edges {max_edges} "
          f"(real edges {counts})", flush=True)
    b0, d0 = gpu[0], dense_gpu[0]
    packed_geometry(torch, build_edges, {
        "packed": (b0.pos, b0.batch, b0.node_mask, BATCH, 5.0, max_edges, 0),
        "fixed-slot": (d0.pos, d0.batch, d0.node_mask, BATCH, 5.0, dense_max_edges, SLOTS)}, dev)

    packed = make(max_edges=max_edges, nodes_per_graph=0, seed=SEED).eval()
    fixed = make(max_edges=dense_max_edges, nodes_per_graph=SLOTS, seed=SEED).eval()
    rp, launches = counted(torch, lambda: pt.evaluate(packed, b0))
    print(f"packed eval: launches in one forward: {launches}")
    if launches != EXPECTED_EVAL:
        raise RuntimeError(f"launch counts {launches} != expected {EXPECTED_EVAL}")
    out["packed_eval_launches"] = launches
    pp, pd = rp["pred"].cpu(), pt.evaluate(fixed, d0)["pred"].cpu()
    rel = float((pp - pd).abs().max()) / float(pd.abs().max())
    print(f"packed vs fixed-slot eval float32, batch 0 ({BATCH} molecules, same weights): "
          f"|diff| {rel:.3e} of max |pred| (bound {LAYOUT_PRED_RTOL:.0e}), bits equal: "
          f"{torch.equal(pp, pd)}", flush=True)
    if not (bool(pp.isfinite().all()) and rel <= LAYOUT_PRED_RTOL):
        raise RuntimeError("the packed layout's predictions disagree with the fixed-slot ones")
    del packed, fixed

    train_phase(pt, torch, make, max_edges, gpu, dev, out, "packed_train", EXPECTED_TRAIN, PACKED)
    for name in ("bfloat16", "float32"):
        print(f"train {name}: packed {out[f'packed_train_{name}']:.1f} graphs/s, peak "
              f"{out[f'packed_train_{name}_peak_mib']:.0f} MiB; fixed-slot "
              f"{out[f'train_{name}']:.1f} graphs/s, peak {out[f'train_{name}_peak_mib']:.0f} MiB")
    first_steps_bitwise(pt, torch, make, max_edges, b0, PACKED, "packed_train")
    train_vs_cpu(pt, torch, make, data, dev, "packed_train", PACKED)


def packed_md17_phase(pt, torch, dense_gpu, dense_max_edges, step64, dev, out):
    """Phase 20: the exp_l3 force model on the packed layout at the MD17
    CLI's capacities: the force evaluation's launch counts, its energies and
    forces against the fixed-slot layout's on the same molecules and
    weights, phase 9 (PACKED_TIMED_STEPS timed steps, two first steps
    bitwise equal) and phase 10 against the fixed-slot phase's float64 CPU
    step (the same function)."""
    from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset
    from equiformer_tpu_torch.graph.batching import cli_capacities

    data = md17_like_dataset(MD17_BATCH * N_BATCHES, num_atoms=MD17_SLOTS, seed=SEED)
    nodes, max_edges = cli_capacities(MD17_BATCH, MD17_SLOTS, MD17_SLOTS + 1)
    gpu = [b.to(dev) for b in GraphLoader(data, MD17_BATCH, nodes, shuffle=False,
                                          with_forces=True)]
    print(f"packed md17: {N_BATCHES} x {MD17_BATCH} molecules in {nodes} node rows, max_edges "
          f"{max_edges}", flush=True)
    entry = pt.model_entrypoint(MD17_MODEL)  # on the card
    packed = entry(max_edges=max_edges, nodes_per_graph=0, seed=SEED)
    fixed = entry(max_edges=dense_max_edges, nodes_per_graph=MD17_SLOTS, seed=SEED)
    rp, launches = counted(torch, lambda: pt.evaluate_md17(packed, gpu[0]))
    print(f"packed_md17: launches in one force evaluation: {launches}")
    if launches != EXPECTED_MD17:
        raise RuntimeError(f"launch counts {launches} != expected {EXPECTED_MD17}")
    out["packed_md17_launches"] = launches
    rd = pt.evaluate_md17(fixed, dense_gpu[0])
    ep, ed = rp["energy"].cpu(), rd["energy"].cpu()
    fp, fd = (r["forces"][b.node_mask].cpu() for r, b in ((rp, gpu[0]), (rd, dense_gpu[0])))
    e_rel = float((ep - ed).abs().max()) / float(ed.abs().max())
    f_rel = float((fp - fd).abs().max()) / float(fd.abs().max())
    print(f"packed vs fixed-slot md17 float32, batch 0 (same molecules and weights): energies "
          f"{e_rel:.3e} of max |E|, forces {f_rel:.3e} of max |F| (bound "
          f"{LAYOUT_FORCE_RTOL:.0e}), bits equal: energies {torch.equal(ep, ed)}, forces "
          f"{torch.equal(fp, fd)}", flush=True)
    if not (bool(fp.isfinite().all()) and e_rel <= LAYOUT_FORCE_RTOL
            and f_rel <= LAYOUT_FORCE_RTOL):
        raise RuntimeError("the packed layout's energies or forces disagree with the fixed-slot "
                           "ones")
    del packed, fixed
    md17_train_phase(pt, torch, max_edges, gpu, dev, out, "packed_md17_train",
                     EXPECTED_MD17_TRAIN, PACKED, PACKED_TIMED_STEPS)
    for name in ("float32", "bfloat16"):
        print(f"md17 train {name}: packed {out[f'packed_md17_train_{name}']:.1f} molecules/s, "
              f"peak {out[f'packed_md17_train_{name}_peak_mib']:.0f} MiB; fixed-slot "
              f"{out[f'md17_train_{name}']:.1f} molecules/s, peak "
              f"{out[f'md17_train_{name}_peak_mib']:.0f} MiB")
    md17_train_vs_cpu(pt, torch, dev, "packed_md17_train", PACKED, step64)


def packed_dens_phase(pt, torch, dense_gpu, dev, out):
    """Phase 21: the aspirin L3 DeNS recipe on the packed layout
    (``max_edges`` the MD17 CLI's 5632): the launch counts of one
    ``make_dens_steps`` step with the noise drawn on the card, then one
    float32 step of each layout from one seed on the same noise (drawn on
    the fixed-slot batch 0, then packed): metrics and updated parameters
    within ROUTE_RTOL of each other."""
    from equiformer_tpu_torch.graph.batching import cli_capacities
    from equiformer_tpu_torch.models.dens import ASPIRIN_L3, ASPIRIN_L3_TRAIN, every_pair_edges

    recipe, dp_weight = ASPIRIN_L3_TRAIN["steps"], ASPIRIN_L3_TRAIN["dp_weight"]
    nodes, max_edges = cli_capacities(MD17_BATCH, MD17_SLOTS, MD17_SLOTS + 1)
    make = pt.model_entrypoint(DENS_MODEL)  # on the card
    d0 = dense_gpu[0]
    model = make(**ASPIRIN_L3, max_edges=max_edges, nodes_per_graph=0, seed=SEED)
    step, state = dens_train_setup(pt, model)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p0 = to_packed(d0, MD17_SLOTS, nodes).to(dev)
    (state, m), launches = counted(torch, lambda: step(state, p0, gen, dp_weight))
    vals = {k: float(v) for k, v in m.items()}
    print(f"packed_dens_train: launches in one step: {launches}; metrics {vals}", flush=True)
    if launches != EXPECTED_DENS_TRAIN:
        raise RuntimeError(f"launch counts {launches} != expected {EXPECTED_DENS_TRAIN}")
    if set(vals) != DENS_METRICS or not all(v == v and abs(v) < float("inf")
                                            for v in vals.values()):
        raise RuntimeError(f"missing or non-finite packed DeNS metrics {vals}")
    out["packed_dens_train_launches"] = launches
    del model, state, step

    noised = pt.add_masked_gaussian_noise(
        d0, torch.Generator(device=dev).manual_seed(SEED + 3), recipe["denoising_pos_std"], 1.0,
        recipe["corrupt_ratio"])
    layouts = {"fixed-slot": (dict(max_edges=every_pair_edges(MD17_BATCH, MD17_SLOTS),
                                   nodes_per_graph=MD17_SLOTS), noised),
               "packed": (dict(max_edges=max_edges, nodes_per_graph=0),
                          to_packed(noised, MD17_SLOTS, nodes, DENS_NODE_KEYS).to(dev))}
    res = {}
    for label, (kw, b) in layouts.items():
        model = make(**ASPIRIN_L3, **kw, seed=SEED)
        step, state = dens_train_setup(pt, model)
        _, m = step.noised(state, b, dp_weight)
        res[label] = ({k: float(v) for k, v in m.items()},
                      [p.detach().clone() for p in model.parameters()])
        del model, state, step
    (mf, pf), (mp, pp) = res["fixed-slot"], res["packed"]
    errs = {k: abs(mp[k] - mf[k]) / max(abs(mf[k]), 1e-30) for k in DENS_METRICS}
    scale = max(float(p.abs().max()) for p in pf)
    errs["params"] = max(float((p - q).abs().max()) for p, q in zip(pp, pf)) / scale
    bits = mp == mf and all(torch.equal(p, q) for p, q in zip(pp, pf))
    print(f"packed vs fixed-slot DeNS step float32 ({int(noised.extras['noise_mask'].sum())} "
          f"atoms noised): packed {mp}, fixed-slot {mf}, rel {errs} (the updated parameters "
          f"against max |param|; bound {ROUTE_RTOL:.0e}), bits equal: {bits}", flush=True)
    if not all(e <= ROUTE_RTOL for e in errs.values()):
        raise RuntimeError("the packed DeNS step disagrees with the fixed-slot one")


def recipe_setup(pt, model, clip, md17=False):
    """The CLIs' step on ``model``: AdamW with the no-decay mask and
    ``grad_clip_norm`` ``clip``, the target statistics the model holds."""
    if md17:
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000),
                                  weight_decay=1e-6, grad_clip_norm=clip)
        step, _ = pt.make_md17_steps(model, opt, model.task_mean, model.task_std,
                                     energy_weight=1.0, force_weight=80.0, ema_decay=0.999)
    else:
        opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 100, 100000),
                                  weight_decay=5e-3, grad_clip_norm=clip)
        step, _ = pt.make_qm9_steps(model, opt, model.task_mean, model.task_std, "l1",
                                    ema_decay=0.999)
    return step, pt.TrainState.create(model, opt)


def recipe_step(pt, torch, make, kw, batch, dev, clip, md17):
    """One step of a fresh model (``make(**kw)``) with generator seed SEED:
    (metrics, parameters, the generator's state, launches, peak MiB, block
    runs: block_0's forward calls, its recomputes included)."""
    model = make(**kw)
    step, state = recipe_setup(pt, model, clip, md17)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    runs = []
    model.block_0.register_forward_pre_hook(lambda *_: runs.append(1))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    (state, m), launches = counted(torch, lambda: step(state, batch, gen))
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    return ({k: float(v) for k, v in m.items()}, [p.detach().clone() for p in model.parameters()],
            gen.get_state(), launches, peak, len(runs))


def remat_vs_plain(pt, torch, make, kw, gpu, dev, out, tag, expected, md17):
    """Phase 22's model check for one dtype: the un-rematted step without a
    clip gives the gradient norm, CLIP_SHARE of it is the clip; then one
    step with that clip without and with remat from one seed: metrics and
    parameters within ROUTE_RTOL (bits printed), the generators in one
    state, launches, peak memory above the model and state, and the block
    runs a step; then PACKED_TIMED_STEPS timed rematted steps.  Returns the
    clip."""
    probe = recipe_step(pt, torch, make, kw, gpu[0], dev, None, md17)
    clip = CLIP_SHARE * probe[0]["grad_norm"]
    plain = recipe_step(pt, torch, make, kw, gpu[0], dev, clip, md17)
    remat = recipe_step(pt, torch, make, {**kw, "remat": True}, gpu[0], dev, clip, md17)
    (m0, p0, g0, l0, peak0, r0), (m1, p1, g1, l1, peak1, r1) = plain, remat
    print(f"{tag}: launches in one step without remat { {k: v for k, v in l0.items() if v} }, "
          f"with remat { {k: v for k, v in l1.items() if v} }; block_0 runs a "
          f"step {r0} / {r1} (the forward and {r1 - 1} recompute(s))", flush=True)
    if l1 != expected:
        raise RuntimeError(f"remat launch counts {l1} != expected {expected}")
    out[f"{tag}_launches"] = l1
    errs = {k: abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-30) for k in m0}
    scale = max(float(p.abs().max()) for p in p0)
    errs["params"] = max(float((a - b).abs().max()) for a, b in zip(p0, p1)) / scale
    bits = m0 == m1 and all(torch.equal(a, b) for a, b in zip(p0, p1))
    factor = min(1.0, clip / m0["grad_norm"])
    print(f"{tag}: clip {clip:.6g} ({CLIP_SHARE} x the unclipped grad norm "
          f"{probe[0]['grad_norm']:.6g}), clip factor {factor:.6f}; remat vs no remat, one step "
          f"from one seed: {m1} / {m0}, rel {errs} (bound {ROUTE_RTOL:.0e}), bits equal: {bits}, "
          f"generators in one state: {torch.equal(g0, g1)}; peak memory above the model and "
          f"state: remat {peak1:.0f} MiB, no remat {peak0:.0f} MiB", flush=True)
    out[f"{tag}_peak_mib"], out[f"{tag}_plain_peak_mib"] = peak1, peak0
    if not (all(e <= ROUTE_RTOL for e in errs.values()) and torch.equal(g0, g1)
            and factor < 1.0):
        raise RuntimeError(f"{tag}: the rematted step disagrees with the un-rematted one")
    model = make(**kw, remat=True)
    step, state = recipe_setup(pt, model, clip, md17)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for i in range(WARMUP_STEPS):
        step(state, gpu[i % len(gpu)], gen)
    torch.cuda.synchronize()
    times = []
    for i in range(PACKED_TIMED_STEPS):
        t = time.perf_counter()
        _, metrics = step(state, gpu[i % len(gpu)], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    vals = {k: float(v) for k, v in metrics.items()}
    if not all(v == v and abs(v) < float("inf") for v in vals.values()):
        raise RuntimeError(f"{tag}: non-finite metrics {vals}")
    rate = int(gpu[0].graph_mask.shape[0]) / statistics.median(times)
    out[tag] = rate
    print(f"{tag}: {rate:.1f} {'molecules' if md17 else 'graphs'}/s (median of "
          f"{PACKED_TIMED_STEPS} steps after "
          f"{WARMUP_STEPS} warm-up; step seconds {[round(t, 4) for t in times]}), last step "
          f"{ {k: round(v, 4) for k, v in vals.items()} }", flush=True)
    return clip


def recipe_phase(pt, torch, make, data, md17_data, dev, out):
    """Phase 22: the CLIs' training recipe on the packed batches at the
    CLIs' capacities: ``remat=True``, ``task_mean`` / ``task_std`` (QM9),
    a binding ``grad_clip_norm``; the QM9 flagship and the exp_l3 force
    model each against its un-rematted step in fp32 and bf16
    (``remat_vs_plain``); then ``CheckpointManager`` resume on the card
    (the QM9 rematted fp32 state saved after step 2 and restored into a
    fresh state: step 3 on both in equal bits) and the EMA's npz in a CPU
    model (eval predictions within CPU_RTOL of the card's)."""
    import os
    import shutil
    import tempfile

    from equiformer_tpu_torch.data import GraphLoader
    from equiformer_tpu_torch.graph.batching import cli_capacities
    from equiformer_tpu_torch.train import CheckpointManager, load_params, save_params
    from equiformer_tpu_torch.utils import params_to_jax

    nodes, max_edges = cli_capacities(BATCH, SLOTS, QM9_EDGES_PER_NODE)
    gpu = [b.to(dev) for b in GraphLoader(data, BATCH, nodes, shuffle=False)]
    qm9_kw = dict(max_edges=max_edges, nodes_per_graph=0, seed=SEED, task_mean=QM9_MEAN,
                  task_std=QM9_STD)
    m_nodes, m_edges = cli_capacities(MD17_BATCH, MD17_SLOTS, MD17_SLOTS + 1)
    md17_gpu = [b.to(dev) for b in GraphLoader(md17_data, MD17_BATCH, m_nodes, shuffle=False,
                                                with_forces=True)]
    md17_make = pt.model_entrypoint(MD17_MODEL)  # on the card
    clips = {}
    for name in ("float32", "bfloat16"):
        dt = {"compute_dtype": None if name == "float32" else name}
        clips[name] = remat_vs_plain(pt, torch, make, {**qm9_kw, **dt}, gpu, dev, out,
                                     f"remat_train_{name}", EXPECTED_REMAT_TRAIN, False)
        remat_vs_plain(pt, torch, md17_make, dict(max_edges=m_edges, nodes_per_graph=0,
                                                  seed=SEED, **dt),
                       md17_gpu, dev, out, f"remat_md17_train_{name}",
                       EXPECTED_REMAT_MD17_TRAIN, True)

    # resume: steps 1-2, save, step 3; a fresh state restored from step 2, step 3
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(directory, max_to_keep=2)
        kw = {**qm9_kw, "remat": True}
        model = make(**kw)
        step, state = recipe_setup(pt, model, clips["float32"])
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for i in range(2):
            step(state, gpu[i], gen)
        mgr.save(2, state, {"gen": gen.get_state().tolist()})
        _, m3 = step(state, gpu[2], gen)
        twin = make(**{**kw, "seed": SEED + 1})
        twin_step, twin_state = recipe_setup(pt, twin, clips["float32"])
        twin_state, meta = mgr.restore(twin_state)
        twin_gen = torch.Generator(device=dev)
        twin_gen.set_state(torch.tensor(meta["gen"], dtype=torch.uint8))
        _, t3 = twin_step(twin_state, gpu[2], twin_gen)
        torch.cuda.synchronize()
        same = {"metrics": {k: float(v) for k, v in m3.items()}
                == {k: float(v) for k, v in t3.items()},
                "params": all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                                twin.parameters())),
                "moments": all(torch.equal(state.opt_state[k][n], twin_state.opt_state[k][n])
                               for k in ("mu", "nu") for n in state.opt_state[k]),
                "ema": all(torch.equal(state.ema[n], twin_state.ema[n]) for n in state.ema),
                "step": state.step == twin_state.step == 3}
        print(f"resume on the card (fp32, remat, clip): step 3 after a restore of step 2 "
              f"against the uninterrupted step 3, bits equal: {same}", flush=True)
        if not all(same.values()):
            raise RuntimeError("the resumed step 3 differs from the uninterrupted one")

        # the card's EMA as JAX's npz, into a CPU model
        path = os.path.join(directory, "best_val.npz")
        save_params(path, {"params": params_to_jax(model, state.ema)})
        batch, cpu_edges = cpu_batch(data[:CPU_GRAPHS], SLOTS, PACKED, QM9_EDGES_PER_NODE)
        preds = {}
        for d in (dev, "cpu"):
            m = make(**{**qm9_kw, "max_edges": cpu_edges, "seed": SEED + 2}, device=d)
            load_params(path, m)
            preds[str(d)] = pt.evaluate(m, batch.to(d))["pred"].cpu()
        pg, pc = preds[str(dev)], preds["cpu"]
        rel = float((pg - pc).abs().max()) / float(pc.abs().max())
        print(f"EMA npz (save_params on the card, load_params into a CPU model): eval "
              f"predictions of {CPU_GRAPHS} graphs {rel:.3e} of max |pred| from the card's "
              f"(bound {CPU_RTOL['float32']:.0e})", flush=True)
        if not (bool(pg.isfinite().all()) and rel <= CPU_RTOL["float32"]):
            raise RuntimeError("the EMA loaded on the CPU predicts otherwise than on the card")
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def md17_train_kernel_phase(torch, model, batch, dev, records, sites=None, prefix="md17-"):
    """K5b's three legs and K5c against their plain versions at the exp_l3
    shapes of one batch of 8 md17-like molecules, at the three call sites
    (or ``sites``, their records named ``prefix + name``);
    each call's device time beside its wrapper time, and two calls for
    equal bits (no float atomics: the dW partials and the x leg's split
    partials are summed in a fixed order)."""
    from equiformer_tpu_torch.kernels import (
        KERNEL_WRAPPERS, dtp_lin_leg, dtp_lin_leg_plain, dtp_lin_legW, dtp_lin_legW_plain,
    )
    from equiformer_tpu_torch.kernels.dtp_lin_ho import leg_occupancy

    saved = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    edges, sh32, n_edges, n = batch_geometry(model, batch)
    E = edges.dst.shape[0]
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        size = torch.finfo(dt).bits // 8
        sh = sh32.to(dt)
        for site, (plan, heads, broadcast_x) in (sites or dtp_sites(model)).items():
            x, w, W, cot, _ = dtp_operands(torch, plan, heads, broadcast_x, E, n, dt, g, dev)
            shape = f"E={E} d_x={plan.d_x} d_w={plan.d_w} d_out={plan.d_out}"
            tp_elems, macs = dtp_work(plan)
            # bytes of each operand over the n real edges
            op_bytes = {"x": size * (plan.d_x if broadcast_x else n * plan.d_x),
                        "sh": size * n * plan.d_sh, "w": 0 if w is None else size * n * plan.d_w,
                        "out": size * n * plan.d_out, "W": size * plan.w_numel}
            widths = {"x": plan.d_x, "sh": plan.d_sh, "w": plan.d_w}
            for leg in ("x", "sh") + (() if w is None else ("w",)):
                ops = {"x": x, "sh": sh, "w": w, leg: None}
                call = lambda: dtp_lin_leg(plan, leg, cot, ops["x"], ops["sh"], ops["w"], W,  # noqa: E731
                                           n_edges)
                plain = lambda: dtp_lin_leg_plain(plan, leg, cot, ops["x"], ops["sh"],  # noqa: E731
                                                  ops["w"], W, n_edges)
                k, p, again = call(), plain(), call()
                torch.cuda.synchronize()
                if not torch.equal(k, again):
                    raise RuntimeError(f"K5b's {leg} leg at {site} {dt_name} repeats no bits")
                ms = cuda_time_ms(call, torch)
                plain_ms = cuda_time_ms(plain, torch, reps=3, inner=3)
                # every operand but the leg's own read once, the leg written once;
                # the dz product, then 3 operations per term element
                nbytes = sum(v for key, v in op_bytes.items() if key != leg) \
                    + size * E * widths[leg]
                record(records, "dtp_lin_leg", f"{prefix}{site}-{leg}", dt_name, shape,
                       [rel_err(k, p)], ms, plain_ms, nbytes, n * (2 * macs + 3 * tp_elems))
                device_line(torch, "K5b", f"{prefix}{site}-{leg}", dt_name, ms, call)
                print(f"dtp_lin_leg {leg} {site} {dt_name}: {-(-E // 16)} tiles x "
                      f"{len(plan.groups)} irrep groups" + (
                          f", {leg_occupancy(plan, dt)} resident blocks per SM"
                          if leg == "sh" else ""))
            call = lambda: dtp_lin_legW(plan, cot, x, sh, w, n_edges)  # noqa: E731
            k, p, again = call(), dtp_lin_legW_plain(plan, cot, x, sh, w, n_edges), call()
            torch.cuda.synchronize()
            if not torch.equal(k, again):
                raise RuntimeError(f"K5c at {site} {dt_name} repeats no bits")
            ms = cuda_time_ms(call, torch)
            plain_ms = cuda_time_ms(lambda: dtp_lin_legW_plain(plan, cot, x, sh, w, n_edges),
                                    torch, reps=3, inner=3)
            # the z recompute (3 operations per term element), then z^T g; dW in fp32
            nbytes = sum(v for key, v in op_bytes.items() if key != "W") + 4 * plan.w_numel
            record(records, "dtp_lin_legW", f"{prefix}{site}", dt_name, shape, [rel_err(k, p)], ms,
                   plain_ms, nbytes, n * (2 * macs + 3 * tp_elems))
            device_line(torch, "K5c", prefix + site, dt_name, ms, call)
    for name, fn in KERNEL_WRAPPERS.items():  # comparison launches do not count
        fn.launches = saved[name]


def k6_sites(model):
    """The DTP's term lists at block 0's two sites and the edge-degree
    embedding: name -> (TermList, shared a, shared b)."""
    ga = model.block_0.ga
    return {"sep_act": (ga.sep_act.dtp.terms, False, False),
            "sep_value": (ga.sep_value.dtp.terms, False, True),
            "edge_deg": (model.edge_deg_embed.dw.terms, True, False)}


def k6_kernel_phase(torch, model, batch, dev, records, sites, prefix=""):
    """K6-T (the forward terms and the x and w legs' permutations), K6-R and
    K6-FB against their plain versions at one batch's shapes, at the named
    call sites, in float32 and bfloat16, timed as phase 3.  The route
    computes every row, padding included, so the bounds count all E rows.
    K6-T, K6-R and K6-FB repeat their bits, K6-FB's dx and dw are the bits
    of K6-T's x and w legs and K6-R's output is K6-FB's dsh (each element
    summed in the same order)."""
    from equiformer_tpu_torch.kernels import KERNEL_WRAPPERS
    from equiformer_tpu_torch.kernels import dtp as kd

    saved = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    edges, sh32, _, _ = batch_geometry(model, batch)
    E = edges.dst.shape[0]
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        size = torch.finfo(dt).bits // 8
        sh = sh32.to(dt)
        for site, (tl, sa, sb) in k6_sites(model).items():
            if site not in sites:
                continue
            rnd = lambda n, rows=E: torch.randn(rows, n, generator=g, device=dev).to(dt)  # noqa: E731
            x = rnd(tl.d_a, 1).expand(E, tl.d_a) if sa else rnd(tl.d_a)
            w = rnd(tl.d_b, 1) if sb else rnd(tl.d_b)
            ct = rnd(tl.d_out)
            elems = E * sum(t.mul for t in tl.terms)  # term elements of one call
            shape = f"E={E} d_a={tl.d_a} d_b={tl.d_b} d_out={tl.d_out}"
            rows = {"x": size * (1 if sa else E) * tl.d_a, "sh": size * E * tl.d_col,
                    "w": size * (1 if sb else E) * tl.d_b, "z": size * E * tl.d_out}
            legs = {  # name: (kernel call, plain call, bytes read + written, operations)
                "dtp_t": (lambda: kd.dtp_t(tl, x, sh, w), lambda: kd.dtp_t_plain(tl, x, sh, w),
                          rows["x"] + rows["sh"] + rows["w"] + rows["z"], 3 * elems),
                "dtp_t-x": (lambda: kd.dtp_t(kd.perm_a(tl), ct, sh, w),
                            lambda: kd.dtp_t_plain(kd.perm_a(tl), ct, sh, w),
                            rows["z"] + rows["sh"] + rows["w"] + size * E * tl.d_a, 3 * elems),
                "dtp_t-w": (lambda: kd.dtp_t(kd.perm_b(tl), x, sh, ct),
                            lambda: kd.dtp_t_plain(kd.perm_b(tl), x, sh, ct),
                            rows["x"] + rows["sh"] + rows["z"] + size * E * tl.d_b, 3 * elems),
                "dtp_r": (lambda: kd.dtp_r(tl, x, w, ct), lambda: kd.dtp_r_plain(tl, x, w, ct),
                          rows["x"] + rows["w"] + rows["z"] + rows["sh"], 3 * elems),
                "dtp_fused_bwd": (lambda: kd.dtp_fused_bwd(tl, x, sh, w, ct),
                                  lambda: kd.dtp_fused_bwd_plain(tl, x, sh, w, ct),
                                  sum(rows.values()) + size * E * (tl.d_a + tl.d_col + tl.d_b),
                                  9 * elems),
            }
            z, fb = kd.dtp_t(tl, x, sh, w), kd.dtp_fused_bwd(tl, x, sh, w, ct)
            x_leg, w_leg = legs["dtp_t-x"][0](), legs["dtp_t-w"][0]()
            fb2 = kd.dtp_fused_bwd(tl, x, sh, w, ct)
            r = kd.dtp_r(tl, x, w, ct)
            same = {"K6-T repeat": torch.equal(z, kd.dtp_t(tl, x, sh, w)),
                    "K6-FB repeat": all(torch.equal(p, q) for p, q in zip(fb, fb2)),
                    "K6-R repeat": torch.equal(r, kd.dtp_r(tl, x, w, ct)),
                    "K6-FB dx = K6-T x leg": torch.equal(fb[0], x_leg),
                    "K6-FB dw = K6-T w leg": torch.equal(fb[2], w_leg),
                    "K6-R = K6-FB dsh": torch.equal(r, fb[1])}
            print(f"k6 {prefix}{site} {dt_name} bitwise: {same}", flush=True)
            if not all(same.values()):
                raise RuntimeError(f"K6 {prefix}{site} {dt_name}: bits differ: {same}")
            for leg, (call, plain, nbytes, flops) in legs.items():
                k, p = call(), plain()
                torch.cuda.synchronize()
                pairs = zip(k, p) if isinstance(k, tuple) else [(k, p)]
                errs = [rel_err(a, b) for a, b in pairs]
                ms = cuda_time_ms(call, torch)
                plain_ms = cuda_time_ms(plain, torch, reps=3, inner=3)
                kernel, _, arg = leg.partition("-")
                record(records, kernel, f"{prefix}{site}" + (f"-{arg}" if arg else ""), dt_name,
                       shape, errs, ms, plain_ms, nbytes, flops)
    for name, fn in KERNEL_WRAPPERS.items():  # comparison launches do not count
        fn.launches = saved[name]


def unfused_eval_counts(pt, torch, make, max_edges, gpu_batches, out):
    """The launch counts of one eval forward on the unfused route, and its
    predictions finite."""
    model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED, compute_dtype="bfloat16",
                 **UNFUSED).eval()
    r, launches = counted(torch, lambda: pt.evaluate(model, gpu_batches[0]))
    print(f"unfused eval: launches in one forward: {launches}")
    if launches != EXPECTED_UNFUSED_EVAL or not bool(r["pred"].isfinite().all()):
        raise RuntimeError(f"launch counts {launches} != expected {EXPECTED_UNFUSED_EVAL} or "
                           f"non-finite predictions")
    out["unfused_eval_launches"] = launches


def routes_agree(pt, torch, make, max_edges, batch, dev,
                 routes=(("unfused", UNFUSED), ("first_order", FIRST_ORDER_BWD))):
    """One fp32 QM9 training step on each DTP route from the same seed (the
    same parameters), batch and dropout masks: loss, gradient norm and the
    updated parameters of each of ``routes`` (the unfused route and its
    one-launch backward, or the radial fold) within ROUTE_RTOL of the fused
    route's."""
    keep = None
    res, params = {}, {}
    for label, route in (("fused", {}),) + tuple(routes):
        model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED, **route)
        if keep is None:
            gen = torch.Generator().manual_seed(SEED + 5)
            keep = [torch.rand(max_edges, model.block_0.ga.num_heads, generator=gen) < 0.8
                    for _ in range(model.num_layers)]
        step, state = train_setup(pt, model)
        _, m = step(state, batch, iter(keep))
        res[label] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        params[label] = [p.detach().clone() for p in model.parameters()]
        del model, state
    errs = {label: {k: abs(v[k] - res["fused"][k]) / abs(res["fused"][k]) for k in v}
            for label, v in res.items() if label != "fused"}
    scale = max(float(p.abs().max()) for p in params["fused"])
    for label in errs:
        errs[label]["params"] = max(float((p - q).abs().max()) for p, q in
                                    zip(params[label], params["fused"])) / scale
    print(f"routes, one fp32 step at batch {BATCH}: {res}, rel to fused {errs} (the "
          f"updated parameters against max |param|; bound {ROUTE_RTOL:.0e})", flush=True)
    if not all(e <= ROUTE_RTOL for v in errs.values() for e in v.values()):
        raise RuntimeError(f"the training step of {[r for r, _ in routes]} disagrees with the "
                           f"fused route's")


def k7_kernel_phase(torch, sites, dev, records):
    """K7-F with K7-B (QM9 sep_act and edge degree) or K7-B3 (MD17 L3
    sep_act and edge degree, every output set: ``k7b3_checks``) against
    their plain versions at one batch's shapes, fp32 and bf16 (K7-F also
    with [Wr; 0], as a tangent in h's slot gives it, and twice for equal
    bits), timed as phase 3, beside the unfolded pair on the same inputs:
    cuBLAS ``w = h @ Wr + offset`` then K1; K2 then cuBLAS ``dh = dw Wr^T``
    and ``d[Wr; offset] = [h, 1]^T dw``; K5a then ``dh = dw Wr^T``.
    ``sites``: name -> (folded plan, head modules, row-broadcast x, radial
    profile, batch geometry, backward "bwd" or "bwd3").  The bounds add the
    fold's products (2 * 65 * d_w operations per real edge for w, as many
    for each transpose) to the unfolded kernel's count."""
    from equiformer_tpu_torch.kernels import (
        KERNEL_WRAPPERS, DTPLinPlan, dtp_lin_bwd, dtp_lin_fwd, dtp_lin_rad_bwd,
        dtp_lin_rad_bwd_plain, dtp_lin_rad_fwd, dtp_lin_rad_plain,
    )

    saved = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        size = torch.finfo(dt).bits // 8
        for site, (plan, heads, broadcast_x, rad, geom, bwd) in sites.items():
            edges, sh32, n_edges, n = geom
            E, sh, hd = edges.dst.shape[0], sh32.to(dt), plan.radial_fold
            unf = DTPLinPlan(plan.tp, plan.head_irreps)  # the same op, w given
            x, _, W, cot, in_bytes = dtp_operands(torch, unf, heads, broadcast_x, E, n, dt, g,
                                                  dev)
            in_bytes -= size * n * plan.d_w  # the folded kernels read h, not w
            in_bytes += size * (n * hd + (hd + 1) * plan.d_w)
            h = torch.randn(E, hd, generator=g, device=dev).to(dt)
            Wr = getattr(rad.net, f"dense{rad.net.n - 1}").weight.detach().t()
            off = rad.offset.detach()
            Wrs = plan.pack_radial(Wr, off + 0.1 * torch.randn(off.shape, generator=g,
                                                               device=dev)).to(dt)
            w = torch.addmm(Wrs[-1], h, Wrs[:-1])  # the unfolded route's cuBLAS w
            shape = f"E={E} d_x={plan.d_x} d_w={plan.d_w} d_out={plan.d_out} hd={hd}"
            tp_elems, macs = dtp_work(plan)
            rad_ops = 2 * n * (hd + 1) * plan.d_w  # one product with [Wr; offset]

            Wr0 = torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])  # [Wr; 0]: a tangent in h
            k, again = (dtp_lin_rad_fwd(plan, x, sh, h, Wrs, W, n_edges) for _ in range(2))
            p = dtp_lin_rad_plain(plan, x, sh, h, Wrs, W, n_edges)
            k0 = dtp_lin_rad_fwd(plan, x, sh, h, Wr0, W, n_edges)
            p0 = dtp_lin_rad_plain(plan, x, sh, h, Wr0, W, n_edges)
            torch.cuda.synchronize()
            if not torch.equal(k, again):
                raise RuntimeError(f"K7-F at {site} {dt_name} repeats no bits")
            ms = cuda_time_ms(lambda: dtp_lin_rad_fwd(plan, x, sh, h, Wrs, W, n_edges), torch)
            plain_ms = cuda_time_ms(lambda: dtp_lin_rad_plain(plan, x, sh, h, Wrs, W, n_edges),
                                    torch)
            pair_ms = cuda_time_ms(lambda: dtp_lin_fwd(
                unf, x, sh, torch.addmm(Wrs[-1], h, Wrs[:-1]), W, n_edges), torch)
            record(records, "dtp_lin_rad_fwd", site, dt_name, shape,
                   [rel_err(k, p), rel_err(k0, p0)], ms, plain_ms, in_bytes + size * E * plan.d_out,
                   n * (2 * macs + 4 * tp_elems) + rad_ops, pair_ms=pair_ms)

            if bwd == "bwd3":
                k7b3_checks(torch, plan, unf, x, sh, h, Wrs, Wr0, w, W, cot, n_edges, n,
                            broadcast_x, site, dt_name, shape, in_bytes, macs, tp_elems,
                            rad_ops, records)
                continue
            call = lambda: dtp_lin_rad_bwd(plan, x, sh, h, Wrs, W, cot, n_edges)  # noqa: E731
            plain = lambda: dtp_lin_rad_bwd_plain(plan, x, sh, h, Wrs, W, cot, n_edges)  # noqa: E731

            def pair():
                dx, dw, dW = dtp_lin_bwd(unf, x, sh, w, W, cot, n_edges)
                return dx, dw @ Wrs[:-1].t(), torch.cat([h, torch.ones_like(h[:, :1])],
                                                        1).t() @ dw, dW

            out_bytes = size * E * (plan.d_x + hd) + 4 * ((hd + 1) * plan.d_w + plan.w_numel)
            k, p = call(), plain()
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(k, p) if a is not None]
            ms = cuda_time_ms(call, torch)
            plain_ms = cuda_time_ms(plain, torch, reps=3, inner=3)
            pair_ms = cuda_time_ms(pair, torch)
            record(records, "dtp_lin_rad_bwd", site, dt_name, shape, errs, ms, plain_ms,
                   in_bytes + size * n * plan.d_out + out_bytes,
                   n * (4 * macs + 10 * tp_elems) + 3 * rad_ops, pair_ms=pair_ms)
    for name, fn in KERNEL_WRAPPERS.items():  # comparison launches do not count
        fn.launches = saved[name]


# K7-B3's output sets (two or three of dx, dsh, dh): the force pass's first
# (no dx at the edge degree, whose x is a constant row), then the parameter
# pass's (dx, dh) and the rest
K7B3_NEEDS = (("x", "sh", "h"), ("x", "h"), ("sh", "h"), ("x", "sh"))


def k7b3_checks(torch, plan, unf, x, sh, h, Wrs, Wr0, w, W, cot, n_edges, n, broadcast_x,
                site, dt_name, shape, in_bytes, macs, tp_elems, rad_ops, records):
    """K7-B3 (``dtp_lin_rad_bwd3``) at one folded site for every output set
    (the force pass's first: its record keeps the site's name), each twice
    for equal bits, the three outputs also with [Wr; 0], against the plain
    version; each timed beside its unfolded pair on the same inputs (cuBLAS
    ``w = h @ Wr + offset``, K5a with the same outputs, cuBLAS ``dh = dw
    Wr^T``).  The bound adds the w build's and dh's products to K5a's
    count."""
    from equiformer_tpu_torch.kernels import dtp_lin_bwd3, dtp_lin_rad_bwd3, dtp_lin_rad_bwd3_plain
    from equiformer_tpu_torch.kernels.dtp_lin_ho import bwd3_occupancy

    dt, size, E, hd = x.dtype, x.element_size(), x.shape[0], plan.radial_fold
    widths = {"x": plan.d_x, "sh": plan.d_sh, "h": hd}
    first = ("sh", "h") if broadcast_x else K7B3_NEEDS[0]
    p = dict(zip(widths, dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wrs, W, cot, n_edges)))
    p0 = dict(zip(widths, dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wr0, W, cot, n_edges)))
    plain_ms = cuda_time_ms(lambda: dtp_lin_rad_bwd3_plain(plan, x, sh, h, Wrs, W, cot, n_edges),
                            torch, reps=3, inner=3)
    for need in (first,) + tuple(nd for nd in K7B3_NEEDS if nd != first):
        flags = {f"need_d{key}": key in need for key in widths}
        call = lambda Wl=Wrs, flags=flags: dtp_lin_rad_bwd3(  # noqa: E731
            plan, x, sh, h, Wl, W, cot, n_edges, **flags)
        k, again = dict(zip(widths, call())), call()
        torch.cuda.synchronize()
        if sorted(key for key, v in k.items() if v is not None) != sorted(need):
            raise RuntimeError(f"K7-B3 at {site} returned other outputs than {need}")
        if not all(torch.equal(k[key], b) for key, b in zip(widths, again) if key in need):
            raise RuntimeError(f"K7-B3 at {site} {dt_name} {need} repeats no bits")
        errs = [rel_err(k[key], p[key]) for key in need]
        if len(need) == 3:  # [Wr; 0]: a tangent in h's slot, the offset read from the operand
            k0 = dict(zip(widths, call(Wr0)))
            errs += [rel_err(k0[key], p0[key]) for key in need]

        def pair(flags=flags):
            dx, dsh, dw = dtp_lin_bwd3(unf, x, sh, torch.addmm(Wrs[-1], h, Wrs[:-1]), W, cot,
                                       n_edges, flags["need_dx"], flags["need_dsh"],
                                       flags["need_dh"])
            return dx, dsh, None if dw is None else dw @ Wrs[:-1].t()

        ms = cuda_time_ms(call, torch)
        pair_ms = cuda_time_ms(pair, torch)
        record(records, "dtp_lin_rad_bwd3",
               site + ("" if need == first else "-" + "".join("d" + key for key in need)),
               dt_name, shape, errs, ms, plain_ms,
               in_bytes + size * n * plan.d_out + size * E * sum(widths[key] for key in need),
               n * (2 * macs + 3 * len(need) * tp_elems) + rad_ops * (1 + ("h" in need)),
               pair_ms=pair_ms)
        occ = bwd3_occupancy(plan, dt, "x" in need, "h" in need, folded=True,
                             need_dsh="sh" in need, x_rows=not broadcast_x)
        occ5 = bwd3_occupancy(unf, dt, "x" in need, "h" in need, need_dsh="sh" in need,
                              x_rows=not broadcast_x)
        print(f"dtp_lin_rad_bwd3 {site} {dt_name} {'/'.join(need)}: {occ} resident blocks per "
              f"SM (K5a: {occ5}), {-(-E // 16)} tiles x {len(plan.groups)} irrep groups")


def fold_sites(pt, make, max_edges, batch, md17_max_edges, md17_batch):
    """The folded call sites of k7_kernel_phase, from fp32 models built with
    the fold: QM9 sep_act (block 0) and the edge degree, MD17 L3 sep_act and
    its edge degree."""
    qm9 = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED, **FOLD)
    l3 = pt.model_entrypoint(MD17_MODEL)(max_edges=md17_max_edges, nodes_per_graph=MD17_SLOTS,
                                         seed=SEED, **FOLD_HO)
    geom, geom17 = batch_geometry(qm9, batch), batch_geometry(l3, md17_batch)
    ga, ga17 = qm9.block_0.ga, l3.block_0.ga
    return {
        "sep_act": (ga.sep_act.plan, [ga.sep_act.lin, ga.sep_alpha], False,
                    ga.sep_act.dtp_rad, geom, "bwd"),
        "edge_deg": (qm9.edge_deg_embed.plan, [qm9.edge_deg_embed.proj], True,
                     qm9.edge_deg_embed.rad, geom, "bwd"),
        "md17-sep_act": (ga17.sep_act.plan, [ga17.sep_act.lin, ga17.sep_alpha], False,
                         ga17.sep_act.dtp_rad, geom17, "bwd3"),
        "md17-edge_deg": (l3.edge_deg_embed.plan, [l3.edge_deg_embed.proj], True,
                          l3.edge_deg_embed.rad, geom17, "bwd3"),
    }


def k7_leg_kernel_phase(torch, sites, dev, records):
    """K7-L (``dtp_lin_rad_leg``: the x, sh and h legs), K7-LW
    (``dtp_lin_rad_legW``) and K7-Wr (``dtp_lin_rad_legWr``) against their
    plain versions at the exp_l3 shapes of one batch, fp32 and bf16 (K7-L
    also with [Wr; 0], as a tangent in h's slot gives it, and twice for
    equal bits), timed as phase 3, each beside the unfolded pair on the same
    inputs: cuBLAS ``w = h @ Wr + offset`` then K5b's leg (for h: K5b's w
    leg, then cuBLAS ``dh = dw Wr^T``) or K5c; for K7-Wr K5b's w leg, then
    cuBLAS ``[h, 1]^T dw``; K7-L's legs run on K2's launch 1 cut by irrep
    group, as K5b's do (K5b's sh leg's resident blocks per SM printed
    beside).  ``sites``: name -> (folded plan, head modules,
    row-broadcast x, radial profile, batch geometry).  Bounds: every operand
    but the leg's own read once over the real edges, the leg written once;
    K5b's or K5c's operations plus 2 * (hd + 1) * d_w per real edge for the
    one product with [Wr; offset] each leg does."""
    from equiformer_tpu_torch.kernels import (
        KERNEL_WRAPPERS, DTPLinPlan, dtp_lin_leg, dtp_lin_legW, dtp_lin_rad_leg,
        dtp_lin_rad_leg_plain, dtp_lin_rad_legW, dtp_lin_rad_legW_plain, dtp_lin_rad_legWr,
        dtp_lin_rad_legWr_plain,
    )
    from equiformer_tpu_torch.kernels.dtp_lin_ho import leg_occupancy

    saved = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        size = torch.finfo(dt).bits // 8
        for site, (plan, heads, broadcast_x, rad, geom) in sites.items():
            edges, sh32, n_edges, n = geom
            E, sh, hd = edges.dst.shape[0], sh32.to(dt), plan.radial_fold
            unf = DTPLinPlan(plan.tp, plan.head_irreps)  # the same op, w given
            x, _, W, cot, _ = dtp_operands(torch, unf, heads, broadcast_x, E, n, dt, g, dev)
            h = torch.randn(E, hd, generator=g, device=dev).to(dt)
            Wr = getattr(rad.net, f"dense{rad.net.n - 1}").weight.detach().t()
            off = rad.offset.detach()
            Wrs = plan.pack_radial(Wr, off + 0.1 * torch.randn(off.shape, generator=g,
                                                               device=dev)).to(dt)
            hx = torch.cat([h, torch.ones_like(h[:, :1])], 1)
            shape = f"E={E} d_x={plan.d_x} d_w={plan.d_w} d_out={plan.d_out} hd={hd}"
            tp_elems, macs = dtp_work(plan)
            ops = n * (2 * macs + 3 * tp_elems) + 2 * n * (hd + 1) * plan.d_w
            op_bytes = {"x": size * (plan.d_x if broadcast_x else n * plan.d_x),
                        "sh": size * n * plan.d_sh, "h": size * n * hd,
                        "Wr": size * (hd + 1) * plan.d_w, "out": size * n * plan.d_out,
                        "W": size * plan.w_numel}
            written = {"x": size * E * plan.d_x, "sh": size * E * plan.d_sh, "h": size * E * hd,
                       "W": 4 * plan.w_numel, "Wr": 4 * (hd + 1) * plan.d_w}
            Wr0 = torch.cat([Wrs[:-1], torch.zeros_like(Wrs[-1:])])  # [Wr; 0]: a tangent in h
            legs = {}  # name: (kernel, (kernel call, plain call, unfolded pair))
            zero_offset = {}  # K7-L's leg: (kernel call, plain call) with [Wr; 0]
            for leg in ("x", "sh", "h"):
                o = {"x": x, "sh": sh, "h": h, leg: None}
                zero_offset[leg] = tuple(
                    lambda o=o, leg=leg, f=f: f(plan, leg, cot, o["x"], o["sh"], o["h"], Wr0, W,
                                                n_edges)
                    for f in (dtp_lin_rad_leg, dtp_lin_rad_leg_plain))
                legs[leg] = ("dtp_lin_rad_leg", (
                    lambda o=o, leg=leg: dtp_lin_rad_leg(plan, leg, cot, o["x"], o["sh"], o["h"],
                                                         Wrs, W, n_edges),
                    lambda o=o, leg=leg: dtp_lin_rad_leg_plain(plan, leg, cot, o["x"], o["sh"],
                                                               o["h"], Wrs, W, n_edges),
                    (lambda: dtp_lin_leg(unf, "w", cot, x, sh, None, W, n_edges) @ Wrs[:-1].t())
                    if leg == "h" else
                    (lambda o=o, leg=leg: dtp_lin_leg(unf, leg, cot, o["x"], o["sh"], torch.addmm(
                        Wrs[-1], h, Wrs[:-1]), W, n_edges))))
            legs["W"] = ("dtp_lin_rad_legW", (
                lambda: dtp_lin_rad_legW(plan, cot, x, sh, h, Wrs, n_edges),
                lambda: dtp_lin_rad_legW_plain(plan, cot, x, sh, h, Wrs, n_edges),
                lambda: dtp_lin_legW(unf, cot, x, sh, torch.addmm(Wrs[-1], h, Wrs[:-1]),
                                     n_edges)))
            legs["Wr"] = ("dtp_lin_rad_legWr", (
                lambda: dtp_lin_rad_legWr(plan, cot, x, sh, h, W, n_edges),
                lambda: dtp_lin_rad_legWr_plain(plan, cot, x, sh, h, W, n_edges),
                lambda: hx.t() @ dtp_lin_leg(unf, "w", cot, x, sh, None, W, n_edges)))
            for leg, (kernel, (call, plain, pair)) in legs.items():
                k, p = call(), plain()
                errs = [rel_err(k, p)]
                if leg in zero_offset:
                    again = call()
                    torch.cuda.synchronize()
                    if not torch.equal(k, again):
                        raise RuntimeError(f"K7-L's {leg} leg at {site} {dt_name} repeats no bits")
                    errs.append(rel_err(*(f() for f in zero_offset[leg])))
                torch.cuda.synchronize()
                ms = cuda_time_ms(call, torch)
                plain_ms = cuda_time_ms(plain, torch, reps=3, inner=3)
                pair_ms = cuda_time_ms(pair, torch)
                nbytes = sum(v for key, v in op_bytes.items() if key != leg) + written[leg]
                record(records, kernel, f"md17-{site}-{leg}", dt_name, shape, errs, ms, plain_ms,
                       nbytes, ops, pair_ms=pair_ms)
                sh_occ = (f" (K5b's sh leg: {leg_occupancy(unf, dt)} resident blocks per SM)"
                          if leg == "sh" else "")
                print(f"{kernel} {leg} {site} {dt_name}: runs on K2's launches, as the unfolded "
                      f"leg does{sh_occ}")
    for name, fn in KERNEL_WRAPPERS.items():  # comparison launches do not count
        fn.launches = saved[name]


def fold_leg_sites(pt, md17_max_edges, md17_batch):
    """The folded sites of k7_leg_kernel_phase, from an fp32 exp_l3 model
    built with the fold: sep_act (block 0) and the edge degree."""
    l3 = pt.model_entrypoint(MD17_MODEL)(max_edges=md17_max_edges, nodes_per_graph=MD17_SLOTS,
                                         seed=SEED, **FOLD_HO)
    geom, ga = batch_geometry(l3, md17_batch), l3.block_0.ga
    return {"sep_act": (ga.sep_act.plan, [ga.sep_act.lin, ga.sep_alpha], False,
                        ga.sep_act.dtp_rad, geom),
            "edge_deg": (l3.edge_deg_embed.plan, [l3.edge_deg_embed.proj], True,
                         l3.edge_deg_embed.rad, geom)}


def route_eval_phase(pt, torch, make, max_edges, gpu_batches, dev, out, tag="fold", route=FOLD,
                     expected=EXPECTED_FOLD_EVAL):
    """The QM9 eval forward on another route (the radial fold, the kron
    route), bf16 and fp32: launch counts of one forward, finite predictions,
    eval graphs/s (median of 3 passes over the batches), peak memory, and
    batch 0's predictions against the same-seed model on the fused route on
    the card (1e-5 of the largest in fp32: the same function, summed in
    another order; the bf16 tolerance of phase 2)."""
    for name in ("bfloat16", "float32"):
        kw = dict(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED,
                  compute_dtype=None if name == "float32" else name)
        model = make(**kw, **route).eval()
        r, launches = counted(torch, lambda: pt.evaluate(model, gpu_batches[0]))
        print(f"{tag} eval {name}: launches in one forward: {launches}")
        if launches != expected:
            raise RuntimeError(f"launch counts {launches} != expected {expected}")
        out[f"{tag}_eval_launches"] = launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            results = [pt.evaluate(model, b) for b in gpu_batches]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        if not all(x["pred"].shape == (BATCH,) and bool(x["pred"].isfinite().all())
                   for x in results):
            raise RuntimeError(f"{tag} eval {name}: bad predictions")
        fused = pt.evaluate(make(**kw).eval(), gpu_batches[0])["pred"].float()
        pred = results[0]["pred"].float()
        rel = float((pred - fused).abs().max()) / max(float(fused.abs().max()), 1.0)
        tol = 1e-5 if name == "float32" else CPU_RTOL[name]
        gps = BATCH * len(gpu_batches) / statistics.median(times)
        out[f"{tag}_eval_{name}"] = gps
        out[f"{tag}_eval_{name}_peak_mib"] = peak
        print(f"{tag} eval {name}: {gps:.1f} graphs/s at batch {BATCH} (median of 3 passes over "
              f"{len(gpu_batches)} batches; pass seconds {[round(t, 4) for t in times]}), peak "
              f"memory {peak:.0f} MiB; predictions vs the fused route on the card: rel "
              f"{rel:.3e} (bound {tol:.0e})", flush=True)
        if not rel <= tol:
            raise RuntimeError(f"{tag} eval {name}: predictions disagree with the fused route")
        del model


def k8_kernel_phase(torch, model, batch, dev, records):
    """K8-F (twice for equal bits) and K8-B against their plain versions at
    the three sites of a kron model (batch 0's shapes, n_edges below E),
    fp32 and bf16, timed as
    phase 3, each beside K1 or K2 on the same inputs (W in place of G).
    Bounds: x, sh, w and G read once over the real edges, the outputs
    written once (dG in fp32); 2 operations per G element and real edge
    forward and 4 backward, Kop's products (2 per Kop column and real edge,
    1 with a shared w in G) and the backward's per-column updates of dx and
    dw (5, or 3)."""
    from equiformer_tpu_torch.kernels import (
        KERNEL_WRAPPERS, dtp_lin_bwd, dtp_lin_fwd, dtp_lin_kron_bwd, dtp_lin_kron_bwd_plain,
        dtp_lin_kron_fwd, dtp_lin_kron_plain, kron_meta,
    )

    saved = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    edges, sh32, n_edges, n = batch_geometry(model, batch)
    E = edges.dst.shape[0]
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        size = torch.finfo(dt).bits // 8
        sh = sh32.to(dt)
        for site, (plan, heads, broadcast_x) in dtp_sites(model).items():
            meta = kron_meta(plan)
            x, w, W, cot, in_bytes = dtp_operands(torch, plan, heads, broadcast_x, E, n, dt, g,
                                                  dev)
            G = meta.build_G(W)
            in_bytes += size * (meta.numel - plan.w_numel)  # the kernels read G, not W
            shape = (f"E={E} d_x={plan.d_x} d_w={plan.d_w} d_out={plan.d_out} "
                     f"G={meta.numel} rows={meta.n_rows}")
            kop_ops = (1 if w is None else 2) * meta.n_rows

            k, again = (dtp_lin_kron_fwd(meta, x, sh, w, G, n_edges) for _ in range(2))
            p = dtp_lin_kron_plain(meta, x, sh, w, G, n_edges)
            torch.cuda.synchronize()
            if not torch.equal(k, again):
                raise RuntimeError(f"K8-F at {site} {dt_name} repeats no bits")
            ms = cuda_time_ms(lambda: dtp_lin_kron_fwd(meta, x, sh, w, G, n_edges), torch)
            plain_ms = cuda_time_ms(lambda: dtp_lin_kron_plain(meta, x, sh, w, G, n_edges), torch,
                                    reps=3, inner=3)
            k1_ms = cuda_time_ms(lambda: dtp_lin_fwd(plan, x, sh, w, W, n_edges), torch)
            record(records, "dtp_lin_kron_fwd", site, dt_name, shape, [rel_err(k, p)], ms,
                   plain_ms, in_bytes + size * E * plan.d_out, n * (2 * meta.numel + kop_ops),
                   pair_ms=k1_ms, pair="K1")

            k = dtp_lin_kron_bwd(meta, x, sh, w, G, cot, n_edges)
            p = dtp_lin_kron_bwd_plain(meta, x, sh, w, G, cot, n_edges)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(k, p) if a is not None]
            ms = cuda_time_ms(lambda: dtp_lin_kron_bwd(meta, x, sh, w, G, cot, n_edges), torch)
            plain_ms = cuda_time_ms(
                lambda: dtp_lin_kron_bwd_plain(meta, x, sh, w, G, cot, n_edges), torch, reps=3,
                inner=3)
            k2_ms = cuda_time_ms(lambda: dtp_lin_bwd(plan, x, sh, w, W, cot, n_edges), torch)
            out_bytes = size * E * (plan.d_x + (0 if w is None else plan.d_w)) + 4 * meta.numel
            record(records, "dtp_lin_kron_bwd", site, dt_name, shape, errs, ms, plain_ms,
                   in_bytes + size * n * plan.d_out + out_bytes,
                   n * (4 * meta.numel + kop_ops + (3 if w is None else 5) * meta.n_rows),
                   pair_ms=k2_ms, pair="K2")
    for name, fn in KERNEL_WRAPPERS.items():  # comparison launches do not count
        fn.launches = saved[name]


def first_steps_bitwise(pt, torch, make, max_edges, batch, route, tag):
    """Two models from one seed on ``route`` take one training step each on
    the same batch with the same injected dropout masks, in bf16 and fp32:
    the metrics and every updated parameter must be the same bits."""
    for name in ("bfloat16", "float32"):
        res = []
        for _ in range(2):
            model = make(**with_route(route, max_edges=max_edges, nodes_per_graph=SLOTS,
                                      seed=SEED, compute_dtype=None if name == "float32"
                                      else name))
            keep = [torch.rand(max_edges, model.block_0.ga.num_heads,
                               generator=torch.Generator().manual_seed(SEED + 9 + i)) < 0.8
                    for i in range(model.num_layers)]
            step, state = train_setup(pt, model)
            _, m = step(state, batch, iter(keep))
            torch.cuda.synchronize()
            res.append(({k: float(v) for k, v in m.items()},
                        [p.detach().clone() for p in model.parameters()]))
            del model, state
        (m1, p1), (m2, p2) = res
        same = m1 == m2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
        print(f"{tag} {name}: two first steps from one seed bitwise equal: {same} "
              f"(loss {m1['loss']:.6f} / {m2['loss']:.6f})", flush=True)
        if not same:
            raise RuntimeError(f"{tag} {name}: two first steps from one seed differ in their bits")


def kron_fold_override(pt, torch, make, max_edges, gpu_batches):
    """A model built with ``kron_g`` and ``radial_fold`` warns that the kron
    route wins, and its eval forward launches the kron route's kernels and
    no K7."""
    import warnings

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED,
                     compute_dtype="bfloat16", **KRON, **FOLD).eval()
    n_warn = sum("kron_g overrides radial_fold" in str(r.message) for r in rec)
    r, launches = counted(torch, lambda: pt.evaluate(model, gpu_batches[0]))
    print(f"kron + radial_fold: {n_warn} warnings (one per per-edge-weight site); launches in "
          f"one forward: {launches}", flush=True)
    if n_warn != 7 or launches != EXPECTED_KRON_EVAL or not bool(r["pred"].isfinite().all()):
        raise RuntimeError(f"kron_g with radial_fold: {n_warn} warnings (7 expected), launch "
                           f"counts {launches} != {EXPECTED_KRON_EVAL} or bad predictions")


def measure_tools(torch, out):
    """Each tool's ``main`` at its default sizes (its own printout
    dropped), with the launch counts set to 0 just before it and read just
    after; prints the measured peaks and K2's stage times.  Returns the
    tools' reports."""
    import contextlib
    import io

    from equiformer_tpu_torch.tools import bwd_attr, chip_peaks, kbench

    mains = {"chip_peaks": chip_peaks.main, "kbench": kbench.main, "kbench-fp32": kbench.main,
             "bwd_attr": bwd_attr.main}
    reports, total = {}, dict.fromkeys(MEASURE_KERNELS, 0)
    for tool, argv in MEASURE_TOOLS.items():
        with contextlib.redirect_stdout(io.StringIO()):
            reports[tool], launches = counted(torch, lambda: mains[tool](argv))
        mine = {k: launches[k] for k in MEASURE_KERNELS}
        print(f"measure {tool} {' '.join(argv)}: launches {mine}", flush=True)
        for k in MEASURE_KERNELS:
            total[k] += launches[k]
        for k, owner in MEASURE_KERNELS.items():
            if tool == owner and launches[k] == 0:
                raise RuntimeError(f"{tool} launched no {k}")
    out["measure_launches"] = total

    peaks = reports["chip_peaks"]
    for r in peaks["fma"]:
        print(f"peak CUDA-core FMA {r['dtype']:8s} {r['shape']} x K{r['k']}: "
              f"{r['tflops']:.2f} TFLOP/s ({r['ms']:.4f} ms)")
    for r in peaks["hbm"]:
        print(f"peak HBM stream {r['mb']} MB bf16 (read + write): {r['gb_per_s']:.1f} GB/s")
    for r in peaks["tensor_cores"]:
        print(f"peak bf16 matmul {r['n']}: {r['tflops']:.1f} TFLOP/s")
    for r in peaks["dtp_t_floor"]:
        print(f"peak S1-F stream {r['dtype']}: {r['gb_per_s']:.1f} GB/s")
    print(f"published: {HBM_BYTES_PER_S / 1e9:.0f} GB/s, {PEAK_FLOPS['float32'] / 1e12:.0f} "
          f"TFLOP/s fp32, {PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s bf16 (tensor cores), "
          f"{CUDA_CORE_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s bf16 (CUDA cores, __hfma2: the "
          f"bound of {', '.join(CUDA_CORE_KERNELS)})")
    for tool in ("kbench", "kbench-fp32"):
        rep = reports[tool]
        print(f"{tool} {rep['dtype']} E={rep['edges']}: " + ", ".join(
            f"{k} {v['ms']:.4f} ms ({v['gb_per_s']:.0f} GB/s)" for k, v in rep["variants"].items()))
        fl = rep["variants"]["fusedlin"]
        print(f"{tool} {rep['dtype']}: S1-P (fusedlin, K1) bound {fl['bound_ms']:.4f} ms "
              f"({fl['bound_by']})")
    s3 = reports["bwd_attr"]
    for name, rows in s3["times"].items():
        print(f"K2 by stage, QM9 sep_act, {s3['edges']} real edges, {name}: " + ", ".join(
            f"{r['name']} {r['ms']:.4f} ms ({r['delta_ms']:+.4f})" for r in rows), flush=True)
    return reports


def measure_kernel_phase(torch, model, batch, dev, records):
    """The four measurement kernels against their plain versions on the
    same inputs, fp32 and bf16, timed as phase 3 (no PyTorch call computes
    their functions): the probe at chip_peaks' shapes, the floor and the
    staged T at kbench's, the staged K2 at the QM9 sep_act site."""
    from equiformer_tpu_torch.kernels import (
        KERNEL_WRAPPERS, TermList, dtp_lin_bwd, dtp_lin_bwd_stage, dtp_lin_bwd_stage_plain,
        dtp_t, dtp_t_floor, dtp_t_floor_plain, dtp_t_staged, dtp_t_staged_plain, fma_probe,
        fma_probe_plain, make_layouts,
    )
    from equiformer_tpu_torch.kernels.dtp_lin import DXDW_STAGE, FULL_STAGE
    from equiformer_tpu_torch.kernels.peaks import fma_probe_first
    from equiformer_tpu_torch.tools.chip_peaks import FMA_SHAPES
    from equiformer_tpu_torch.tools.kbench import flagship_tp

    saved = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    tp = flagship_tp()
    tl = TermList.for_plan(tp, fold_rescale=True)
    z_slots = make_layouts(tp)[4]
    E_kb = KBENCH_EDGES
    plan, heads, _ = dtp_sites(model)["sep_act"]
    edges, sh32, n_edges, n = batch_geometry(model, batch)
    E = edges.dst.shape[0]
    tp_elems, macs = dtp_work(plan)
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        size = torch.finfo(dt).bits // 8
        for variant, t, width, k in FMA_SHAPES:
            x = (1.0 + 0.1 * torch.randn(FMA_GRID * t, width, generator=g, device=dev)).to(dt)
            got, want = fma_probe(x, k), fma_probe_plain(x, k)
            torch.cuda.synchronize()
            record(records, "fma_probe", variant, dt_name, f"[{FMA_GRID * t}, {width}] x K{k}",
                   [rel_err(got, want)], cuda_time_ms(lambda: fma_probe(x, k), torch),
                   cuda_time_ms(lambda: fma_probe_plain(x, k), torch, reps=3, inner=3),
                   2 * size * x.numel(), 2 * k * x.numel(), tol=FMA_TOL[dt_name])
            first = fma_probe_first(x, k)
            same = torch.equal(got, first)
            print(f"fma_probe {dt_name} {variant}: bitwise equal to the first design: {same}; "
                  f"first design {cuda_time_ms(lambda: fma_probe_first(x, k), torch):.4f} ms",
                  flush=True)
            if not same:
                raise RuntimeError(f"fma_probe {dt_name} {variant}: the kernel differs from the "
                                   f"first design in its bits")

        x, sh, w = (torch.randn(E_kb, d, generator=g, device=dev).to(dt)
                    for d in (tl.d_a, tl.d_col, tl.d_b))
        in_bytes = size * E_kb * (tl.d_a + tl.d_col + tl.d_b)
        shape = f"E={E_kb} d_x={tl.d_a} d_w={tl.d_b} d_z={tl.d_out}"
        got, want = dtp_t_floor(x, sh, w, tl.d_out), dtp_t_floor_plain(x, sh, w, tl.d_out)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"dtp_t_floor {dt_name} differs from its plain version")
        record(records, "dtp_t_floor", "kbench", dt_name, shape, [rel_err(got, want)],
               cuda_time_ms(lambda: dtp_t_floor(x, sh, w, tl.d_out), torch),
               cuda_time_ms(lambda: dtp_t_floor_plain(x, sh, w, tl.d_out), torch),
               in_bytes + size * E_kb * tl.d_out, 2 * E_kb * 128)
        for layout, slots in (("kbench-dense", None), ("kbench-slots", z_slots)):
            got, want = dtp_t_staged(tl, x, sh, w, slots), dtp_t_staged_plain(tl, x, sh, w, slots)
            torch.cuda.synchronize()
            record(records, "dtp_t_staged", layout, dt_name, f"{shape} d_out={got.shape[1]}",
                   [rel_err(got, want)],
                   cuda_time_ms(lambda: dtp_t_staged(tl, x, sh, w, slots), torch),
                   cuda_time_ms(lambda: dtp_t_staged_plain(tl, x, sh, w, slots), torch, reps=3,
                                inner=3),
                   in_bytes + size * E_kb * got.shape[1],
                   3 * E_kb * sum(t.mul for t in tl.terms))
        same = torch.equal(dtp_t_staged(tl, x, sh, w), dtp_t(tl, x, sh, w))
        print(f"dtp_t_staged {dt_name} dense bitwise equal to K6-T: {same}", flush=True)
        print(f"S1-A beside K6-T at kbench's shapes ({shape}), {dt_name}: S1-A dense "
              f"{records[-2]['ms']:.4f} ms, slots {records[-1]['ms']:.4f} ms; K6-T "
              f"{cuda_time_ms(lambda: dtp_t(tl, x, sh, w), torch):.4f} ms", flush=True)
        if not same:
            raise RuntimeError(f"dtp_t_staged {dt_name} (dense) differs from K6-T in its bits")

        x, w, W, cot, in_bytes = dtp_operands(torch, plan, heads, False, E, n, dt, g, dev)
        sh = sh32.to(dt)
        ref = dtp_lin_bwd(plan, x, sh, w, W, cot, n_edges)
        for stage in range(FULL_STAGE + 1):
            got = dtp_lin_bwd_stage(plan, x, sh, w, W, cot, stage, n_edges)
            torch.cuda.synchronize()
            if stage == FULL_STAGE:
                ok = all(torch.equal(a, b) for a, b in zip(got, ref))
            elif stage >= DXDW_STAGE:
                ok = (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                      and float(got[2].abs().max()) == 0.0)
            else:
                ok = all(float(t.abs().max()) == 0.0 for t in got)
            print(f"dtp_lin_bwd_stage {dt_name} stage {stage}: "
                  + ("bitwise equal to dtp_lin_bwd" if stage == FULL_STAGE else
                     ("dx, dw K2's bits" if stage >= DXDW_STAGE else "dx = dw = 0")
                     + ", dW = 0") + f": {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"dtp_lin_bwd_stage {dt_name} stage {stage} is not as K2")
        want = dtp_lin_bwd_stage_plain(plan, x, sh, w, W, cot, FULL_STAGE, n_edges)
        out_bytes = size * E * (plan.d_x + plan.d_w) + 4 * plan.w_numel
        record(records, "dtp_lin_bwd_stage", "sep_act", dt_name,
               f"E={E} d_x={plan.d_x} d_w={plan.d_w} d_out={plan.d_out} stage {FULL_STAGE}",
               [rel_err(a, b) for a, b in zip(got, want)],
               cuda_time_ms(lambda: dtp_lin_bwd_stage(plan, x, sh, w, W, cot, FULL_STAGE,
                                                      n_edges), torch),
               cuda_time_ms(lambda: dtp_lin_bwd_stage_plain(plan, x, sh, w, W, cot, FULL_STAGE,
                                                            n_edges), torch, reps=3, inner=3),
               in_bytes + size * n * plan.d_out + out_bytes, n * (4 * macs + 10 * tp_elems))
    for name, fn in KERNEL_WRAPPERS.items():  # comparison launches do not count
        fn.launches = saved[name]


# The training CLIs (phase 23), each driven through its ``main`` as a user
# runs it: the QM9 CLI's steps are phase 22's rematted step (the e3 and the
# bessel entrypoints too: parity and basis change no launch), its eval
# forward phase 2's; the attention head adds one GraphAttention, not
# rematted, at the 512x0e feature: its per-edge-w sep_act site and its
# shared-weight sep_value site launch what a block's two sites launch in a
# force training step (K1 4 + 3, K5a 2 + 1, K5b 4 + 2, K5c 4 + 3) and its
# attention sum and two message gathers 6 K3, as a block's.  DeNS has no
# remat (phase 21's step).
CLI_QM9_MODEL = "graph_attention_transformer_nonlinear_l2"
CLI_BESSEL_MODEL = "graph_attention_transformer_nonlinear_bessel_l2"
CLI_E3_MODEL = "graph_attention_transformer_nonlinear_l2_e3"
CLI_ATTN_MODEL = "graph_attention_transformer_nonlinear_attn_exp_l3_md17"
CLI_E3_MD17_MODEL = "graph_attention_transformer_nonlinear_exp_l3_e3_md17"
CLI_DENS_YML = "configs/md17_dens/equiformer_dens_l3.yml"
EXPECTED_ATTN_MD17_TRAIN = {**EXPECTED_REMAT_MD17_TRAIN, "dtp_lin_fwd": 69 + 7,
                            "dtp_lin_bwd3": 20 + 3, "dtp_lin_leg": 39 + 6,
                            "dtp_lin_legW": 45 + 7, "csr_segment_sum": 50 + 6}
CLI_DIR = ROOT / "build" / "cli_smoke"


def cli_run(torch, card, module, maker_name, argv, tag):
    """``module.main`` (a training CLI) on ``argv`` with every launch count
    set to 0 just before and read just after; ``module.<maker_name>`` (the
    step maker it calls) wrapped so that each train step's launches are
    read too.  Returns (the CLI's state, each step's counts, the run's
    counts, its epoch log lines)."""
    from equiformer_tpu_torch.kernels import launch_counts, reset_launch_counts

    per_step = []
    maker = getattr(module, maker_name)

    def counting_maker(*a, **kw):
        step, eval_step = maker(*a, **kw)

        def counted_step(*sa):
            before = launch_counts()
            result = step(*sa)
            after = launch_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            return result
        return counted_step, eval_step

    args = module.get_args(argv)
    setattr(module, maker_name, counting_maker)
    try:
        t = time.time()
        reset_launch_counts()
        state = module.main(args)
        torch.cuda.synchronize()
        total = launch_counts()
    finally:
        setattr(module, maker_name, maker)
    lines = [ln for ln in (Path(args.output_dir) / "debug.log").read_text().splitlines()
             if " epoch " in f" {ln.split(' - ', 1)[-1]}"]
    print(f"{card}: cli {tag}: {len(per_step)} steps in {time.time() - t:.1f} s", flush=True)
    for ln in lines:
        print(f"{card}: cli {tag}: {ln.split(' - ', 1)[-1]}", flush=True)
    return state, per_step, total, lines


def check_steps(per_step, expected, n, tag):
    if len(per_step) != n:
        raise RuntimeError(f"cli {tag}: {len(per_step)} steps, expected {n}")
    for i, c in enumerate(per_step):
        if c != expected:
            diff = {k: (c[k], expected[k]) for k in c if c[k] != expected[k]}
            raise RuntimeError(f"cli {tag} step {i}: launch counts (got, expected) {diff}")
    print(f"{CARD}: cli {tag}: launches a step "
          f"{ {k: v for k, v in per_step[0].items() if v} }", flush=True)


def check_outputs(state, outdir, files, tag):
    written = sorted(p.name for p in Path(outdir).glob("*.npz"))
    if written != sorted(files):
        raise RuntimeError(f"cli {tag}: wrote {written}, expected {sorted(files)}")
    if not all(bool(p.isfinite().all()) for p in state.model.parameters()):
        raise RuntimeError(f"cli {tag}: non-finite parameters")


def graphs_per_s(lines, tag):
    import re

    rates = [float(m.group(1)) for m in (re.search(r"([0-9.]+) graphs/s", ln) for ln in lines)
             if m]
    if not rates or not all(r > 0 for r in rates):
        raise RuntimeError(f"cli {tag}: no graphs/s in the epoch lines {lines}")
    return rates


def head_sites(model):
    """The attention head's per-edge-w call site (``dtp_sites``' layout)."""
    ga = model.attn_head
    return {"sep_act": (ga.sep_act.plan, [ga.sep_act.lin, ga.sep_alpha], False)}


def cli_phase(pt, torch, dev, card, out):
    """Phase 23: the QM9 and MD17 training CLIs on the card, through their
    ``main``s, and ``compute_stats``."""
    import shutil

    from equiformer_tpu_torch import native
    from equiformer_tpu_torch.cli import compute_stats as cs, train_md17, train_qm9
    from equiformer_tpu_torch.data import GraphLoader, compute_stats, load_md17, qm9_like_dataset
    from equiformer_tpu_torch.data.qm9 import load_qm9
    from equiformer_tpu_torch.graph.batching import cli_capacities

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    qm9_root = shutil.copytree(ROOT / "tests" / "fixtures" / "qm9_raw", CLI_DIR / "qm9")
    md17_root = shutil.copytree(ROOT / "tests" / "fixtures" / "md17_raw", CLI_DIR / "md17")
    records = []

    # 1. the QM9 CLI's defaults on synthetic molecules: 4 steps, val, test
    d = CLI_DIR / "qm9_synthetic"
    state, steps, total, lines = cli_run(torch, card, train_qm9, "make_qm9_steps", [
        "--synthetic", "--epochs", "1", "--output-dir", str(d)], "qm9")
    check_steps(steps, EXPECTED_REMAT_TRAIN, 4, "qm9")
    want = {k: 4 * EXPECTED_REMAT_TRAIN[k] + 2 * EXPECTED_EVAL[k] for k in total}
    if total != want:
        raise RuntimeError(f"cli qm9: the run launched {total}, expected {want}")
    check_outputs(state, d, ["best_val.npz", "best_test.npz", "final.npz"], "qm9")
    out["cli_qm9_graphs_per_s"] = graphs_per_s(lines, "qm9")[0]
    out["cli_qm9_launches"] = steps[0]
    nodes, edges = cli_capacities(CPU_GRAPHS, 30, QM9_EDGES_PER_NODE)
    batch = next(iter(GraphLoader(qm9_like_dataset(512, seed=1)[:CPU_GRAPHS], CPU_GRAPHS,
                                  nodes, shuffle=False)))
    cpu = pt.model_entrypoint(CLI_QM9_MODEL)(max_edges=edges, compute_dtype="bfloat16",
                                             device="cpu")
    pt.load_params(str(d / "final.npz"), cpu)
    with torch.no_grad():
        got = state.model.eval()(batch.to(dev)).cpu()
        ref = cpu.eval()(batch)
    err, rel = rel_err(got, ref)
    print(f"{card}: cli qm9: final.npz on the CPU vs the card, {CPU_GRAPHS} graphs bfloat16: "
          f"max_abs_err {err:.3e} (rel {rel:.3e}, limit {CPU_RTOL['bfloat16']})", flush=True)
    if not rel <= CPU_RTOL["bfloat16"]:
        raise RuntimeError("cli qm9: final.npz on the CPU disagrees with the card")
    del state, cpu

    # 2. the real QM9 parse path (the fixture: 11 molecules, all in train)
    d = CLI_DIR / "qm9_fixture"
    state, steps, _, lines = cli_run(torch, card, train_qm9, "make_qm9_steps", [
        "--data-path", str(qm9_root), "--batch-size", "4", "--eval-interval", "2",
        "--epochs", "1", "--model-name", CLI_BESSEL_MODEL, "--output-dir", str(d)], "bessel")
    check_steps(steps, EXPECTED_REMAT_TRAIN, 2, "bessel")
    check_outputs(state, d, ["final.npz"], "bessel")
    if len(load_qm9(str(qm9_root))[0]) != 11:
        raise RuntimeError("cli bessel: the fixture did not parse into 11 molecules")
    del state

    # 3. the e3 entrypoint at full width: its step, K1 and K2 at its sep_act site
    d = CLI_DIR / "qm9_e3"
    state, steps, _, lines = cli_run(torch, card, train_qm9, "make_qm9_steps", [
        "--synthetic", "--epochs", "1", "--eval-interval", "2", "--model-name", CLI_E3_MODEL,
        "--output-dir", str(d)], "e3")
    check_steps(steps, EXPECTED_REMAT_TRAIN, 4, "e3")
    check_outputs(state, d, ["final.npz"], "e3")
    out["cli_e3_graphs_per_s"] = graphs_per_s(lines, "e3")[0]
    out["cli_e3_launches"] = steps[0]
    nodes, _ = cli_capacities(BATCH, 30, QM9_EDGES_PER_NODE)
    batch = next(iter(GraphLoader(qm9_like_dataset(512, seed=1), BATCH, nodes,
                                  shuffle=False))).to(dev)
    sites = {"sep_act": dtp_sites(state.model)["sep_act"]}
    if "0o" not in str(state.model.block_0.ga.sep_act.dtp.irreps_out):
        raise RuntimeError("cli e3: the sep_act site holds no odd parity")
    kernel_phase(torch, state.model, batch, dev, records, sites, "e3-", dtp_only=True)
    md17_records = []
    del state

    # 4. MD17 on the fixture: the attention head's force training steps, its
    # sep_act site's K1, K5a, K5b and K5c
    d = CLI_DIR / "md17_attn"
    state, steps, _, lines = cli_run(torch, card, train_md17, "make_md17_steps", [
        "--data-path", str(md17_root), "--train-size", "16", "--val-size", "8",
        "--epochs", "1", "--model-name", CLI_ATTN_MODEL, "--output-dir", str(d)], "attn")
    check_steps(steps, EXPECTED_ATTN_MD17_TRAIN, 2, "attn")
    check_outputs(state, d, ["best_val.npz", "best_test.npz", "final.npz"], "attn")
    out["cli_attn_launches"] = steps[0]
    nodes, _ = cli_capacities(MD17_BATCH, MD17_SLOTS, MD17_SLOTS + 1)
    train = load_md17(str(md17_root), "aspirin", "train", 16, 8)[0]
    batch = next(iter(GraphLoader(train, MD17_BATCH, nodes, shuffle=False,
                                  with_forces=True))).to(dev)
    md17_kernel_phase(torch, state.model, batch, dev, md17_records, head_sites(state.model),
                      "attn-", dtp_only=True)
    md17_train_kernel_phase(torch, state.model, batch, dev, md17_records,
                            head_sites(state.model), "attn-")
    del state

    # 5. one exp_l3_e3 force training step, K1, K5a, K5b, K5c at its sep_act site
    d = CLI_DIR / "md17_e3"
    state, steps, _, lines = cli_run(torch, card, train_md17, "make_md17_steps", [
        "--data-path", str(md17_root), "--train-size", "8", "--val-size", "8",
        "--epochs", "1", "--eval-interval", "2", "--model-name", CLI_E3_MD17_MODEL,
        "--output-dir", str(d)], "e3_md17")
    check_steps(steps, EXPECTED_REMAT_MD17_TRAIN, 1, "e3_md17")
    check_outputs(state, d, ["final.npz"], "e3_md17")
    out["cli_e3_md17_launches"] = steps[0]
    sites = {"sep_act": dtp_sites(state.model)["sep_act"]}
    md17_kernel_phase(torch, state.model, batch, dev, md17_records, sites, "e3md17-",
                      dtp_only=True)
    md17_train_kernel_phase(torch, state.model, batch, dev, md17_records, sites, "e3md17-")
    del state
    report_kernels(md17_records)

    # 6. DeNS through --config-yml (the port's YAML reader), dp_weight decayed per epoch
    d = CLI_DIR / "dens"
    state, steps, _, lines = cli_run(torch, card, train_md17, "make_dens_steps", [
        "--use-dens", "--config-yml", str(ROOT / CLI_DENS_YML),
        "--use-denoising-pos-weight-linear-decay", "--data-path", str(md17_root),
        "--train-size", "8", "--val-size", "8", "--epochs", "2", "--eval-interval", "2",
        "--output-dir", str(d)], "dens")
    check_steps(steps, EXPECTED_DENS_TRAIN, 2, "dens")
    check_outputs(state, d, ["best_val.npz", "best_test.npz", "final.npz"], "dens")
    weights = [ln.split("dp_weight ")[1] for ln in lines if "dp_weight" in ln]
    if weights != ["1.000000", "0.500000"]:
        raise RuntimeError(f"cli dens: dp_weight per epoch {weights}, expected 1.0 and 0.5")
    del state

    # 7. compute_stats: the native radius_stats against numpy's compute_stats
    if not native.HAVE_NATIVE:
        raise RuntimeError("compute_stats: no native library (no C++ compiler)")
    got = cs.main(cs.get_args(["--dataset", "md17", "--data-path", str(md17_root)]))
    graphs = load_md17(str(md17_root), "aspirin", "train")[0]
    want = {k: round(float(v), 6) for k, v in compute_stats(graphs, 5.0).items()}
    print(f"{CARD}: compute_stats md17 fixture: native {got}, numpy {want}", flush=True)
    if got != want:
        raise RuntimeError("compute_stats: the native radius_stats differ from numpy's")
    return records + md17_records


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
    from equiformer_tpu_torch.data import GraphLoader, md17_like_dataset, qm9_like_dataset
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
    batches = list(GraphLoader(data, BATCH, dense_slots=SLOTS, shuffle=False))
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
    t = time.time()
    md17_model, md17_batches, md17_max_edges, md17_ref = md17_phase(pt, torch, dev, out)
    print(f"md17 phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_records = []
    md17_kernel_phase(torch, md17_model, md17_batches[0], dev, md17_records)
    report_kernels(md17_records)
    print(f"md17 kernel phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_train_records = []
    md17_train_kernel_phase(torch, md17_model, md17_batches[0], dev, md17_train_records)
    report_kernels(md17_train_records)
    del md17_model
    print(f"md17 train kernel phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_train_phase(pt, torch, md17_max_edges, md17_batches, dev, out)
    print(f"md17 train phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_step64 = md17_train_vs_cpu(pt, torch, dev)
    print(f"md17 train vs CPU phase: {time.time() - t:.1f} s", flush=True)

    # DeNS training (the aspirin L3 recipe) on the force kernels
    t = time.time()
    dens_train_phase(pt, torch, md17_batches, dev, out)
    print(f"dens train phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    dens_vs_cpu(pt, torch, dev)
    print(f"dens vs CPU phase: {time.time() - t:.1f} s", flush=True)

    # the packed layout (collate, the [N, N] radius graph) at the CLIs' capacities
    t = time.time()
    packed_qm9_phase(pt, torch, make, data, counts, max_edges, gpu_batches, dev, out)
    print(f"packed QM9 phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    packed_md17_phase(pt, torch, md17_batches, md17_max_edges, md17_step64, dev, out)
    print(f"packed md17 phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    packed_dens_phase(pt, torch, md17_batches, dev, out)
    print(f"packed dens phase: {time.time() - t:.1f} s", flush=True)

    # the CLIs' recipe: remat, task statistics, a binding clip, checkpoints
    t = time.time()
    recipe_phase(pt, torch, make, data, md17_like_dataset(MD17_BATCH * N_BATCHES,
                                                          num_atoms=MD17_SLOTS, seed=SEED),
                 dev, out)
    print(f"recipe phase: {time.time() - t:.1f} s", flush=True)

    # the training CLIs through their mains, and compute_stats
    t = time.time()
    cli_records = cli_phase(pt, torch, dev, card, out)
    print(f"{card}: cli phase: {time.time() - t:.1f} s", flush=True)

    # the radial fold (K7): kernels, QM9 eval and training, MD17 forces
    t = time.time()
    k7_records = []
    k7_kernel_phase(torch, fold_sites(pt, make, max_edges, gpu_batches[0], md17_max_edges,
                                      md17_batches[0]), dev, k7_records)
    report_kernels(k7_records)
    print(f"K7 kernel phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    route_eval_phase(pt, torch, make, max_edges, gpu_batches, dev, out)
    train_phase(pt, torch, make, max_edges, gpu_batches, dev, out, "fold_train",
                EXPECTED_FOLD_TRAIN, FOLD)
    for name in ("bfloat16", "float32"):
        print(f"train {name} peak memory: fold {out[f'fold_train_{name}_peak_mib']:.0f} MiB, "
              f"fused {out[f'train_{name}_peak_mib']:.0f} MiB")
    routes_agree(pt, torch, make, max_edges, gpu_batches[0], dev, (("fold", FOLD),))
    print(f"fold train phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    train_vs_cpu(pt, torch, make, data, dev, "fold_train", FOLD)
    print(f"fold train vs CPU phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_phase(pt, torch, dev, out, "fold_md17", EXPECTED_FOLD_MD17, FOLD_HO, md17_ref)
    print(f"fold md17 phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    k7_leg_records = []
    k7_leg_kernel_phase(torch, fold_leg_sites(pt, md17_max_edges, md17_batches[0]), dev,
                        k7_leg_records)
    report_kernels(k7_leg_records)
    print(f"K7 leg kernel phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_train_phase(pt, torch, md17_max_edges, md17_batches, dev, out, "fold_md17_train",
                     EXPECTED_FOLD_MD17_TRAIN, FOLD_HO, FOLD_TIMED_STEPS)
    for name in ("float32", "bfloat16"):
        print(f"md17 train {name}: fold {out[f'fold_md17_train_{name}']:.1f} molecules/s, peak "
              f"{out[f'fold_md17_train_{name}_peak_mib']:.0f} MiB; fused "
              f"{out[f'md17_train_{name}']:.1f} molecules/s, peak "
              f"{out[f'md17_train_{name}_peak_mib']:.0f} MiB")
    print(f"fold md17 train phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_train_vs_cpu(pt, torch, dev, "fold_md17_train", FOLD_HO, md17_step64)
    print(f"fold md17 train vs CPU phase: {time.time() - t:.1f} s", flush=True)

    # the unfused DTP route (K6): kernels, QM9 training, MD17 forces and training
    t = time.time()
    k6_records = []
    qm9_model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED)
    k6_kernel_phase(torch, qm9_model, gpu_batches[0], dev, k6_records,
                    ("sep_act", "sep_value", "edge_deg"))
    del qm9_model
    l3_model = pt.model_entrypoint(MD17_MODEL)(max_edges=md17_max_edges,
                                               nodes_per_graph=MD17_SLOTS, seed=SEED)
    k6_kernel_phase(torch, l3_model, md17_batches[0], dev, k6_records, ("sep_act",), "md17-")
    del l3_model
    report_kernels(k6_records)
    print(f"K6 kernel phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    unfused_eval_counts(pt, torch, make, max_edges, gpu_batches, out)
    train_phase(pt, torch, make, max_edges, gpu_batches, dev, out, "unfused_train",
                EXPECTED_UNFUSED_TRAIN, UNFUSED)
    train_phase(pt, torch, make, max_edges, gpu_batches, dev, out, "first_order_train",
                EXPECTED_FIRST_ORDER_TRAIN, FIRST_ORDER_BWD)
    routes_agree(pt, torch, make, max_edges, gpu_batches[0], dev)
    print(f"unfused train phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    train_vs_cpu(pt, torch, make, data, dev, "unfused_train", UNFUSED)
    print(f"unfused train vs CPU phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_phase(pt, torch, dev, out, "unfused_md17", EXPECTED_UNFUSED_MD17, UNFUSED, md17_ref)
    print(f"unfused md17 phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_train_phase(pt, torch, md17_max_edges, md17_batches, dev, out, "unfused_md17_train",
                     EXPECTED_UNFUSED_MD17_TRAIN, UNFUSED)
    print(f"unfused md17 train phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    md17_train_vs_cpu(pt, torch, dev, "unfused_md17_train", UNFUSED, md17_step64)
    print(f"unfused md17 train vs CPU phase: {time.time() - t:.1f} s", flush=True)

    # the kron route (K8): kernels, QM9 eval and training
    t = time.time()
    k8_records = []
    kron32 = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED, **KRON)
    k8_kernel_phase(torch, kron32, gpu_batches[0], dev, k8_records)
    del kron32
    report_kernels(k8_records)
    print(f"K8 kernel phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    route_eval_phase(pt, torch, make, max_edges, gpu_batches, dev, out, "kron", KRON,
                     EXPECTED_KRON_EVAL)
    train_phase(pt, torch, make, max_edges, gpu_batches, dev, out, "kron_train",
                EXPECTED_KRON_TRAIN, KRON)
    for name in ("bfloat16", "float32"):
        print(f"{name}: kron eval {out[f'kron_eval_{name}']:.1f} graphs/s, peak "
              f"{out[f'kron_eval_{name}_peak_mib']:.0f} MiB; kron train "
              f"{out[f'kron_train_{name}']:.1f} graphs/s, peak "
              f"{out[f'kron_train_{name}_peak_mib']:.0f} MiB; fused eval {out[f'eval_{name}']:.1f}, "
              f"train {out[f'train_{name}']:.1f} graphs/s, peak "
              f"{out[f'train_{name}_peak_mib']:.0f} MiB")
    routes_agree(pt, torch, make, max_edges, gpu_batches[0], dev, (("kron", KRON),))
    first_steps_bitwise(pt, torch, make, max_edges, gpu_batches[0], KRON, "kron_train")
    kron_fold_override(pt, torch, make, max_edges, gpu_batches)
    print(f"kron train phase: {time.time() - t:.1f} s", flush=True)
    t = time.time()
    train_vs_cpu(pt, torch, make, data, dev, "kron_train", KRON)
    print(f"kron train vs CPU phase: {time.time() - t:.1f} s", flush=True)

    # the measurement kernels (S1-S3): the tools, then each kernel against its plain version
    t = time.time()
    measure_tools(torch, out)
    measure_records = []
    qm9_model = make(max_edges=max_edges, nodes_per_graph=SLOTS, seed=SEED)
    measure_kernel_phase(torch, qm9_model, gpu_batches[0], dev, measure_records)
    del qm9_model
    report_kernels(measure_records)
    print(f"measurement phase: {time.time() - t:.1f} s", flush=True)

    table = []
    for name in SOURCES:
        # the bf16 row at the kernel's first (for the fused DTP's kernels: the
        # two-head) call site (K5b, K7-L: the x leg); K5a's launches are the
        # force evaluation's, K5b's and K5c's the force training step's,
        # K7-L's, K7-LW's and K7-Wr's the folded force training step's, K8's
        # the kron QM9 training step's, the measurement kernels' their tools'
        # runs, the others' the QM9 training step's
        path = {"dtp_lin_bwd3": "md17_launches", "dtp_lin_leg": "md17_train_launches",
                "dtp_lin_legW": "md17_train_launches", "dtp_t": "unfused_train_launches",
                "dtp_r": "unfused_md17_launches",
                "dtp_fused_bwd": "first_order_train_launches",
                "dtp_lin_rad_fwd": "fold_train_launches", "dtp_lin_rad_bwd": "fold_train_launches",
                "dtp_lin_rad_bwd3": "fold_md17_launches",
                "dtp_lin_rad_leg": "fold_md17_train_launches",
                "dtp_lin_rad_legW": "fold_md17_train_launches",
                "dtp_lin_rad_legWr": "fold_md17_train_launches",
                "dtp_lin_kron_fwd": "kron_train_launches",
                "dtp_lin_kron_bwd": "kron_train_launches",
                **dict.fromkeys(MEASURE_KERNELS, "measure_launches")}.get(name, "train_launches")
        r = next(r for r in records + md17_records + md17_train_records + k6_records
                 + k7_records + k7_leg_records + k8_records + measure_records + cli_records
                 if r["kernel"] == name and r["dtype"] == "bfloat16")
        table.append({"name": name, "route": "cuda", "source": SOURCES[name],
                      "replaces": TPU_KERNELS[name], "launches": out[path][name],
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
