"""The training CLIs' shared flags and epoch loop.

Counterpart of ``equiformer_tpu.cli.common``: the epoch loop with
per-epoch evaluation of the EMA weights, best-val and best-test
checkpoints, the periodic test evaluation, and the wall-clock and metric
log lines.  The step is the port's step function; one ``torch.Generator``
on the model's device, seeded from ``--seed``, feeds every step's dropout
(JAX splits a key a step); the default generators are never drawn from.
Batches are collated on the host by a background thread (``prefetch``)
and moved to the model's device.  Data parallelism (``--dp > 1``) is not
ported.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import os
import time
from typing import Callable, Dict, Optional

import torch

from ..data import prefetch
from ..train import AverageMeter, TrainState
from ..train.checkpoint import save_params
from ..utils.convert_jax import params_to_jax
from ..utils.logger import FileLogger, MetricsWriter


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--output-dir", type=str, default="runs/default")
    p.add_argument("--model-name", type=str, default=None)
    p.add_argument("--data-path", type=str, default="datasets")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--eval-batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--min-lr", type=float, default=1e-6)
    p.add_argument("--weight-decay", type=float, default=5e-3)
    p.add_argument("--warmup-epochs", type=int, default=10)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--num-basis", type=int, default=128)
    p.add_argument("--clip-grad", type=float, default=None)
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--no-model-ema", action="store_true",
                   help="disable the EMA copy (reference --no-model-ema)")
    p.add_argument("--input-irreps", type=str, default=None,
                   help="one-hot input irreps (reference signature compat)")
    p.add_argument("--feature-type", type=str, default="one_hot", choices=["one_hot"],
                   help="atom feature encoding (reference --feature-type)")
    p.add_argument("--drop-path", type=float, default=0.0)
    p.add_argument("--no-amp", action="store_true",
                   help="fp32 feature compute (default: bfloat16 features)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="run on synthetic data (no dataset files needed)")
    p.add_argument("--eval-interval", type=int, default=1)
    p.add_argument("--test-interval", type=int, default=0,
                   help="epoch interval for periodic test-set evaluation (0 = only "
                        "evaluate test when val improves)")
    p.add_argument("--test-max-iter", type=int, default=-1,
                   help="max batches per periodic test eval (-1 = full test set)")
    p.add_argument("--print-freq", type=int, default=100)
    p.add_argument("--checkpoint-path", type=str, default=None)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--dp", type=int, default=1, help="data-parallel devices (not ported)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU (raises without one), "
                        "'cpu' for the CPU")
    return p


def check_dp(args) -> None:
    if getattr(args, "dp", 1) > 1:
        raise NotImplementedError("--dp > 1: data parallelism (M12) is not ported; use --dp 1")


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """``state.model`` holding the EMA weights (when there are any) inside
    the block, its own weights restored bit for bit after it."""
    if state.ema is None:
        yield state.model
        return
    params = state.params
    saved = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state.ema[n])
    try:
        yield state.model
    finally:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])


def _save_eval_weights(path: str, state: TrainState) -> None:
    if state.ema is None:
        save_params(path, state.model)
    else:
        save_params(path, {"params": params_to_jax(state.model, state.ema)})


def run_epochs(
    args,
    state: TrainState,
    train_step: Callable,
    eval_step: Callable,
    train_loader,
    val_loader,
    test_loader=None,
    metric_keys=("loss", "mae"),
    eval_reduce: Optional[Callable] = None,
    extra_step_args: Callable = lambda epoch: (),
    logger: Optional[FileLogger] = None,
    best_key: str = "mae",
    score_fn: Optional[Callable[[Dict[str, float]], float]] = None,
):
    """Epoch loop with best-val and best-test checkpoints.

    ``train_step(state, batch, generator, *extra_step_args(epoch))`` and
    ``eval_step(model, batch)`` are the port's steps (``make_qm9_steps``,
    ``make_md17_steps``, ``make_dens_steps``).  The test set is evaluated
    every ``args.test_interval`` epochs (at most ``args.test_max_iter``
    batches) and whenever val improves; val and test each keep their own
    best checkpoint (``best_val.npz``, ``best_test.npz``: the EMA weights
    when there are any), scored by ``score_fn`` or ``best_key``.
    ``final.npz`` holds the trained weights.  Evaluation sums the scalar
    entries of each eval step's output."""
    check_dp(args)
    log = logger or FileLogger(True, args.output_dir)
    writer = MetricsWriter(args.output_dir)
    device = next(state.model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(args.seed)
    best_val = best_test = float("inf")
    score = score_fn or (lambda r: r.get(best_key, float("inf")))
    test_interval = getattr(args, "test_interval", 0) or 0
    test_max_iter = getattr(args, "test_max_iter", -1)
    global_step = 0

    def evaluate(model, loader, tag, max_iter=-1):
        sums: Dict[str, float] = {}
        it = iter(loader)
        if max_iter >= 0:
            it = itertools.islice(it, max_iter)
        for batch in it:
            out = eval_step(model, batch.to(device))
            for k, v in out.items():
                if v.dim() == 0:
                    sums[k] = sums.get(k, 0.0) + float(v)
        result = eval_reduce(sums) if eval_reduce else {
            "mae": sums.get("mae_sum", 0.0) / max(sums.get("count", 1.0), 1.0)
        }
        log.info("%s: %s", tag, {k: round(v, 6) for k, v in result.items()})
        return result

    if args.evaluate and val_loader is not None:
        return evaluate(state.model, val_loader, "eval")

    for epoch in range(args.epochs):
        meters = {k: AverageMeter() for k in metric_keys}
        t0 = time.perf_counter()
        for i, batch in enumerate(prefetch(iter(train_loader))):
            state, metrics = train_step(state, batch.to(device), generator,
                                        *extra_step_args(epoch))
            global_step += 1
            for k in metric_keys:
                if k in metrics:
                    meters[k].update(float(metrics[k]))
            if i % args.print_freq == 0:
                writer.write(global_step, {k: meters[k].avg for k in metric_keys})
        dt = time.perf_counter() - t0
        n_steps = max(len(train_loader), 1)
        log.info(
            "epoch %d: %s  (%.1fs, %.1f ms/step, %.1f graphs/s)",
            epoch, {k: round(meters[k].avg, 6) for k in metric_keys},
            dt, 1000 * dt / n_steps, args.batch_size * n_steps / dt,
        )
        if val_loader is not None and (epoch + 1) % args.eval_interval == 0:
            with ema_weights(state) as model:
                result = evaluate(model, val_loader, f"val epoch {epoch}")
            val_score = score(result)
            improved_val = val_score < best_val
            if improved_val:
                best_val = val_score
                _save_eval_weights(os.path.join(args.output_dir, "best_val.npz"), state)
                log.info("new best val score=%.6f", best_val)
            test_due = test_interval > 0 and (epoch + 1) % test_interval == 0
            if test_loader is not None and (test_due or improved_val):
                with ema_weights(state) as model:
                    test_result = evaluate(model, test_loader, f"test epoch {epoch}",
                                           max_iter=test_max_iter if test_due else -1)
                test_score = score(test_result)
                if test_score < best_test:
                    best_test = test_score
                    _save_eval_weights(os.path.join(args.output_dir, "best_test.npz"), state)
                    log.info("new best test score=%.6f", best_test)
    writer.close()
    save_params(os.path.join(args.output_dir, "final.npz"), state.model)
    return state
