"""MD17 energy + force training CLI, with DeNS denoising training through
``--use-dens``.

Counterpart of ``equiformer_tpu.cli.train_md17``.  Runs on the GPU by
default (and raises without one); ``--device cpu`` runs on the CPU.
``--config-yml`` reads the model's options from a YAML file with the
port's own reader (``utils/config.py``; no PyYAML needed).

Example:
  python -m equiformer_tpu_torch.cli.train_md17 --molecule aspirin \\
      --model-name graph_attention_transformer_nonlinear_exp_l3_md17
  python -m equiformer_tpu_torch.cli.train_md17 --synthetic --epochs 2
  python -m equiformer_tpu_torch.cli.train_md17 --use-dens --synthetic --epochs 2 \\
      --config-yml configs/md17_dens/equiformer_dens_l3.yml
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.irreps import Irreps
from ..data import GraphLoader, md17_like_dataset
from ..graph.batching import cli_capacities
from ..models import model_entrypoint
from ..models.registry import resolve_device
from ..train import (
    TrainState,
    cosine_warmup_schedule,
    create_optimizer,
    make_dens_steps,
    make_md17_steps,
)
from ..train.checkpoint import load_params
from ..utils.logger import FileLogger
from .common import add_common_args, check_dp, run_epochs


def get_args(argv=None):
    p = argparse.ArgumentParser("MD17 Equiformer training (PyTorch)")
    add_common_args(p)
    p.add_argument("--molecule", type=str, default="aspirin")
    p.add_argument("--train-size", type=int, default=950)
    p.add_argument("--val-size", type=int, default=50)
    p.add_argument("--energy-weight", type=float, default=0.2)
    p.add_argument("--force-weight", type=float, default=0.8)
    # DeNS options
    p.add_argument("--use-dens", action="store_true")
    p.add_argument("--denoising-pos-weight", type=float, default=1.0)
    p.add_argument("--denoising-pos-std", type=float, default=0.05)
    p.add_argument("--denoising-pos-prob", type=float, default=0.5)
    p.add_argument("--denoising-corrupt-ratio", type=float, default=None)
    p.add_argument("--use-denoising-pos-weight-linear-decay", action="store_true")
    p.add_argument("--config-yml", type=str, default=None,
                   help="YAML with model kwargs (md17/configs analog)")
    p.set_defaults(
        model_name="graph_attention_transformer_nonlinear_exp_l2_md17",
        batch_size=8, eval_batch_size=24, epochs=1000,
        test_interval=10, test_max_iter=1000,
    )
    return p.parse_args(argv)


def dp_weight(args, epoch: int) -> float:
    """The denoising loss weight of ``epoch``: ``--denoising-pos-weight``,
    decayed linearly to 0 over the epochs with
    ``--use-denoising-pos-weight-linear-decay``, rounded to float32 as JAX
    passes it."""
    w = args.denoising_pos_weight
    if args.use_denoising_pos_weight_linear_decay:
        w = w * (1.0 - min(1.0, epoch / args.epochs))
    return float(np.float32(w))


def main(args):
    check_dp(args)
    device = resolve_device(args.device)
    log = FileLogger(True, args.output_dir)
    if args.synthetic:
        train = md17_like_dataset(256, num_atoms=21, seed=1)
        val = md17_like_dataset(64, num_atoms=21, seed=2)
        test = md17_like_dataset(64, num_atoms=21, seed=3)
        mean, std = 0.0, 1.0
    else:
        from ..data.md17 import load_md17

        train, mean, std = load_md17(args.data_path, args.molecule, "train",
                                     args.train_size, args.val_size)
        val, _, _ = load_md17(args.data_path, args.molecule, "valid",
                              args.train_size, args.val_size)
        test, _, _ = load_md17(args.data_path, args.molecule, "test",
                               args.train_size, args.val_size)
        test = test[:5000]  # the usual evaluation subset
    log.info("%s: %d train frames; E mean %.4f std %.4f",
             args.molecule, len(train), mean, std)

    n_atoms = int(train[0]["pos"].shape[0])
    # atoms + 1 edges a node row: every ordered pair of a molecule's atoms fits
    node_cap, edge_cap = cli_capacities(args.batch_size, n_atoms, n_atoms + 1)

    model_kwargs = {}
    if args.config_yml:
        from ..utils.config import build_config

        for k, v in build_config(args.config_yml).get("model", {}).items():
            irreps = isinstance(v, str) and any(t in v for t in ("x0e", "x1", "x2", "x3"))
            model_kwargs[k] = Irreps(v) if irreps else v
        if "fc_neurons" in model_kwargs:
            model_kwargs["fc_neurons"] = tuple(model_kwargs["fc_neurons"])
    if args.drop_path:
        model_kwargs.setdefault("drop_path_rate", args.drop_path)
    if args.input_irreps:
        model_kwargs.setdefault("irreps_in", args.input_irreps)
    model_kwargs.update(seed=args.seed, device=device)
    if args.use_dens:
        model = model_entrypoint("equiformer_md17_dens")(max_edges=edge_cap, **model_kwargs)
    else:
        model = model_entrypoint(args.model_name)(
            radius=args.radius, num_basis=args.num_basis, max_edges=edge_cap, remat=True,
            **model_kwargs)
    train_loader = GraphLoader(train, args.batch_size, node_cap, seed=args.seed,
                               with_forces=True)
    val_loader = GraphLoader(val, args.batch_size, node_cap, shuffle=False, drop_last=False,
                             with_forces=True)
    test_loader = GraphLoader(test, args.batch_size, node_cap, shuffle=False, drop_last=False,
                              with_forces=True)

    steps_per_epoch = len(train_loader)
    schedule = cosine_warmup_schedule(
        args.lr, args.warmup_epochs * steps_per_epoch, args.epochs * steps_per_epoch,
        args.min_lr)
    opt = create_optimizer(schedule, args.weight_decay, grad_clip_norm=args.clip_grad)
    ema_decay = None if args.no_model_ema else args.ema_decay

    if args.use_dens:
        train_step, eval_step = make_dens_steps(
            model, opt, mean, std, energy_weight=args.energy_weight,
            force_weight=args.force_weight, denoising_pos_std=args.denoising_pos_std,
            denoising_pos_prob=args.denoising_pos_prob,
            corrupt_ratio=args.denoising_corrupt_ratio, ema_decay=ema_decay)
        logged = set()

        def extra(epoch):
            w = dp_weight(args, epoch)
            if epoch not in logged:
                logged.add(epoch)
                log.info("epoch %d: dp_weight %.6f", epoch, w)
            return (w,)

        metric_keys = ("loss", "loss_e", "loss_f", "loss_dp")
    else:
        train_step, eval_step = make_md17_steps(
            model, opt, mean, std, args.energy_weight, args.force_weight, ema_decay=ema_decay)
        extra = lambda epoch: ()  # noqa: E731
        metric_keys = ("loss", "mae_e", "mae_f")

    # JAX initializes on a first batch drawn from the train loader, which
    # advances its epoch count; draw it too, so the epochs shuffle alike
    next(iter(train_loader))
    log.info("model: %.2fM params", sum(p.numel() for p in model.parameters()) / 1e6)
    if args.checkpoint_path:
        load_params(args.checkpoint_path, model)
    state = TrainState.create(model, opt)

    def eval_reduce(s):
        return {
            "mae_e": s["mae_e_sum"] / max(s["count_e"], 1.0),
            "mae_f": s["mae_f_sum"] / max(s["count_f"], 1.0),
        }

    def weighted_error(r):
        # the best-checkpoint criterion: energy_weight * e_err + force_weight * f_err
        return args.energy_weight * r["mae_e"] + args.force_weight * r["mae_f"]

    return run_epochs(
        args, state, train_step, eval_step, train_loader, val_loader, test_loader,
        metric_keys=metric_keys, eval_reduce=eval_reduce, extra_step_args=extra, logger=log,
        best_key="mae_f", score_fn=weighted_error,
    )


if __name__ == "__main__":
    main(get_args())
