"""QM9 training CLI.

Counterpart of ``equiformer_tpu.cli.train_qm9``.  Runs on the GPU by
default (and raises without one); ``--device cpu`` runs on the CPU.

Example:
  python -m equiformer_tpu_torch.cli.train_qm9 --target 1 --data-path datasets/qm9
  python -m equiformer_tpu_torch.cli.train_qm9 --synthetic --epochs 2   # smoke run
"""

from __future__ import annotations

import argparse

from ..data import GraphLoader, qm9_like_dataset
from ..graph.batching import cli_capacities
from ..models import model_entrypoint
from ..models.registry import resolve_device
from ..train import TrainState, cosine_warmup_schedule, create_optimizer, make_qm9_steps
from ..train.checkpoint import load_params
from ..utils.logger import FileLogger
from .common import add_common_args, check_dp, run_epochs


def get_args(argv=None):
    p = argparse.ArgumentParser("QM9 Equiformer training (PyTorch)")
    add_common_args(p)
    p.add_argument("--target", type=int, default=1, help="QM9 target index (1=alpha)")
    p.add_argument("--loss", type=str, default="l1", choices=["l1", "l2"])
    p.add_argument("--no-standardize", action="store_true",
                   help="train on raw targets (reference --no-standardize)")
    p.set_defaults(model_name="graph_attention_transformer_nonlinear_l2")
    return p.parse_args(argv)


def main(args):
    check_dp(args)
    device = resolve_device(args.device)
    log = FileLogger(True, args.output_dir)
    if args.synthetic:
        train, mean, std = qm9_like_dataset(512, seed=1), 0.0, 1.0
        val = qm9_like_dataset(128, seed=2)
        test = qm9_like_dataset(128, seed=3)
    else:
        from ..data.qm9 import load_qm9

        train, mean, std = load_qm9(args.data_path, "train", args.target)
        val, _, _ = load_qm9(args.data_path, "valid", args.target)
        test, _, _ = load_qm9(args.data_path, "test", args.target)
    if args.no_standardize:
        mean, std = 0.0, 1.0
    log.info("train %d molecules; target mean %.4f std %.4f", len(train), mean, std)

    # 30 atoms and 17 edges a node row, each rounded up to 128
    node_cap, edge_cap = cli_capacities(args.batch_size, 30, 17)
    model_kwargs = dict(
        radius=args.radius, num_basis=args.num_basis, max_edges=edge_cap,
        task_mean=mean, task_std=std, remat=True, drop_path_rate=args.drop_path,
        compute_dtype=None if args.no_amp else "bfloat16", seed=args.seed, device=device,
    )
    if args.input_irreps:
        model_kwargs["irreps_in"] = args.input_irreps
    model = model_entrypoint(args.model_name)(**model_kwargs)
    train_loader = GraphLoader(train, args.batch_size, node_cap, seed=args.seed)
    val_loader = GraphLoader(val, args.batch_size, node_cap, shuffle=False, drop_last=False)
    test_loader = GraphLoader(test, args.batch_size, node_cap, shuffle=False, drop_last=False)

    steps_per_epoch = len(train_loader)
    schedule = cosine_warmup_schedule(
        args.lr, args.warmup_epochs * steps_per_epoch, args.epochs * steps_per_epoch,
        args.min_lr)
    opt = create_optimizer(schedule, args.weight_decay, grad_clip_norm=args.clip_grad)
    train_step, eval_step = make_qm9_steps(
        model, opt, mean, std, args.loss,
        ema_decay=None if args.no_model_ema else args.ema_decay)

    # JAX initializes on a first batch drawn from the train loader, which
    # advances its epoch count; draw it too, so the epochs shuffle alike
    next(iter(train_loader))
    n_params = sum(p.numel() for p in model.parameters())
    log.info("model %s: %.2fM params", args.model_name, n_params / 1e6)
    if args.checkpoint_path:
        load_params(args.checkpoint_path, model)
        log.info("loaded checkpoint %s", args.checkpoint_path)
    state = TrainState.create(model, opt)

    return run_epochs(
        args, state, train_step, eval_step, train_loader, val_loader, test_loader,
        metric_keys=("loss", "mae"), logger=log,
        eval_reduce=lambda s: {"mae": s["mae_sum"] / max(s["count"], 1.0)},
    )


if __name__ == "__main__":
    main(get_args())
