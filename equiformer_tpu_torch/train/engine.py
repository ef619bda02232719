"""Training and evaluation steps.

Counterpart of ``equiformer_tpu.train.engine``.  ``make_qm9_steps``: L1 (or
L2) loss on the normalized targets, masked over the padded graph slots,
AdamW, EMA, and the MAE.  ``evaluate`` is its eval step: the eval-mode
forward plus the MAE sums over the real graphs of the batch.
``evaluate_md17`` is the eval step of ``make_md17_steps``: energies and
forces plus their MAE sums; force training (``make_md17_steps`` itself, a
grad-of-grad) and data parallelism are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from ..graph.batching import GraphsTuple
from ..models.md17_models import energy_and_forces
from .optim import ema_update
from .state import TrainState


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(x.dtype)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def evaluate(model: torch.nn.Module, batch: GraphsTuple, task_mean: float = 0.0,
             task_std: float = 1.0) -> Dict[str, torch.Tensor]:
    """Returns ``pred`` (normalized, [G]), ``mae_sum`` and ``count``."""
    model.eval()
    with torch.no_grad():
        pred = model(batch)
    err = pred * task_std + task_mean - batch.y.to(pred.dtype)
    gm = batch.graph_mask.to(pred.dtype)
    return {"pred": pred, "mae_sum": torch.sum(torch.abs(err) * gm), "count": torch.sum(gm)}


def evaluate_md17(model: torch.nn.Module, batch: GraphsTuple, task_mean: float = 0.0,
                  task_std: float = 1.0) -> Dict[str, torch.Tensor]:
    """Energies [G] and forces [N, 3] of the eval-mode model (normalized
    units), and ``mae_e_sum`` / ``count_e`` over the real graphs and
    ``mae_f_sum`` / ``count_f`` over the force components of the real atoms,
    against ``batch.y`` and ``batch.forces``.  Differentiates with respect to
    the positions only (``energy_and_forces``), even under ``no_grad``."""
    model.eval()
    energy, forces = energy_and_forces(model, batch)
    e_err = energy * task_std + task_mean - batch.y.to(energy.dtype)
    f_err = forces * task_std - batch.forces.to(forces.dtype)
    gm = batch.graph_mask.to(energy.dtype)
    fmask = batch.node_mask.to(forces.dtype)[:, None].expand_as(forces)
    return {"energy": energy, "forces": forces,
            "mae_e_sum": torch.sum(torch.abs(e_err) * gm), "count_e": torch.sum(gm),
            "mae_f_sum": torch.sum(torch.abs(f_err) * fmask), "count_f": torch.sum(fmask)}


def make_qm9_steps(model: torch.nn.Module, optimizer, task_mean: float = 0.0,
                   task_std: float = 1.0, loss_type: str = "l1",
                   ema_decay: Optional[float] = 0.999):
    """Returns ``(train_step, eval_step)``.

    ``train_step(state, batch, generator)`` runs the training-mode forward
    (dropout drawn from ``generator``, a ``torch.Generator`` on the model's
    device, or an iterator of injected keep masks), the backward, one
    optimizer update and the EMA update, all in place on ``state``; returns
    the state and ``{"loss", "mae", "grad_norm"}`` as device scalars (no
    host sync).  ``eval_step(model, batch)`` is ``evaluate`` with the task
    normalization bound."""
    if loss_type not in ("l1", "l2"):
        raise ValueError(loss_type)

    def train_step(state: TrainState, batch: GraphsTuple, generator):
        device = next(state.model.parameters()).device
        if isinstance(generator, torch.Generator) and generator.device.type != device.type:
            raise ValueError(f"the generator is on {generator.device}, the model on {device}")
        state.model.train()
        params = state.params
        pred = state.model(batch, rng=generator)
        err = pred - (batch.y.to(pred.dtype) - task_mean) / task_std
        per = torch.abs(err) if loss_type == "l1" else err * err
        loss = masked_mean(per, batch.graph_mask)
        mae = masked_mean(torch.abs(err).detach() * task_std, batch.graph_mask)
        grads = torch.autograd.grad(loss, list(params.values()))
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        optimizer.update(params, grads, state.opt_state)
        if state.ema is not None and ema_decay is not None:
            ema_update(state.ema, params, ema_decay)
        state.step += 1
        return state, {"loss": loss.detach(), "mae": mae, "grad_norm": grad_norm}

    eval_step = functools.partial(evaluate, task_mean=task_mean, task_std=task_std)
    return train_step, eval_step
