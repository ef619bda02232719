"""Training and evaluation steps.

Counterpart of ``equiformer_tpu.train.engine``.  ``make_qm9_steps``: L1 (or
L2) loss on the normalized targets, masked over the padded graph slots,
AdamW, EMA, and the MAE.  ``evaluate`` is its eval step: the eval-mode
forward plus the MAE sums over the real graphs of the batch.
``make_md17_steps``: energy + force training, the loss of ``forces =
-dE/dpos`` differentiated with respect to the parameters (a grad-of-grad);
``evaluate_md17`` is its eval step: energies and forces plus their MAE sums.
Data parallelism (``pmean_axis``) and the DeNS steps are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from ..graph.batching import GraphsTuple
from ..kernels.dtp import skip_leg_grads
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


def _l2mae(err: torch.Tensor, mask: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Mean over the masked rows of the L2 norm of the last axis (the
    absolute value for a vector of scalars); ``eps`` keeps the square root's
    gradient finite at zero error."""
    per = torch.abs(err) if err.dim() == 1 else torch.sqrt(torch.sum(err * err, dim=-1) + eps)
    return masked_mean(per, mask)


def make_md17_steps(model: torch.nn.Module, optimizer, task_mean: float = 0.0,
                    task_std: float = 1.0, energy_weight: float = 0.2,
                    force_weight: float = 0.8, ema_decay: Optional[float] = 0.999):
    """Energy + force training steps; returns ``(train_step, eval_step)``.

    loss = energy_weight * L2MAE(E - E_target) + force_weight * L2MAE(F -
    F_target) in normalized units, forces from ``energy_and_forces(...,
    create_graph=True)``, so the parameter gradient is a double backward
    through the network.  ``train_step(state, batch, generator=None)`` runs
    the training-mode forward and force pass (``generator`` feeds the
    dropout sites of models that have them, as in ``make_qm9_steps``), the
    parameter gradient, one optimizer update and the EMA update, all in
    place on ``state``; returns the state and ``{"loss", "loss_e", "loss_f",
    "mae_e", "mae_f", "grad_norm"}`` as device scalars (no host sync).
    ``eval_step(model, batch)`` is ``evaluate_md17`` with the task
    normalization bound."""

    def train_step(state: TrainState, batch: GraphsTuple, generator=None):
        state.model.train()
        params = state.params
        energy, forces = energy_and_forces(state.model, batch, create_graph=True, rng=generator)
        e_err = energy - (batch.y.to(energy.dtype) - task_mean) / task_std
        f_err = forces - batch.forces.to(forces.dtype) / task_std
        loss_e = _l2mae(e_err, batch.graph_mask)
        loss_f = _l2mae(f_err, batch.node_mask)
        loss = energy_weight * loss_e + force_weight * loss_f
        with torch.no_grad():
            mae_e = masked_mean(torch.abs(e_err) * task_std, batch.graph_mask)
            mae_f = masked_mean(torch.abs(f_err) * task_std,
                                batch.node_mask[:, None].expand_as(f_err))
        # sh depends on the positions alone: no parameter gradient flows
        # through it, so the DTP ops skip its sh leg (K5b sh legs, R) here
        with skip_leg_grads("sh"):
            grads = torch.autograd.grad(loss, list(params.values()))
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        optimizer.update(params, grads, state.opt_state)
        if state.ema is not None and ema_decay is not None:
            ema_update(state.ema, params, ema_decay)
        state.step += 1
        return state, {"loss": loss.detach(), "loss_e": loss_e.detach(),
                       "loss_f": loss_f.detach(), "mae_e": mae_e, "mae_f": mae_f,
                       "grad_norm": grad_norm}

    eval_step = functools.partial(evaluate_md17, task_mean=task_mean, task_std=task_std)
    return train_step, eval_step
