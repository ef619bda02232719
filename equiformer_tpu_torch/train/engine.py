"""Training and evaluation steps.

Counterpart of ``equiformer_tpu.train.engine``.  ``make_qm9_steps``: L1 (or
L2) loss on the normalized targets, masked over the padded graph slots,
the optimizer (any of ``create_optimizer``'s, with its gradient clip), EMA,
and the MAE.  ``evaluate`` is its eval step: the eval-mode
forward plus the MAE sums over the real graphs of the batch.
``make_md17_steps``: energy + force training, the loss of ``forces =
-dE/dpos`` differentiated with respect to the parameters (a grad-of-grad);
``evaluate_md17`` is its eval step: energies and forces plus their MAE sums.
``make_dens_steps``: DeNS training, the noise augmentation drawn inside the
step and a three-term loss (energy, forces on the clean atoms, the noise
vector on the noised ones).  Data parallelism (``pmean_axis``) is not
ported yet.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from ..graph.batching import GraphsTuple
from ..kernels.dtp import skip_leg_grads
from ..models.dens import add_masked_gaussian_noise, dens_outputs
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
    return _force_sums(*energy_and_forces(model, batch), batch, task_mean, task_std)


def _force_sums(energy, forces, batch, task_mean, task_std) -> Dict[str, torch.Tensor]:
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
    host sync; ``grad_norm`` the norm before the optimizer's clip, as in
    JAX).  ``eval_step(model, batch)`` is ``evaluate`` with the task
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


def make_dens_steps(model: torch.nn.Module, optimizer, task_mean: float = 0.0,
                    task_std: float = 1.0, energy_weight: float = 1.0,
                    force_weight: float = 80.0, denoising_pos_std: float = 0.05,
                    denoising_pos_prob: float = 0.5, corrupt_ratio: Optional[float] = None,
                    ema_decay: Optional[float] = 0.999):
    """DeNS training steps (``models/dens.py``); returns ``(train_step,
    eval_step)``.

    ``train_step(state, batch, generator, dp_weight)`` draws the noise
    augmentation from ``generator`` (a ``torch.Generator`` on the batch's
    device; it also feeds the dropout sites of models that have them), then
    runs ``train_step.noised(state, noised_batch, dp_weight, generator)``:
    the training-mode forward and force pass (``dens_outputs(...,
    create_graph=True)``), loss = energy_weight * L2MAE(E) + force_weight *
    L2MAE(outputs - F) over the clean atoms + dp_weight * L2MAE(outputs -
    noise / denoising_pos_std) over the noised ones (normalized units; a
    term whose mask is empty is exactly 0), the parameter gradient, one
    optimizer update and the EMA update, in place on ``state``.  Returns the
    state and ``{"loss", "loss_e", "loss_f", "loss_dp", "grad_norm"}`` as
    device scalars.  ``dp_weight`` is a number, so a schedule of it stays on
    the host.  ``eval_step(model, batch)``: energies and forces of a batch
    without noise and their MAE sums, as ``evaluate_md17``."""

    def noised_step(state: TrainState, batch: GraphsTuple, dp_weight, generator=None):
        state.model.train()
        params = state.params
        energy, outputs = dens_outputs(state.model, batch, create_graph=True, rng=generator)
        noise_mask = batch.extras["noise_mask"]
        clean_mask = batch.node_mask & ~noise_mask
        loss_e = _l2mae(energy - (batch.y.to(energy.dtype) - task_mean) / task_std,
                        batch.graph_mask)
        loss_f = _l2mae(outputs - batch.forces.to(outputs.dtype) / task_std, clean_mask)
        loss_dp = _l2mae(outputs - batch.extras["noise_vec"].to(outputs.dtype)
                         / denoising_pos_std, noise_mask)
        loss = energy_weight * loss_e + force_weight * loss_f + dp_weight * loss_dp
        # sh depends on the positions alone: the DTP ops skip its sh leg here
        with skip_leg_grads("sh"):
            grads = torch.autograd.grad(loss, list(params.values()))
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        optimizer.update(params, grads, state.opt_state)
        if state.ema is not None and ema_decay is not None:
            ema_update(state.ema, params, ema_decay)
        state.step += 1
        return state, {"loss": loss.detach(), "loss_e": loss_e.detach(),
                       "loss_f": loss_f.detach(), "loss_dp": loss_dp.detach(),
                       "grad_norm": grad_norm}

    def train_step(state: TrainState, batch: GraphsTuple, generator: torch.Generator,
                   dp_weight):
        noised = add_masked_gaussian_noise(batch, generator, denoising_pos_std,
                                           denoising_pos_prob, corrupt_ratio)
        return noised_step(state, noised, dp_weight, generator)

    def eval_step(model: torch.nn.Module, batch: GraphsTuple) -> Dict[str, torch.Tensor]:
        model.eval()
        return _force_sums(*dens_outputs(model, batch), batch, task_mean, task_std)

    train_step.noised = noised_step
    return train_step, eval_step
