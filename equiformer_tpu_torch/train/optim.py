"""The optimizer zoo with the reference's weight-decay mask and global-norm
clipping, the cosine and multistep warmup schedules, and model EMA.

Counterparts of ``equiformer_tpu.train.optim``: ``create_optimizer(...,
opt_name)`` computes, for every name of the JAX package's zoo, what the
optax transformation it builds computes (optax 0.2.6, for the arguments the
JAX package passes): the same moments, bias corrections, masks, trust ratios
and order of operations, each update scaled by the scheduled learning rate
of its step and added to the parameters in place, with PyTorch's
multi-tensor (``_foreach``) ops where the operation is the same for every
tensor.  ``grad_clip_norm`` scales every gradient by ``c / norm`` when the
global norm reaches ``c`` (``optax.clip_by_global_norm`` chained in front),
on the device, with no host sync.

Each optimizer has ``init(model) -> state`` (a dict of Python numbers,
bools and tensors, which ``torch.save`` writes and ``torch.load(...,
weights_only=True)`` reads) and ``update(params, grads, state)``: one step
in place on the named parameters ``params`` and in ``state``.  The step
count lives on the host, so the learning rate and every bias correction are
host numbers and an update never waits for the device.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.convert_jax import flax_paths

_NO_DECAY_LEAF = re.compile(r"^(bias|b\d+|affine_weight|affine_bias|mean_shift|scale)$")
_NO_DECAY_MODULE = re.compile(r"(GaussianRadialBasis|BesselRadialBasis|ExpNormalBasis)")


def no_weight_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """True where weight decay applies, per parameter name: the JAX
    package's regexes on each parameter's flax path (``flax_paths``)."""
    return {name: not (_NO_DECAY_LEAF.match(path[-1])
                       or any(_NO_DECAY_MODULE.search(k) for k in path))
            for name, path in flax_paths(model).items()}


def cosine_warmup_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           min_lr: float = 1e-6,
                           warmup_init_factor: float = 0.2) -> Callable[[int], float]:
    """Linear warmup then cosine decay to ``min_lr``, per iteration from step
    0; evaluated in float32 with the JAX package's order of operations."""

    def schedule(step: int) -> float:
        s = torch.tensor(step, dtype=torch.float32)
        warm = base_lr * (warmup_init_factor
                          + (1 - warmup_init_factor) * s / max(warmup_steps, 1))
        progress = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                               0.0, 1.0)
        cos = min_lr + 0.5 * (base_lr - min_lr) * (1 + torch.cos(math.pi * progress))
        return float(warm if step < warmup_steps else cos)

    return schedule


def multistep_warmup_schedule(base_lr: float, warmup_steps: int, milestones,
                              gamma: float = 0.1,
                              warmup_init_factor: float = 0.2) -> Callable[[int], float]:
    """Linear warmup, then ``base_lr * gamma ** (milestones passed)``, per
    iteration from step 0; evaluated in float32 with the JAX package's order
    of operations."""
    milestones = tuple(int(m) for m in milestones)

    def schedule(step: int) -> float:
        s = torch.tensor(step, dtype=torch.float32)
        warm = base_lr * (warmup_init_factor
                          + (1 - warmup_init_factor) * s / max(warmup_steps, 1))
        n_passed = sum(torch.where(s >= m, 1.0, 0.0) for m in milestones)
        dec = base_lr * gamma ** torch.as_tensor(n_passed, dtype=torch.float32)
        return float(warm if step < warmup_steps else dec)

    return schedule


class _Optimizer:
    """The shared frame: ``init`` makes ``{"count": 0, ...}`` plus what
    ``_init`` adds; ``update`` takes the step's learning rate (``schedule``
    of the count before the step, as optax's ``scale_by_schedule``),
    increments the count and calls ``_step`` with the parameters, the
    gradients and the state's per-name entries in one order."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def init(self, model: torch.nn.Module) -> dict:
        state = {"count": 0}
        with torch.no_grad():
            self._init(model, dict(model.named_parameters()), state)
        return state

    def _init(self, model, params: Dict[str, torch.Tensor], state: dict) -> None:
        pass

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Sequence[torch.Tensor],
               state: dict) -> None:
        names = list(params)
        lr = self.schedule(state["count"])
        state["count"] += 1
        self._step(names, [params[n] for n in names], list(grads), state, lr, state["count"])

    def _step(self, names, ps, gs, state, lr, count) -> None:
        raise NotImplementedError


def _zeros(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _moment(state: dict, key: str, names) -> List[torch.Tensor]:
    return [state[key][n] for n in names]


def _decayed(names, ps, us, state, weight_decay: float) -> None:
    """In place: u += weight_decay * p on the names the mask decays
    (``optax.add_decayed_weights`` with the mask; all names when the state
    holds no mask)."""
    if not weight_decay:
        return
    mask = state.get("decay")
    idx = [i for i, n in enumerate(names) if mask is None or mask[n]]
    if idx:
        torch._foreach_add_([us[i] for i in idx], [ps[i] for i in idx], alpha=weight_decay)


def _apply(ps, us, lr: float) -> None:
    """p += -lr * u (``scale_by_learning_rate`` then ``apply_updates``)."""
    torch._foreach_add_(ps, us, alpha=-lr)


def _adam_direction(gs, mu, nu, b1, b2, eps, count) -> List[torch.Tensor]:
    """``scale_by_adam`` (eps outside the root, eps_root 0): updates the
    moments in place and returns mu_hat / (sqrt(nu_hat) + eps)."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, gs, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, gs, gs, value=1.0 - b2)
    mu_hat = torch._foreach_div(mu, 1.0 - b1 ** count)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - b2 ** count))
    torch._foreach_add_(denom, eps)
    return torch._foreach_div(mu_hat, denom)


def _trust_ratio(ps, us, min_norm: float = 0.0, coefficient: float = 1.0,
                 eps: float = 0.0) -> List[torch.Tensor]:
    """``scale_by_trust_ratio``: each update times coefficient * |p| / (|u|
    + eps), norms floored at ``min_norm`` (``numerics.safe_norm``), 1 where
    either norm is 0."""
    out = []
    for p, u, pn, un in zip(ps, us, torch._foreach_norm(ps), torch._foreach_norm(us)):
        if min_norm:
            pn = torch.where(pn <= min_norm, torch.full_like(pn, min_norm), pn)
            un = torch.where(un <= min_norm, torch.full_like(un, min_norm), un)
        ratio = coefficient * pn / (un + eps)
        out.append(u * torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio))
    return out


class Adam(_Optimizer):
    """``optax.adam``, or with ``weight_decay`` ``optax.adamw`` with the
    no-decay mask: Adam moments, bias correction from step 1, ``eps``
    outside the square root, decoupled weight decay on the masked
    parameters, all scaled by the scheduled learning rate."""

    def __init__(self, schedule, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(schedule)
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def _init(self, model, params, state):
        state["mu"], state["nu"] = _zeros(params), _zeros(params)
        if self.weight_decay:
            state["decay"] = no_weight_decay_mask(model)

    def _step(self, names, ps, gs, state, lr, count):
        upd = _adam_direction(gs, _moment(state, "mu", names), _moment(state, "nu", names),
                              self.b1, self.b2, self.eps, count)
        _decayed(names, ps, upd, state, self.weight_decay)
        _apply(ps, upd, lr)


class AdamW(Adam):
    """``optax.adamw`` with the JAX package's weight-decay mask."""

    def __init__(self, schedule, weight_decay: float = 5e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(schedule, weight_decay, b1, b2, eps)


class SGD(_Optimizer):
    """``optax.sgd(schedule, momentum, nesterov)``: the trace t = g + m t,
    the update t (or g + m t with Nesterov), times the learning rate."""

    def __init__(self, schedule, momentum: float = 0.9, nesterov: bool = True):
        super().__init__(schedule)
        self.momentum, self.nesterov = momentum, nesterov

    def _init(self, model, params, state):
        state["trace"] = _zeros(params)

    def _step(self, names, ps, gs, state, lr, count):
        trace = _moment(state, "trace", names)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, gs)
        upd = trace
        if self.nesterov:
            upd = torch._foreach_add(gs, trace, alpha=self.momentum)
        _apply(ps, upd, lr)


class RMSProp(_Optimizer):
    """``optax.rmsprop(schedule, decay, eps, momentum=0.9)``: nu = (1 - d)
    g^2 + d nu, u = -lr g / sqrt(nu + eps) (``eps`` inside the root), then
    the momentum trace t = u + m t of the scaled update."""

    def __init__(self, schedule, decay: float = 0.9, eps: float = 1e-8, momentum: float = 0.9):
        super().__init__(schedule)
        self.decay, self.eps, self.momentum = decay, eps, momentum

    def _init(self, model, params, state):
        state["nu"], state["trace"] = _zeros(params), _zeros(params)

    def _step(self, names, ps, gs, state, lr, count):
        nu, trace = _moment(state, "nu", names), _moment(state, "trace", names)
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - self.decay)
        upd = torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(nu, self.eps)), gs)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, upd)
        torch._foreach_add_(ps, trace)


class AdaBelief(_Optimizer):
    """``optax.adabelief(schedule, b1, b2, eps)`` with its default eps_root
    1e-16: the second moment of (g - mu), plus eps_root, kept in the state."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16,
                 eps_root: float = 1e-16):
        super().__init__(schedule)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def _init(self, model, params, state):
        state["mu"], state["nu"] = _zeros(params), _zeros(params)

    def _step(self, names, ps, gs, state, lr, count):
        mu, nu = _moment(state, "mu", names), _moment(state, "nu", names)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - self.b1)
        err = torch._foreach_sub(gs, mu)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, err, err, value=1.0 - self.b2)
        torch._foreach_add_(nu, self.eps_root)
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - self.b2 ** count))
        torch._foreach_add_(denom, self.eps)
        _apply(ps, torch._foreach_div(mu_hat, denom), lr)


class RAdam(_Optimizer):
    """``optax.radam(schedule, b1, b2, eps)``: Adam's moments; the update is
    the rectified Adam direction where the SMA length ro reaches
    ``threshold`` (5), else the bias-corrected first moment."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 threshold: float = 5.0):
        super().__init__(schedule)
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold

    def _init(self, model, params, state):
        state["mu"], state["nu"] = _zeros(params), _zeros(params)

    def _step(self, names, ps, gs, state, lr, count):
        mu, nu = _moment(state, "mu", names), _moment(state, "nu", names)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - b2)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** count)
        if ro >= self.threshold:
            r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                          / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - b2 ** count))
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(torch._foreach_mul(mu_hat, r), denom)
        else:
            upd = mu_hat
        _apply(ps, upd, lr)


class Lamb(_Optimizer):
    """``optax.lamb(schedule, b1, b2, eps, weight_decay, mask)``: the Adam
    direction, plus decay on the masked parameters, times each tensor's
    trust ratio |p| / |u|, times the learning rate."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(schedule)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def _init(self, model, params, state):
        state["mu"], state["nu"] = _zeros(params), _zeros(params)
        state["decay"] = no_weight_decay_mask(model)

    def _step(self, names, ps, gs, state, lr, count):
        upd = _adam_direction(gs, _moment(state, "mu", names), _moment(state, "nu", names),
                              self.b1, self.b2, self.eps, count)
        _decayed(names, ps, upd, state, self.weight_decay)
        _apply(ps, _trust_ratio(ps, upd), lr)


class Lars(_Optimizer):
    """``optax.lars(schedule, weight_decay)``: g + weight_decay p on every
    tensor, times 0.001 |p| / |u| (the trust ratio), times the learning
    rate, then the momentum trace t = u + 0.9 t."""

    def __init__(self, schedule, weight_decay: float = 0.0, trust_coefficient: float = 0.001,
                 momentum: float = 0.9):
        super().__init__(schedule)
        self.weight_decay, self.trust_coefficient = weight_decay, trust_coefficient
        self.momentum = momentum

    def _init(self, model, params, state):
        state["trace"] = _zeros(params)

    def _step(self, names, ps, gs, state, lr, count):
        upd = [g.clone() for g in gs]
        _decayed(names, ps, upd, state, self.weight_decay)
        upd = _trust_ratio(ps, upd, coefficient=self.trust_coefficient)
        torch._foreach_mul_(upd, -lr)
        trace = _moment(state, "trace", names)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, upd)
        torch._foreach_add_(ps, trace)


class Fromage(_Optimizer):
    """``optax.fromage(schedule)``: each gradient times |p| / |g| (norms
    floored at 1e-6), times -lr / sqrt(1 + lr^2), plus (1 / sqrt(1 +
    lr_0^2) - 1) p, in float32 scalars as optax computes them op by op
    (under ``jax.jit`` XLA takes its float32 rsqrt for 1 / sqrt, one ulp
    away at about half of all learning rates).  optax evaluates that decay
    at step 0 on every step: its ``add_decayed_weights`` never advances the
    count of a schedule of the decay."""

    MIN_NORM = 1e-6

    def _init(self, model, params, state):
        lr0 = np.float32(self.schedule(0))
        state["decay0"] = float(np.float32(1) / np.sqrt(np.float32(1) + lr0 * lr0) - np.float32(1))

    def _step(self, names, ps, gs, state, lr, count):
        lr32 = np.float32(lr)
        scale = float(-((np.float32(1) / np.sqrt(np.float32(1) + lr32 * lr32)) * lr32))
        upd = _trust_ratio(ps, gs, min_norm=self.MIN_NORM)
        torch._foreach_mul_(upd, scale)
        torch._foreach_add_(upd, ps, alpha=state["decay0"])
        torch._foreach_add_(ps, upd)


class Adagrad(_Optimizer):
    """``optax.adagrad(schedule, eps=eps)``: the sum of squares from 0.1,
    u = g / sqrt(sum + eps) where the sum is positive."""

    def __init__(self, schedule, eps: float = 1e-7, initial_accumulator_value: float = 0.1):
        super().__init__(schedule)
        self.eps, self.initial = eps, initial_accumulator_value

    def _init(self, model, params, state):
        state["sum_of_squares"] = {n: torch.full_like(p, self.initial) for n, p in params.items()}

    def _step(self, names, ps, gs, state, lr, count):
        sos = _moment(state, "sum_of_squares", names)
        torch._foreach_addcmul_(sos, gs, gs)
        inv = torch._foreach_rsqrt(torch._foreach_add(sos, self.eps))
        upd = [torch.where(s > 0, i, torch.zeros_like(i)) * g for s, i, g in zip(sos, inv, gs)]
        _apply(ps, upd, lr)


def _factored_dims(shape, min_dim: int = 128):
    """``factorized._factored_dims``: the two largest dims (second largest,
    largest) when there are two and the second is at least ``min_dim``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Optimizer):
    """``optax.adafactor(schedule)`` with its defaults: the factored second
    moment (row and column means of g^2 + 1e-30) for tensors whose second
    largest dim is at least 128, the full one elsewhere, at the decay rate
    1 - (t + 1)^-0.8 (float32), the update clipped to block RMS 1, times
    the learning rate and each parameter's RMS (at least 1e-3).  A torch
    ``Linear`` weight is a flax kernel transposed: it is factored in the
    kernel's layout, so the state matches optax's leaf by leaf."""

    def __init__(self, schedule, decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                 eps: float = 1e-30, clipping_threshold: float = 1.0, min_scale: float = 1e-3):
        super().__init__(schedule)
        self.decay_rate, self.min_dim = decay_rate, min_dim_size_to_factor
        self.eps, self.clipping_threshold, self.min_scale = eps, clipping_threshold, min_scale

    def _init(self, model, params, state):
        paths = flax_paths(model)
        state["kernel"] = {n: paths[n][-1] == "kernel" for n in params}
        state["v_row"], state["v_col"], state["v"] = {}, {}, {}
        for n, p in params.items():
            q = p.T if state["kernel"][n] else p
            dims = _factored_dims(tuple(q.shape), self.min_dim)
            if dims is None:
                state["v"][n] = torch.zeros_like(q)
            else:
                d1, d0 = dims
                state["v_row"][n] = q.new_zeros(tuple(np.delete(q.shape, d0)))
                state["v_col"][n] = q.new_zeros(tuple(np.delete(q.shape, d1)))

    def _step(self, names, ps, gs, state, lr, count):
        t = np.float32(count)  # the count before this step, plus 1
        decay = np.float32(1.0) - t ** np.float32(-self.decay_rate)
        d, keep = float(decay), float(np.float32(1.0) - decay)
        upds = []
        for n, p, g in zip(names, ps, gs):
            kernel = state["kernel"][n]
            q, g = (p.T, g.T) if kernel else (p, g)
            g2 = g * g + self.eps
            dims = _factored_dims(tuple(q.shape), self.min_dim)
            if dims is None:
                v = state["v"][n]
                v.copy_(d * v + keep * g2)
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                vr, vc = state["v_row"][n], state["v_col"][n]
                vr.copy_(d * vr + keep * g2.mean(dim=d0))
                vc.copy_(d * vc + keep * g2.mean(dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = g * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / self.clipping_threshold,
                                min=1.0)
            u = lr * u
            rms = torch.sqrt(torch.mean(q * q))
            u = u * torch.where(rms <= self.min_scale, torch.full_like(rms, self.min_scale), rms)
            u = -1 * u
            upds.append(u.T if kernel else u)
        torch._foreach_add_(ps, upds)


class NovoGrad(_Optimizer):
    """``optax.novograd(schedule, b1, b2, eps, weight_decay)``: a per-tensor
    second moment of |g|^2 (the first step's |g|^2 as it is), mu = b1 mu +
    g / (sqrt(nu) + eps) + weight_decay p on every tensor (no mask), the
    update mu times the learning rate."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.25, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(schedule)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def _init(self, model, params, state):
        state["mu"] = _zeros(params)
        state["nu"] = {n: p.new_zeros(()) for n, p in params.items()}

    def _step(self, names, ps, gs, state, lr, count):
        mu, nu = _moment(state, "mu", names), _moment(state, "nu", names)
        sq = [s ** 2 for s in torch._foreach_norm(gs)]
        for n, m, v, s, g, p in zip(names, mu, nu, sq, gs, ps):
            v.copy_(s if count == 1 else (1 - self.b2) * s + self.b2 * v)
            u = g / (torch.sqrt(v) + self.eps) + self.weight_decay * p
            m.copy_(u if count == 1 else self.b1 * m + u)
        _apply(ps, mu, lr)


class Lion(_Optimizer):
    """``optax.lion(schedule, weight_decay, mask)`` with its b1 0.9, b2
    0.99: u = sign((1 - b1) g + b1 mu), mu = (1 - b2) g + b2 mu, decay on
    the masked parameters, times the learning rate."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 1e-3):
        super().__init__(schedule)
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay

    def _init(self, model, params, state):
        state["mu"] = _zeros(params)
        state["decay"] = no_weight_decay_mask(model)

    def _step(self, names, ps, gs, state, lr, count):
        mu = _moment(state, "mu", names)
        upd = torch._foreach_mul(gs, 1.0 - self.b1)
        torch._foreach_add_(upd, mu, alpha=self.b1)
        upd = torch._foreach_sign(upd)
        torch._foreach_mul_(mu, self.b2)
        torch._foreach_add_(mu, gs, alpha=1.0 - self.b2)
        _decayed(names, ps, upd, state, self.weight_decay)
        _apply(ps, upd, lr)


class ClipByGlobalNorm:
    """``optax.chain(optax.clip_by_global_norm(max_norm), inner)``: every
    gradient times ``max_norm / norm`` where the global norm reaches
    ``max_norm``, as it is below; the factor is a device scalar, so the
    clip does not wait for the device.  The state is ``inner``'s."""

    def __init__(self, inner: _Optimizer, max_norm: float):
        self.inner, self.max_norm = inner, max_norm

    def init(self, model: torch.nn.Module) -> dict:
        return self.inner.init(model)

    @torch.no_grad()
    def update(self, params, grads, state) -> None:
        grads = list(grads)
        self.inner.update(params, torch._foreach_mul(grads, clip_factor(grads, self.max_norm)),
                          state)


def clip_factor(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """The device scalar ``clip_by_global_norm`` scales by: 1 where the
    global norm of ``grads`` is below ``max_norm``, else max_norm / norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    return torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)


OPTIMIZERS = ("adamw", "adam", "sgd", "nesterov", "momentum", "rmsprop", "adabelief", "radam",
              "lamb", "lars", "fromage", "adagrad", "adafactor", "novograd", "lion")


def create_optimizer(schedule: Callable[[int], float], weight_decay: float = 5e-3,
                     beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                     grad_clip_norm: Optional[float] = None, opt_name: str = "adamw"):
    """The JAX package's ``create_optimizer``: ``opt_name`` one of
    ``OPTIMIZERS``, each built with the arguments the JAX package gives its
    optax counterpart; ``grad_clip_norm`` chains global-norm clipping in
    front.  Raises ``ValueError`` for an unknown name."""
    if opt_name == "adamw":
        opt = AdamW(schedule, weight_decay, beta1, beta2, eps)
    elif opt_name == "adam":
        opt = Adam(schedule, 0.0, beta1, beta2, eps)
    elif opt_name in ("sgd", "nesterov"):
        opt = SGD(schedule, momentum=0.9, nesterov=True)
    elif opt_name == "momentum":
        opt = SGD(schedule, momentum=0.9, nesterov=False)
    elif opt_name == "rmsprop":
        opt = RMSProp(schedule, decay=0.9, eps=eps, momentum=0.9)
    elif opt_name == "adabelief":
        opt = AdaBelief(schedule, beta1, beta2, eps)
    elif opt_name == "radam":
        opt = RAdam(schedule, beta1, beta2, eps)
    elif opt_name == "lamb":
        opt = Lamb(schedule, beta1, beta2, eps, weight_decay)
    elif opt_name == "lars":
        opt = Lars(schedule, weight_decay)
    elif opt_name == "fromage":
        opt = Fromage(schedule)
    elif opt_name == "adagrad":
        opt = Adagrad(schedule, eps=eps)
    elif opt_name == "adafactor":
        opt = Adafactor(schedule)
    elif opt_name == "novograd":
        opt = NovoGrad(schedule, beta1, beta2, eps, weight_decay)
    elif opt_name == "lion":
        opt = Lion(schedule, weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {opt_name}")
    if grad_clip_norm is not None:
        opt = ClipByGlobalNorm(opt, grad_clip_norm)
    return opt


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """In place: ema = ema * decay + params * (1 - decay) (timm ModelEmaV2)."""
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].detach() for n in names], alpha=1.0 - decay)
