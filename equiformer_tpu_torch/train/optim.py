"""AdamW with the reference's weight-decay mask, the cosine warmup schedule
and model EMA.

Counterparts of ``equiformer_tpu.train.optim``: ``create_optimizer("adamw")``
computes what ``optax.adamw(schedule, ..., mask=no_weight_decay_mask)`` does
— Adam moments, bias correction from step 1, ``eps`` outside the square
root, decoupled weight decay on the masked parameters, all scaled by the
scheduled learning rate — updating the parameters in place with PyTorch's
multi-tensor (``_foreach``) ops.  The rest of the JAX package's optimizer
zoo is not ported yet.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Sequence

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


class AdamW:
    """``optax.adamw`` with a weight-decay mask, on named parameters.

    ``init(params)`` returns the state (step count and the two moments);
    ``update(params, grads, state)`` applies one step in place.  The
    learning rate of step t (counting from 0) is ``schedule(t)``."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float = 5e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, model: torch.nn.Module) -> dict:
        params = dict(model.named_parameters())
        with torch.no_grad():
            return {
                "count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()},
                "decay": no_weight_decay_mask(model),
            }

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Sequence[torch.Tensor],
               state: dict) -> None:
        names = list(params)
        ps = [params[n] for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        lr = self.schedule(state["count"])
        state["count"] += 1
        c = state["count"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** c)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - self.b2 ** c))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        decay = [i for i, n in enumerate(names) if state["decay"][n]]
        if decay and self.weight_decay:
            torch._foreach_add_([upd[i] for i in decay], [ps[i] for i in decay],
                                alpha=self.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-lr)


def create_optimizer(schedule: Callable[[int], float], weight_decay: float = 5e-3,
                     beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                     opt_name: str = "adamw") -> AdamW:
    if opt_name != "adamw":
        raise NotImplementedError(f"optimizer {opt_name!r} is not ported (only 'adamw')")
    return AdamW(schedule, weight_decay, beta1, beta2, eps)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """In place: ema = ema * decay + params * (1 - decay) (timm ModelEmaV2)."""
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].detach() for n in names], alpha=1.0 - decay)
