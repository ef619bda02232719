"""Training state: the module's parameters, optimizer state, EMA, step."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class TrainState:
    """``model`` holds the parameters; ``ema`` is a separate copy of them
    (never aliasing the parameters); ``step`` counts applied updates.  The
    train step updates everything in place."""

    model: torch.nn.Module
    opt_state: dict
    ema: Optional[Dict[str, torch.Tensor]]
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer, use_ema: bool = True) -> "TrainState":
        ema = None
        if use_ema:
            ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        return cls(model=model, opt_state=optimizer.init(model), ema=ema)

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())
