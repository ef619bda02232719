"""Model registry: entrypoints by name, as in the JAX package."""

from __future__ import annotations

from typing import Callable, Dict

import torch

_MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    if fn.__name__ in _MODEL_REGISTRY:
        raise ValueError(f"duplicate model entrypoint {fn.__name__}")
    _MODEL_REGISTRY[fn.__name__] = fn
    return fn


def model_entrypoint(name: str) -> Callable:
    if name not in _MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[name]


def resolve_device(device=None) -> torch.device:
    """``device``, or the first CUDA device when it is None.  Raises when no
    GPU is present: an entry point never falls back to the CPU on its own
    (pass ``device="cpu"`` for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the CPU")
    return torch.device("cuda")
