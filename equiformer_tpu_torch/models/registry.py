"""Model registry: entrypoints by name, as in the JAX package."""

from __future__ import annotations

from typing import Callable, Dict

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

