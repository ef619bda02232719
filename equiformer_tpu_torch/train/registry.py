"""OCP-style registry, by kind and name.

Counterpart of ``equiformer_tpu.train.registry`` for the one kind the port
has, "logger": the builtins "file", "jsonl" and "wandb" of
``utils/logger.py``.  The OC20 trainer, tasks and dataset add their kinds
when they are ported (M11).
"""

from __future__ import annotations

from typing import Callable, Dict

from ..utils.logger import FileLogger, MetricsWriter, WandBLogger

_REGISTRIES: Dict[str, Dict[str, Callable]] = {
    "logger": {"file": FileLogger, "jsonl": MetricsWriter, "wandb": WandBLogger},
}


def register(kind: str, name: str):
    def deco(obj):
        _REGISTRIES[kind][name] = obj
        return obj

    return deco


def get(kind: str, name: str):
    try:
        return _REGISTRIES[kind][name]
    except KeyError:
        raise KeyError(f"unknown {kind} {name!r}; available: "
                       f"{sorted(_REGISTRIES.get(kind, ()))}")
