"""Checkpoints: weights-only npz files in the JAX package's format, and the
full training state with resume.

Counterparts of ``equiformer_tpu.train.checkpoint``:

* ``save_params`` / ``load_params`` read and write JAX's npz: one array per
  parameter under its '/'-joined flax path with the ``params`` root
  (``params/block_0/ga/alpha_dot``), each in the JAX layout (a Dense
  ``kernel`` [in, out]; ``utils.convert_jax.params_to_jax``).  A
  ``best_val.npz`` written by either package loads into the other.
* ``CheckpointManager`` keeps the whole ``TrainState`` (parameters,
  optimizer state, EMA copy, step) and JSON metadata per step, one
  ``torch.save`` file a step in place of orbax's directories.  A save
  writes a temporary file and renames it into place (``os.replace``), so a
  save cut midway leaves the last complete step as ``latest_step()``;
  ``max_to_keep`` removes the oldest steps, as orbax does.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.convert_jax import flax_paths, params_to_jax
from .state import TrainState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _flat_keys(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat_keys(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def save_params(path: str, params: Union[torch.nn.Module, Mapping]) -> None:
    """Write one npz file: ``params`` a module (its parameters, under the
    ``params`` root that JAX's ``model.init`` puts them in) or a JAX-layout
    tree such as ``{"params": params_to_jax(model, state.ema)}``."""
    if isinstance(params, torch.nn.Module):
        params = {"params": params_to_jax(params)}
    arrays = {k: np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
              for k, v in _flat_keys(params).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_params(path: str, model: torch.nn.Module) -> int:
    """Load an npz file of JAX's format into ``model``'s parameters, in place
    and in each parameter's dtype; returns the number of arrays read.
    Raises ``KeyError`` for a parameter the file lacks and ``ValueError``
    for a shape mismatch (shapes in JAX's layout), as JAX's
    ``load_params``."""
    targets = dict(model.named_parameters())
    with np.load(path) as data, torch.no_grad():
        for name, fpath in flax_paths(model).items():
            key = "/".join(("params",) + fpath)
            if key not in data:
                raise KeyError(f"checkpoint missing parameter {key}")
            arr, t = data[key], targets[name]
            kernel = fpath[-1] == "kernel"
            shape = tuple(t.shape[::-1]) if kernel else tuple(t.shape)
            if arr.shape != shape:
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {shape}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr.T if kernel else arr)))
    return len(targets)


def _restore_into(template, value, where: str):
    """``value`` (as loaded) in ``template``'s structure: tensors copied in
    place into the template's (keeping its device and dtype), dicts matched
    key by key, other leaves taken as they are."""
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor) or value.shape != template.shape:
            raise ValueError(f"{where}: checkpoint holds {getattr(value, 'shape', value)!r}, "
                             f"the state {tuple(template.shape)}")
        template.copy_(value)
        return template
    if isinstance(template, dict):
        if not isinstance(value, dict) or set(value) != set(template):
            raise ValueError(f"{where}: checkpoint keys {sorted(value)} != the state's "
                             f"{sorted(template)}")
        for k in template:
            template[k] = _restore_into(template[k], value[k], f"{where}.{k}")
        return template
    return value


class CheckpointManager:
    """Full training state per step in ``directory`` (``<step>.pt``), the
    newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: TrainState, metadata: Optional[Dict] = None) -> None:
        payload = {
            "params": {n: p.detach() for n, p in state.model.named_parameters()},
            "opt_state": state.opt_state,
            "ema": state.ema,
            "step": int(state.step),
            "metadata": None if metadata is None else json.dumps(metadata),
        }
        tmp = os.path.join(self.directory, f".{step}.pt.tmp")
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state_template: TrainState, step: Optional[int] = None):
        """(state, metadata) of ``step`` (default the latest), read into
        ``state_template`` in place on its device; (None, None) when there
        is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        device = next(state_template.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        with torch.no_grad():
            _restore_into(dict(state_template.model.named_parameters()), payload["params"],
                          "params")
            state_template.opt_state = _restore_into(state_template.opt_state,
                                                     payload["opt_state"], "opt_state")
            if state_template.ema is None or payload["ema"] is None:
                if (state_template.ema is None) != (payload["ema"] is None):
                    raise ValueError("ema: the checkpoint and the state disagree on whether "
                                     "there is an EMA copy")
            else:
                _restore_into(state_template.ema, payload["ema"], "ema")
        state_template.step = payload["step"]
        meta = payload["metadata"]
        return state_template, None if meta is None else json.loads(meta)

    def close(self) -> None:
        """Nothing to wait for: every save is complete when it returns."""
