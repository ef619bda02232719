"""Load a JAX-package parameter tree into the port's modules.

``params_from_jax(model, tree)`` maps the nested dicts of arrays that
``equiformer_tpu``'s ``model.init`` returns onto ``model``'s parameters;
``ema_from_jax(state, tree)`` does the same for a ``TrainState``'s EMA copy;
``params_to_jax(model)`` is the inverse (the module's parameters, or a dict
of named tensors such as the EMA copy, as a JAX tree); ``flax_paths(model)``
gives each port parameter's flax path (the weight decay mask reads it).
Module and parameter names follow the flax scopes, so the mapping is
mechanical:

* scopes join with '.' (``block_0/ga/sep_act/lin/w0`` ->
  ``block_0.ga.sep_act.lin.w0``);
* flax ``Dense`` ``kernel`` [in, out] -> torch ``Linear`` ``weight`` [out, in];
* flax ``LayerNorm`` ``scale`` -> torch ``LayerNorm`` ``weight``;
* the auto-named RBF scopes ``GaussianRadialBasis_0`` and
  ``BesselRadialBasis_0`` -> ``rbf`` (the exp basis has no parameters).

Every leaf must be used exactly once and every port parameter set.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_SCOPE_RENAMES = {"GaussianRadialBasis_0": "rbf", "BesselRadialBasis_0": "rbf"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def torch_name(path: tuple) -> str:
    """Port parameter name of one flax leaf path (without the 'params' root)."""
    parts = [_SCOPE_RENAMES.get(p, p) for p in path]
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    elif parts[-1] == "scale":
        parts[-1] = "weight"
    return ".".join(parts)


def flax_paths(model: torch.nn.Module) -> Dict[str, tuple]:
    """Flax path (without the 'params' root) of every port parameter: the
    inverse of ``torch_name``."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        owner = model.get_submodule(".".join(parts[:-1]))
        leaf = parts[-1]
        if leaf == "weight" and isinstance(owner, torch.nn.Linear):
            leaf = "kernel"
        elif leaf == "weight" and isinstance(owner, torch.nn.LayerNorm):
            leaf = "scale"
        # the RBF's auto-named flax scope is its class name
        path = tuple(f"{type(model.get_submodule('.'.join(parts[: i + 1]))).__name__}_0"
                     if p in _SCOPE_RENAMES.values() else p
                     for i, p in enumerate(parts[:-1])) + (leaf,)
        if torch_name(path) != name:
            raise ValueError(f"{name}: no flax path maps back to it")
        out[name] = path
    return out


def load_jax_tree(targets: Dict[str, torch.Tensor], tree: Mapping) -> int:
    """Copy ``tree`` (optionally wrapped in ``{'params': ...}``) into the
    named tensors ``targets`` in place, in the dtype of each target.  Returns
    the number of leaves used; raises ``ValueError`` on any unused leaf,
    unset target or shape mismatch."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    leaves = _flatten(tree)
    unset = set(targets)
    unused = []
    with torch.no_grad():
        for path, arr in leaves.items():
            name = torch_name(path)
            p = targets.get(name)
            if p is None or name not in unset:
                unused.append("/".join(path))
                continue
            if path[-1] == "kernel":
                arr = arr.T
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {arr.shape} != port shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
            unset.discard(name)
    if unused or unset:
        raise ValueError(f"unused JAX leaves {sorted(unused)}; unset port parameters {sorted(unset)}")
    return len(leaves)


def params_from_jax(model: torch.nn.Module, tree: Mapping) -> int:
    """Load a JAX parameter tree into ``model``'s parameters."""
    return load_jax_tree(dict(model.named_parameters()), tree)


def params_to_jax(model: torch.nn.Module,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The nested dict of numpy arrays that JAX's ``model.init`` gives under
    its ``params`` root: ``model``'s parameters, or ``tensors`` (named as
    they are, e.g. ``TrainState.ema``) on ``model``'s flax paths, each in its
    own dtype, each ``kernel`` back to [in, out].  ``params_from_jax`` of the
    result restores the same bits."""
    values = dict(model.named_parameters()) if tensors is None else tensors
    paths = flax_paths(model)
    if set(values) != set(paths):
        raise ValueError(f"tensors {sorted(set(values) ^ set(paths))} are not the module's "
                         f"parameters")
    tree: Dict[str, Any] = {}
    for name, path in paths.items():
        arr = values[name].detach().cpu().numpy()
        if path[-1] == "kernel":
            arr = np.ascontiguousarray(arr.T)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def ema_from_jax(state, tree: Mapping) -> int:
    """Load a JAX parameter tree (e.g. ``TrainState.ema_params``) into a
    port ``TrainState``'s EMA copy."""
    return load_jax_tree(state.ema, tree)
