"""Load a JAX-package parameter tree into the port's modules.

``params_from_jax(model, tree)`` maps the nested dicts of arrays that
``equiformer_tpu``'s ``model.init`` returns onto ``model``'s parameters.
Module and parameter names follow the flax scopes, so the mapping is
mechanical:

* scopes join with '.' (``block_0/ga/sep_act/lin/w0`` ->
  ``block_0.ga.sep_act.lin.w0``);
* flax ``Dense`` ``kernel`` [in, out] -> torch ``Linear`` ``weight`` [out, in];
* flax ``LayerNorm`` ``scale`` -> torch ``LayerNorm`` ``weight``;
* the auto-named RBF scope ``GaussianRadialBasis_0`` -> ``rbf``.

Every leaf must be used exactly once and every port parameter set.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_SCOPE_RENAMES = {"GaussianRadialBasis_0": "rbf"}


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


def params_from_jax(model: torch.nn.Module, tree: Mapping) -> int:
    """Copy ``tree`` (optionally wrapped in ``{'params': ...}``) into ``model``
    in place, in the dtype of each port parameter.  Returns the number of
    leaves used; raises ``ValueError`` on any unused leaf, unset parameter
    or shape mismatch."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    leaves = _flatten(tree)
    params = dict(model.named_parameters())
    unset = set(params)
    unused = []
    with torch.no_grad():
        for path, arr in leaves.items():
            name = torch_name(path)
            p = params.get(name)
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
