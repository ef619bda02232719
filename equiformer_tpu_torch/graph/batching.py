"""Fixed-slot packing of molecular graphs into static-shape batches.

``collate_dense`` is the counterpart of ``equiformer_tpu.graph.batching
.collate_dense``: graph ``g`` owns node slots ``[g*M, (g+1)*M)``, so
``batch[i] == i // M`` and the per-graph radius graph
(``graph.radius_graph.radius_graph_dense``) needs no node sort.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class GraphsTuple:
    """A padded batch of graphs in flat layout (all torch tensors).

      pos        [N, 3] float
      species    [N]    int64 (atom type id)
      batch      [N]    int64 (graph index; padding slots are masked out)
      node_mask  [N]    bool
      graph_mask [G]    bool
      y          [G]    float per-graph targets
      forces     [N, 3] float per-atom force targets (MD17), or None
      extras     dict of further tensors by name (DeNS: ``force``,
                 ``noise_mask``, ``denoising_pos_mask``, ``noise_vec``;
                 ``models/dens.py``), empty by default
    """

    pos: torch.Tensor
    species: torch.Tensor
    batch: torch.Tensor
    node_mask: torch.Tensor
    graph_mask: torch.Tensor
    y: Optional[torch.Tensor] = None
    forces: Optional[torch.Tensor] = None
    extras: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "GraphsTuple":
        """Move every tensor, the extras' too, to ``device``; ``dtype``
        recasts the float fields (masks and indices keep theirs)."""
        def mv(t):
            if t is None:
                return None
            if dtype is not None and t.is_floating_point():
                return t.to(device=device, dtype=dtype)
            return t.to(device=device)

        fields = {f.name: mv(getattr(self, f.name)) for f in dataclasses.fields(self)
                  if f.name != "extras"}
        return GraphsTuple(**fields, extras={k: mv(v) for k, v in self.extras.items()})


def collate_dense(
    graphs: Sequence[Dict[str, np.ndarray]],
    max_nodes_per_graph: int,
    graph_capacity: Optional[int] = None,
    with_forces: bool = False,
    extra_node_keys: Sequence[str] = (),
    extra_graph_keys: Sequence[str] = (),
) -> GraphsTuple:
    """Pack graphs (dicts with 'pos', 'species', optional 'y', and 'forces'
    when ``with_forces``) into G*M slots; padded slots get zero forces.
    The arrays of ``extra_node_keys`` (one row an atom) and
    ``extra_graph_keys`` (one a graph) go into ``extras`` in their own
    dtypes, zero on the padding."""
    g_cap = graph_capacity if graph_capacity is not None else len(graphs)
    if len(graphs) > g_cap:
        raise ValueError(f"{len(graphs)} graphs > capacity {g_cap}")
    M = max_nodes_per_graph
    n_cap = g_cap * M
    pos = np.zeros((n_cap, 3), np.float32)
    species = np.zeros((n_cap,), np.int64)
    node_mask = np.zeros((n_cap,), bool)
    graph_mask = np.zeros((g_cap,), bool)
    y = np.zeros((g_cap,), np.float32)
    forces = np.zeros((n_cap, 3), np.float32) if with_forces else None
    extras: Dict[str, np.ndarray] = {}
    for k in extra_node_keys:
        proto = np.asarray(graphs[0][k])
        extras[k] = np.zeros((n_cap,) + proto.shape[1:], proto.dtype)
    for k in extra_graph_keys:
        proto = np.asarray(graphs[0][k])
        extras[k] = np.zeros((g_cap,) + proto.shape, proto.dtype)
    for gi, g in enumerate(graphs):
        n = int(g["pos"].shape[0])
        if n > M:
            raise ValueError(f"graph with {n} atoms > per-graph capacity {M}")
        i = gi * M
        pos[i : i + n] = g["pos"]
        species[i : i + n] = g["species"]
        node_mask[i : i + n] = True
        graph_mask[gi] = True
        if g.get("y") is not None:
            y[gi] = g["y"]
        if with_forces and "forces" in g:
            forces[i : i + n] = g["forces"]
        for k in extra_node_keys:
            extras[k][i : i + n] = g[k]
        for k in extra_graph_keys:
            extras[k][gi] = g[k]
    return GraphsTuple(
        pos=torch.from_numpy(pos),
        species=torch.from_numpy(species),
        batch=torch.arange(g_cap, dtype=torch.int64).repeat_interleave(M),
        node_mask=torch.from_numpy(node_mask),
        graph_mask=torch.from_numpy(graph_mask),
        y=torch.from_numpy(y),
        forces=None if forces is None else torch.from_numpy(forces),
        extras={k: torch.from_numpy(v) for k, v in extras.items()},
    )
