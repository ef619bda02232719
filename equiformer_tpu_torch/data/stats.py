"""Dataset statistics: average nodes, edges and degree over the radius graph.

Counterpart of ``equiformer_tpu.data.stats`` (numpy only): the numbers the
models bake in as ``avg_num_nodes`` / ``avg_degree``.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np


def compute_stats(graphs: Sequence[Dict], radius: float, max_neighbors: Optional[int] = None,
                  use_pbc: bool = False, n_rep: int = 1) -> Dict[str, float]:
    """avg_nodes / avg_edges / avg_degree.  ``max_neighbors`` keeps each
    atom's nearest neighbors only; with ``use_pbc`` an atom's neighbor count
    includes the lattice images within +-``n_rep`` cells (the graphs need a
    'cell' key), OC20's semantics: there ``max_neighbors`` caps the count."""
    total_nodes = total_edges = n_graphs = 0
    for g in graphs:
        pos = np.asarray(g["pos"], np.float64)
        n = len(pos)
        if use_pbc:
            cell = np.asarray(g["cell"], np.float64)
            offs = np.array(
                list(itertools.product(range(-n_rep, n_rep + 1), repeat=3)), np.float64
            ) @ cell  # [C, 3]
            diff = pos[:, None, None, :] - pos[None, :, None, :] - offs[None, None]
            within = np.linalg.norm(diff, axis=-1) < radius  # [n, n, C]
            # an atom is not its own neighbor in the zero-offset image
            ci = int(np.argmax(np.all(np.abs(offs) < 1e-12, axis=1)))
            within[np.arange(n), np.arange(n), ci] = False
            deg = within.sum(axis=(1, 2))
            if max_neighbors is not None:
                deg = np.minimum(deg, max_neighbors)
            edges = int(deg.sum())
        else:
            d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
            adj = (d < radius) & ~np.eye(n, dtype=bool)
            if max_neighbors is not None:
                deg = adj.sum(1)
                for i in np.where(deg > max_neighbors)[0]:
                    keep = np.argsort(np.where(adj[i], d[i], np.inf))[:max_neighbors]
                    row = np.zeros(n, bool)
                    row[keep] = True
                    adj[i] &= row
            edges = int(adj.sum())
        total_nodes += n
        total_edges += edges
        n_graphs += 1
    return {
        "avg_nodes": total_nodes / max(n_graphs, 1),
        "avg_edges": total_edges / max(n_graphs, 1),
        "avg_degree": total_edges / max(total_nodes, 1),
    }
