"""Static-capacity radius graph for fixed-slot batches, without a host sync.

Counterpart of ``equiformer_tpu.graph.radius_graph.radius_graph_dense``.  The
edge order is exactly the JAX package's: row-major nonzero over ``(g, i, j)``
of the per-graph adjacency, dst = ``g*M + i``, src = ``g*M + j``, padded to
``max_edges`` with the last slot ``(G-1, M-1, M-1)``.  So dst is
non-decreasing (the CSR kernels rely on it) and edge-level tensors compare
with the reference row by row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EdgeList(NamedTuple):
    src: torch.Tensor  # [E_cap] int64
    dst: torch.Tensor  # [E_cap] int64, non-decreasing
    mask: torch.Tensor  # [E_cap] bool


def radius_graph_dense(
    pos: torch.Tensor,
    node_mask: torch.Tensor,
    graphs: int,
    r: float,
    max_edges: int,
) -> EdgeList:
    """All ordered pairs ``i != j`` within radius ``r`` inside each graph of a
    ``collate_dense`` batch (``batch[i] == i // M``).

    ``torch.nonzero`` has a data-dependent size, which would stall the host
    on a GPU.  Instead each set entry of the flat adjacency is scattered to
    its rank (an inclusive cumsum minus one); entries ranked past
    ``max_edges`` are dropped, as ``jnp.nonzero(size=...)`` drops them.
    """
    n = pos.shape[0]
    M = n // graphs
    posg = pos.reshape(graphs, M, 3)
    maskg = node_mask.reshape(graphs, M)
    diff = posg[:, :, None, :] - posg[:, None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    adj = d2 < (r * r)
    adj &= maskg[:, :, None] & maskg[:, None, :]
    adj &= ~torch.eye(M, dtype=torch.bool, device=pos.device)[None]
    flat = adj.reshape(-1)
    rank = torch.cumsum(flat, 0) - 1
    keep = flat & (rank < max_edges)
    # entries not kept land in a spare slot past the end, which is cut off
    slot = torch.where(keep, rank, torch.full_like(rank, max_edges))
    fill = graphs * M * M - 1  # (G-1, M-1, M-1)
    idx = torch.full((max_edges + 1,), fill, dtype=torch.int64, device=pos.device)
    idx.scatter_(0, slot, torch.arange(flat.shape[0], device=pos.device))
    idx = idx[:max_edges]
    g = idx // (M * M)
    i = (idx // M) % M
    j = idx % M
    num = flat.sum()
    mask = torch.arange(max_edges, device=pos.device) < num
    return EdgeList(src=g * M + j, dst=g * M + i, mask=mask)


def edge_vectors(pos: torch.Tensor, edges: EdgeList, eps: float = 1e-12):
    """Edge displacement ``pos[src] - pos[dst]`` and its length; padded edges
    get zero vectors and zero length."""
    vec = pos[edges.src] - pos[edges.dst]
    vec = torch.where(edges.mask[:, None], vec, torch.zeros_like(vec))
    length = torch.sqrt(torch.clamp(torch.sum(vec * vec, dim=-1), min=eps))
    length = torch.where(edges.mask, length, torch.zeros_like(length))
    return vec, length
