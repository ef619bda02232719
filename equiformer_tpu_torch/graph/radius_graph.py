"""Static-capacity radius graph for fixed-slot batches, without a host sync.

Counterpart of ``equiformer_tpu.graph.radius_graph.radius_graph_dense``.  The
edge order is exactly the JAX package's: row-major nonzero over ``(g, i, j)``
of the per-graph adjacency, dst = ``g*M + i``, src = ``g*M + j``, padded to
``max_edges`` with the last slot ``(G-1, M-1, M-1)``.  So dst is
non-decreasing (the CSR kernels rely on it) and edge-level tensors compare
with the reference row by row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .segment import take_rows


class EdgeList(NamedTuple):
    src: torch.Tensor  # [E_cap] int64
    dst: torch.Tensor  # [E_cap] int64, non-decreasing
    mask: torch.Tensor  # [E_cap] bool
    rev: Optional[torch.Tensor] = None  # [E_cap] int64, position of each edge's twin


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


def reverse_edge_perm_dense(edges: EdgeList, graphs: int, M: int) -> torch.Tensor:
    """Position of each edge's reverse twin in the dense-collate edge list.

    The radius adjacency is symmetric, so every real edge (g, i, j) has its
    twin (g, j, i) in the list: ``edges.src[rev[e]] == edges.dst[e]`` for real
    edges.  Padded edges all sit on the slot (G-1, M-1, M-1) and map to one
    of the padded edges, as JAX's ``.at[flat].set(..., mode="drop")`` leaves
    them; their cotangents are zero.
    """
    E = edges.src.shape[0]
    g = edges.dst // M
    i = edges.dst % M
    j = edges.src % M
    idx = torch.zeros(graphs * M * M, dtype=torch.int64, device=edges.dst.device)
    idx.scatter_(0, (g * M + i) * M + j, torch.arange(E, device=edges.dst.device))
    return idx[(g * M + j) * M + i]


def edge_vectors(pos: torch.Tensor, edges: EdgeList, eps: float = 1e-12):
    """Edge displacement ``pos[src] - pos[dst]`` and its length; padded edges
    get zero vectors and zero length.  The gathers are ``take_rows``, so the
    position gradient of a force model is two sorted segment sums over dst
    (the src side through the rev twin, which ``edges.rev`` must hold), as
    JAX's ``take_rows`` primitives give it, and not autograd's scatter-add."""
    if edges.rev is None:
        raise ValueError("edge_vectors needs edges.rev (reverse_edge_perm_dense)")
    vec = (take_rows(pos, edges.src, edges.dst, edges.rev)
           - take_rows(pos, edges.dst, edges.dst))
    vec = torch.where(edges.mask[:, None], vec, torch.zeros_like(vec))
    length = torch.sqrt(torch.clamp(torch.sum(vec * vec, dim=-1), min=eps))
    length = torch.where(edges.mask, length, torch.zeros_like(length))
    return vec, length
