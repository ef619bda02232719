"""Static-capacity radius graphs in both layouts, without a host sync.

Counterparts of ``equiformer_tpu.graph.radius_graph``.  The edge order is
exactly the JAX package's: row-major nonzero of the adjacency with dst the
row, so dst is non-decreasing (the CSR kernels rely on it) and edge-level
tensors compare with the reference row by row.

- ``radius_graph`` (the packed layout of ``collate``): the [N, N]
  adjacency, padded to ``max_edges`` with the edge ``(N-1, N-1)``.
- ``radius_graph_dense`` (the fixed-slot layout of ``collate_dense``): the
  per-graph [G, M, M] adjacency, dst = ``g*M + i``, src = ``g*M + j``,
  padded with the last slot ``(G-1, M-1, M-1)``.

The src side of a gather's backward needs a sorted order of its own.  The
fixed-slot layout takes the reverse twin of each edge
(``reverse_edge_perm_dense``: summing over src is summing the twins over
dst).  The packed layout takes ``src_sort_plan``, a stable sort of src over
all edge slots: it stays exact where ``max_edges`` truncates the list and a
twin is missing, as the reference's unsorted scatter does.  Each layout
computes the reference's function for it: on an untruncated fixed-slot list
the plan would sum the same rows in the same order as the twins, but where
``max_edges`` truncates one, a kept edge whose twin was dropped sends its
src cotangent to the node of slot 0 in the reference, and the fixed-slot
step tests hold the port to that (the plan, exact there, differs from it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .segment import take_rows, take_src


class SrcSortPlan(NamedTuple):
    """A stable sort of an edge list's src, for the src side of a gather's
    backward: ``segsum(g[order], ids)`` is the sum of g over src."""

    order: torch.Tensor  # [E_cap] int64, the stable argsort of src
    order_inv: torch.Tensor  # [E_cap] int64, its inverse permutation
    ids: torch.Tensor  # [E_cap] int64, src[order], non-decreasing


class EdgeList(NamedTuple):
    src: torch.Tensor  # [E_cap] int64
    dst: torch.Tensor  # [E_cap] int64, non-decreasing
    mask: torch.Tensor  # [E_cap] bool
    rev: Optional[torch.Tensor] = None  # [E_cap] int64, position of each edge's twin
    src_plan: Optional[SrcSortPlan] = None  # the packed layout's src order


def _compact(flat: torch.Tensor, max_edges: int, fill: int):
    """``jnp.nonzero(flat, size=max_edges, fill_value=fill)`` of a flat
    adjacency, and the mask of the real entries.  ``torch.nonzero`` has a
    data-dependent size, which would stall the host on a GPU; instead each
    set entry is scattered to its rank (an inclusive cumsum minus one), and
    entries ranked past ``max_edges`` are dropped."""
    rank = torch.cumsum(flat, 0) - 1
    keep = flat & (rank < max_edges)
    # entries not kept land in a spare slot past the end, which is cut off
    slot = torch.where(keep, rank, torch.full_like(rank, max_edges))
    idx = torch.full((max_edges + 1,), fill, dtype=torch.int64, device=flat.device)
    idx.scatter_(0, slot, torch.arange(flat.shape[0], device=flat.device))
    mask = torch.arange(max_edges, device=flat.device) < flat.sum()
    return idx[:max_edges], mask


def radius_graph(
    pos: torch.Tensor,
    batch: torch.Tensor,
    node_mask: torch.Tensor,
    r: float,
    max_edges: int,
) -> EdgeList:
    """All ordered pairs ``src != dst`` within radius ``r`` inside the same
    graph of a ``collate`` batch (``batch`` [N]: graph index a node).  Edges
    past ``max_edges`` are dropped, and the padding edges are ``(N-1, N-1)``."""
    n = pos.shape[0]
    diff = pos[:, None, :] - pos[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    adj = d2 < (r * r)
    adj &= batch[:, None] == batch[None, :]
    adj &= node_mask[:, None] & node_mask[None, :]
    adj &= ~torch.eye(n, dtype=torch.bool, device=pos.device)
    idx, mask = _compact(adj.reshape(-1), max_edges, n * n - 1)
    return EdgeList(src=idx % n, dst=idx // n, mask=mask)


def radius_graph_dense(
    pos: torch.Tensor,
    node_mask: torch.Tensor,
    graphs: int,
    r: float,
    max_edges: int,
) -> EdgeList:
    """All ordered pairs ``i != j`` within radius ``r`` inside each graph of
    a ``collate_dense`` batch (``batch[i] == i // M``); edges past
    ``max_edges`` are dropped."""
    n = pos.shape[0]
    M = n // graphs
    posg = pos.reshape(graphs, M, 3)
    maskg = node_mask.reshape(graphs, M)
    diff = posg[:, :, None, :] - posg[:, None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    adj = d2 < (r * r)
    adj &= maskg[:, :, None] & maskg[:, None, :]
    adj &= ~torch.eye(M, dtype=torch.bool, device=pos.device)[None]
    idx, mask = _compact(adj.reshape(-1), max_edges, graphs * M * M - 1)
    g = idx // (M * M)
    i = (idx // M) % M
    j = idx % M
    return EdgeList(src=g * M + j, dst=g * M + i, mask=mask)


def src_sort_plan(edges: EdgeList) -> SrcSortPlan:
    """The src order of an edge list, over all its slots, padding included.
    Real edges come out dst-first row-major, so each node's src-side
    cotangents are summed in increasing dst: the order in which the twin
    route sums them in the fixed-slot layout."""
    order = torch.argsort(edges.src, stable=True)
    order_inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    return SrcSortPlan(order=order, order_inv=order_inv, ids=edges.src[order])


def build_edges(pos: torch.Tensor, batch: torch.Tensor, node_mask: torch.Tensor, graphs: int,
                r: float, max_edges: int, nodes_per_graph: int) -> EdgeList:
    """The models' radius graph, by layout as JAX's ``build_graph``: with
    ``nodes_per_graph`` > 0 the fixed-slot one and its reverse twins, else
    the packed one and its src-sort plan."""
    if nodes_per_graph > 0:
        if pos.shape[0] != graphs * nodes_per_graph:
            raise ValueError(f"{pos.shape[0]} nodes != {graphs} graphs x {nodes_per_graph} "
                             "slots")
        edges = radius_graph_dense(pos, node_mask, graphs, r, max_edges)
        # reverse twins: the src cotangents ride a sorted sum over dst
        return edges._replace(rev=reverse_edge_perm_dense(edges, graphs, nodes_per_graph))
    edges = radius_graph(pos, batch, node_mask, r, max_edges)
    return edges._replace(src_plan=src_sort_plan(edges))


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
    position gradient of a force model is two sorted segment sums, as JAX's
    ``take_rows`` primitives give it, and not autograd's scatter-add: over
    dst, and over src through ``edges.rev`` (fixed-slot) or
    ``edges.src_plan`` (packed), one of which the edge list must hold."""
    vec = (take_src(pos, edges.src, edges.dst, edges.rev, edges.src_plan)
           - take_rows(pos, edges.dst, edges.dst))
    vec = torch.where(edges.mask[:, None], vec, torch.zeros_like(vec))
    length = torch.sqrt(torch.clamp(torch.sum(vec * vec, dim=-1), min=eps))
    length = torch.where(edges.mask, length, torch.zeros_like(length))
    return vec, length
