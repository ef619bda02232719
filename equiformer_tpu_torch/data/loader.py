"""Batches of padded graphs over an in-memory graph list.

``equiformer_tpu.data.loader.GraphLoader`` in numpy, with its signature:
the same shuffle order for a seed, collated by ``graph.batching.collate``
(the packed layout, by default) or ``collate_dense`` (``dense_slots``) into
CPU tensors: collation is host work, and ``batch.to(device)`` moves a
batch to the card.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from ..graph.batching import GraphsTuple, collate, collate_dense


class GraphLoader:
    """Iterates padded ``GraphsTuple`` batches of ``batch_size`` graph slots.

    ``node_capacity`` (the packed layout's node rows) defaults to
    ``batch_size`` times the largest atom count, so no graph is ever
    dropped; ``dense_slots`` selects the fixed-slot layout with that many
    node slots a graph.  ``drop_last=False`` also yields the last partial
    batch, its empty graph slots masked out."""

    def __init__(
        self,
        graphs: Sequence[Dict[str, np.ndarray]],
        batch_size: int,
        node_capacity: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        with_forces: bool = False,
        extra_node_keys: Sequence[str] = (),
        extra_graph_keys: Sequence[str] = (),
        dense_slots: Optional[int] = None,
    ):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        if node_capacity is None:
            node_capacity = batch_size * max(int(g["pos"].shape[0]) for g in self.graphs)
        self.node_capacity = node_capacity
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.with_forces = with_forces
        self.extra_node_keys = tuple(extra_node_keys)
        self.extra_graph_keys = tuple(extra_graph_keys)
        self.dense_slots = dense_slots
        self.epoch = 0

    def __len__(self):
        if self.drop_last:
            return len(self.graphs) // self.batch_size
        return -(-len(self.graphs) // self.batch_size)

    def __iter__(self) -> Iterator[GraphsTuple]:
        order = np.arange(len(self.graphs))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        bs = self.batch_size
        kw = dict(graph_capacity=bs, with_forces=self.with_forces,
                  extra_node_keys=self.extra_node_keys, extra_graph_keys=self.extra_graph_keys)
        for i in range(0, len(order) - (bs - 1 if self.drop_last else 0), bs):
            chunk = [self.graphs[j] for j in order[i : i + bs]]
            if self.dense_slots is not None:
                yield collate_dense(chunk, max_nodes_per_graph=self.dense_slots, **kw)
            else:
                yield collate(chunk, node_capacity=self.node_capacity, **kw)
