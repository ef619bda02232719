"""Batches of fixed-slot graphs over an in-memory graph list.

The ``dense_slots`` path of ``equiformer_tpu.data.loader.GraphLoader``, in
numpy: the same shuffle order for a seed, collated by
``graph.batching.collate_dense`` into CPU tensors: collation is host work,
and ``batch.to(device)`` moves a batch to the card.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

from ..graph.batching import GraphsTuple, collate_dense


class GraphLoader:
    """Full batches only (a last partial batch is dropped)."""

    def __init__(self, graphs: Sequence[Dict[str, np.ndarray]], batch_size: int,
                 dense_slots: int, shuffle: bool = True, seed: int = 0,
                 with_forces: bool = False):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.dense_slots = dense_slots
        self.shuffle = shuffle
        self.seed = seed
        self.with_forces = with_forces
        self.epoch = 0

    def __len__(self):
        return len(self.graphs) // self.batch_size

    def __iter__(self) -> Iterator[GraphsTuple]:
        order = np.arange(len(self.graphs))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        bs = self.batch_size
        for i in range(0, len(order) - (bs - 1), bs):
            yield collate_dense([self.graphs[j] for j in order[i : i + bs]],
                                max_nodes_per_graph=self.dense_slots, graph_capacity=bs,
                                with_forces=self.with_forces)
