"""Batches of padded graphs over an in-memory graph list.

``equiformer_tpu.data.loader`` in numpy and C++, with its signature: the
same shuffle order for a seed, the same shards, collated by
``graph.batching.collate`` (the packed layout, by default),
``collate_dense`` (``dense_slots``) or, on the fixed-slot layout without
extra keys, the native ``GraphArena`` (``native/``), into CPU tensors:
collation is host work, and ``batch.to(device)`` moves a batch to the card.
``prefetch`` collates the next batches on a background thread.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from .. import native
from ..graph.batching import GraphsTuple, collate, collate_dense


class GraphLoader:
    """Iterates padded ``GraphsTuple`` batches of ``batch_size`` graph slots.

    ``node_capacity`` (the packed layout's node rows) defaults to
    ``batch_size`` times the largest atom count, so no graph is ever
    dropped; ``dense_slots`` selects the fixed-slot layout with that many
    node slots a graph.  ``drop_last=False`` also yields the last partial
    batch: numpy pads it to ``batch_size`` graph slots, its empty slots
    masked out, while the native arena (``use_native``, taken when the
    library is available, the layout is fixed-slot and there are no extra
    keys) gives it only the graphs it holds, as in JAX.

    ``num_shards`` > 1 iterates shard ``shard_index`` of each epoch's
    order: with ``balance="atoms"`` the graphs are assigned largest first to
    the shard with the fewest atoms, each shard capped at the round-robin
    count (``native.balanced_assign_capped``); with ``balance=None``
    round-robin."""

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
        num_shards: int = 1,
        shard_index: int = 0,
        dense_slots: Optional[int] = None,
        use_native: bool = True,
        balance: Optional[str] = "atoms",
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
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.dense_slots = dense_slots
        self.balance = balance
        self.epoch = 0
        self._arena = None
        if (use_native and native.HAVE_NATIVE and dense_slots is not None
                and not extra_node_keys and not extra_graph_keys):
            try:
                self._arena = native.GraphArena(self.graphs, with_forces=with_forces)
            except (KeyError, ValueError):
                self._arena = None

    def __len__(self):
        n = len(self.graphs) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.graphs))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        if self.num_shards > 1 and self.balance == "atoms":
            sizes = np.array([self.graphs[j]["pos"].shape[0] for j in order], np.int64)
            n, s = len(order), self.num_shards
            caps = np.full(s, n // s, np.int64)
            caps[: n % s] += 1
            return order[native.balanced_assign_capped(sizes, s, caps) == self.shard_index]
        return order[self.shard_index :: self.num_shards]

    def __iter__(self) -> Iterator[GraphsTuple]:
        order = self._order()
        bs = self.batch_size
        kw = dict(graph_capacity=bs, with_forces=self.with_forces,
                  extra_node_keys=self.extra_node_keys, extra_graph_keys=self.extra_graph_keys)
        for i in range(0, len(order) - (bs - 1 if self.drop_last else 0), bs):
            if self._arena is not None:
                yield self._arena.collate_dense(order[i : i + bs], self.dense_slots)
                continue
            chunk = [self.graphs[j] for j in order[i : i + bs]]
            if self.dense_slots is not None:
                yield collate_dense(chunk, max_nodes_per_graph=self.dense_slots, **kw)
            else:
                yield collate(chunk, node_capacity=self.node_capacity, **kw)


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """The items of ``iterator`` in order, produced up to ``size`` ahead on a
    background thread, so that host collation overlaps device work.  An
    exception of the iterator is raised here, after the items before it."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put((item, None))
        except Exception as e:  # raised again in the consumer's thread
            q.put((sentinel, e))
            return
        q.put((sentinel, None))

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item, err = q.get()
        if err is not None:
            raise err
        if item is sentinel:
            return
        yield item
