from .batching import GraphsTuple, collate_dense
from .radius_graph import EdgeList, edge_vectors, radius_graph_dense, reverse_edge_perm_dense
from .segment import (
    active_edge_bound,
    gather_add,
    scaled_scatter_sum,
    segment_softmax,
    segment_sum,
    take_rows,
)
