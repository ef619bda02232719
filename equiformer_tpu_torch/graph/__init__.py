from .batching import GraphsTuple, collate_dense
from .radius_graph import EdgeList, edge_vectors, radius_graph_dense
from .segment import active_edge_bound, scaled_scatter_sum, segment_softmax, segment_sum
