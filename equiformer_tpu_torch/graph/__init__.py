# the function radius_graph stays in its module: ``graph.radius_graph`` names the module
from .batching import GraphsTuple, cli_capacities, collate, collate_dense, edge_capacity_for
from .radius_graph import (
    EdgeList,
    SrcSortPlan,
    build_edges,
    edge_vectors,
    radius_graph_dense,
    reverse_edge_perm_dense,
    src_sort_plan,
)
from .segment import (
    active_edge_bound,
    gather_add,
    scaled_scatter_sum,
    segment_softmax,
    segment_sum,
    take_rows,
    take_src,
)
