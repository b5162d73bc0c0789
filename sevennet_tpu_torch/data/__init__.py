from .graph import (
    GraphBatch,
    batch_graphs,
    dense_graph_from_arrays,
    densify_edges,
    graph_from_arrays,
    pad_graph,
)
from .neighborlist import neighbor_list_numpy

__all__ = [
    "GraphBatch",
    "batch_graphs",
    "dense_graph_from_arrays",
    "densify_edges",
    "graph_from_arrays",
    "neighbor_list_numpy",
    "pad_graph",
]
