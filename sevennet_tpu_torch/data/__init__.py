from .graph import GraphBatch, dense_graph_from_arrays, densify_edges, graph_from_arrays
from .neighborlist import neighbor_list_numpy

__all__ = [
    "GraphBatch",
    "dense_graph_from_arrays",
    "densify_edges",
    "graph_from_arrays",
    "neighbor_list_numpy",
]
