from .graph import (
    GraphBatch,
    batch_graphs,
    dense_graph_device,
    dense_graph_from_arrays,
    densify_edges,
    graph_from_arrays,
    pad_graph,
    receiver_sorted,
)
from .neighborlist import neighbor_list_numpy, neighbor_list_scipy

__all__ = [
    "GraphBatch",
    "batch_graphs",
    "dense_graph_device",
    "dense_graph_from_arrays",
    "densify_edges",
    "graph_from_arrays",
    "neighbor_list_numpy",
    "neighbor_list_scipy",
    "pad_graph",
    "receiver_sorted",
]
