"""Graph substrate of the port: generators, the degreeing pass and edge-list I/O."""
from repro_torch.graph.generators import (
    complete,
    erdos_renyi,
    paper_dataset,
    paper_dataset_names,
    random_geometric,
    ring,
    rmat,
    star,
    zipf,
)
from repro_torch.graph.io import load_edges, save_edges
from repro_torch.graph.preprocess import EdgeList, degree_and_densify

__all__ = [
    "rmat",
    "zipf",
    "erdos_renyi",
    "ring",
    "star",
    "random_geometric",
    "complete",
    "paper_dataset",
    "paper_dataset_names",
    "degree_and_densify",
    "EdgeList",
    "save_edges",
    "load_edges",
]
