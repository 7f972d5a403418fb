"""Graph substrate of the port: generators and the degreeing pass."""
from repro_torch.graph.generators import erdos_renyi, ring, rmat, star, zipf
from repro_torch.graph.preprocess import EdgeList, degree_and_densify

__all__ = [
    "rmat",
    "zipf",
    "erdos_renyi",
    "ring",
    "star",
    "degree_and_densify",
    "EdgeList",
]
