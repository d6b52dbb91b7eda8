"""Graph substrate: CSR structures, generators, ETL, partitioning (numpy)."""

from repro_torch.graph.csr import Graph
from repro_torch.graph.generators import (
    kronecker, path_graph, star_graph, torus_2d, uniform_random,
)
from repro_torch.graph.partition import PartitionedGraph, partition_1d

__all__ = [
    "Graph",
    "kronecker",
    "uniform_random",
    "torus_2d",
    "path_graph",
    "star_graph",
    "PartitionedGraph",
    "partition_1d",
]
