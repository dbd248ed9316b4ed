from .structure import (GRAPH_ARRAYS, EdgeView, Graph, build_graph,
                        graph_from_arrays, pad_values, resolve_device)
from .generators import (STANDIN_SPECS, erdos_renyi, kronecker, ring,
                         road_grid, standin, star)
from .partition import Partition, PartitionedEdges, pa_split, partition_1d
from .sampling import SampledBlocks, sample_blocks, sample_neighbors

__all__ = [
    "Graph", "EdgeView", "build_graph", "graph_from_arrays", "pad_values",
    "resolve_device", "GRAPH_ARRAYS", "kronecker", "erdos_renyi",
    "road_grid", "ring", "star", "standin", "STANDIN_SPECS",
    "Partition", "partition_1d", "PartitionedEdges", "pa_split",
    "SampledBlocks", "sample_neighbors", "sample_blocks",
]
