"""Edge lists, synthetic generators and row partitions (numpy only)."""
from repro_torch.graph.edges import Graph, bucket_size, chunk_edges, make_labels
from repro_torch.graph.generators import erdos_renyi, powerlaw, sbm
from repro_torch.graph.partition import RowPartition

__all__ = ["Graph", "RowPartition", "bucket_size", "chunk_edges",
           "erdos_renyi", "make_labels", "powerlaw", "sbm"]
