"""Edge lists, fingerprints, synthetic generators, graph files and
sources, and row partitions (numpy only)."""
from repro_torch.graph.edges import (FingerprintAccumulator, Graph,
                                     bucket_size, chunk_edges,
                                     edge_fingerprint, extend_fingerprint,
                                     make_labels)
from repro_torch.graph.generators import erdos_renyi, powerlaw, sbm
from repro_torch.graph.partition import RowPartition

__all__ = ["FingerprintAccumulator", "Graph", "RowPartition",
           "bucket_size", "chunk_edges", "edge_fingerprint",
           "erdos_renyi", "extend_fingerprint", "make_labels", "powerlaw",
           "sbm"]
