"""Online GEE serving deployment, in PyTorch (the port of
`repro.serving`).

* `ServingEngine` (`engine.py`): the front door, a shard router over N
  `EmbeddingShard` workers (`shard.py`), a durable write-ahead delta log
  (`wal.py`) and an asynchronous flush and checkpoint loop (`start()`).
* `GraphStore` (`store.py`): the versioned edge multiset and delta log
  the engine serializes.
* `MicroBatcher` (`batcher.py`): read coalescing and write barriers.
* `EmbeddingService` (`service.py`): the deprecated 1-shard volatile
  special case of `ServingEngine`.
* `queries`: the read paths (gathers, centroid prediction, top-k).

The command-line workload is ``python -m repro_torch.serving.server``.  Version and
epoch mean what they mean in the reference: `version` counts applied
deltas, `epoch` counts the rebuilds under new labels.
"""
from repro_torch.serving import queries
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.service import EmbeddingService
from repro_torch.serving.shard import EmbeddingShard
from repro_torch.serving.store import GraphStore
from repro_torch.serving.wal import WriteAheadLog

__all__ = ["GraphStore", "ServingEngine", "EmbeddingShard",
           "EmbeddingService", "MicroBatcher", "WriteAheadLog", "queries"]
