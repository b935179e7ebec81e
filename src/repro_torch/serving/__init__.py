"""Serving: a shard owning Z rows, and the query paths over it.

    from repro_torch.serving import EmbeddingShard, queries

The engine, its write-ahead log, store and batcher are not ported yet;
nothing here imports them.
"""
from repro_torch.serving import queries
from repro_torch.serving.shard import EmbeddingShard

__all__ = ["EmbeddingShard", "queries"]
