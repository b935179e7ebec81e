"""EmbeddingService — the 1-shard special case of `ServingEngine`
(the port's copy of `repro.serving.service`).

.. deprecated::
    The serving subsystem's front door is now
    `repro_torch.serving.ServingEngine`: a deployment with a shard router
    (Z rows partitioned across `EmbeddingShard` workers), a durable
    write-ahead delta log with crash recovery, and an async
    flush/checkpoint loop.  `EmbeddingService` remains as a thin
    compat shim — exactly `ServingEngine(store, num_shards=1,
    data_dir=None)` — so existing single-host, volatile callers keep
    working unchanged.  New code should construct a `ServingEngine`
    (and pass `data_dir=` to get durability for free).

Everything documented here in earlier revisions — the version/epoch
model, the delta-vs-rebuild policy, partial_fit exactness by GEE
linearity, cold starts as plan-cache hits — now lives on the engine
and applies to every shard count; see `repro_torch.serving.engine`.
"""
from __future__ import annotations

import warnings
from typing import Union

import torch

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.store import GraphStore


class EmbeddingService(ServingEngine):
    """Serves Z for a live graph; delta-maintains, rebuilds on churn.

    Deprecated compat shim: the 1-shard, volatile (no WAL, no
    snapshots) configuration of :class:`ServingEngine`.  The legacy
    surface — ``Z``, ``Wv``, ``Y_epoch``, ``embedder``, ``churn``,
    ``apply_edge_delta`` / ``apply_label_delta``, ``compact`` /
    ``refresh``, ``centroids`` / ``normalized_Z`` — is the engine's
    own; nothing is re-implemented here."""

    def __init__(self, store: GraphStore, *, rebuild_churn: float = 0.05,
                 chunk_size: int = 1 << 20, backend: str = "streaming",
                 plan_cache=None,
                 device: Union[str, torch.device] = "cuda"):
        warnings.warn(
            "EmbeddingService is deprecated: construct "
            "repro_torch.serving.ServingEngine (this shim is exactly "
            "ServingEngine(store, num_shards=1, data_dir=None))",
            DeprecationWarning, stacklevel=2)
        super().__init__(store, data_dir=None, num_shards=1,
                         rebuild_churn=rebuild_churn,
                         chunk_size=chunk_size, backend=backend,
                         plan_cache=plan_cache, device=device)
