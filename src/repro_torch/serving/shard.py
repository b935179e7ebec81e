"""EmbeddingShard: one worker owning a contiguous slice of Z rows.

The port of `repro.serving.shard.EmbeddingShard`.  Shard i is the single
writer and reader of rows [lo, hi).  Every edge incident to an owned row is in the
shard's routed sub-multiset, so its slice is exact in isolation, and an
edge delta touches only the shards owning its endpoints.

A proper sub-range shard gives its Embedder
``EncoderConfig.row_partition=(lo, hi)``, so only the (hi - lo, K) rows
are held on the device; the full-range shard keeps an unpartitioned
Embedder.  With ``backend="cuda"`` the shard folds deltas through the
`gee_delta_renorm` kernel and answers top-k through `topk_fused`; the
other backends use `partial_fit` and the blocked scan.  On the same Z
the answers are bit-identical either way.

Each shard's Embedder takes the persistent plan cache (`plan_cache`,
"auto" by default: `encoder.plan_cache.default_cache()`), keyed by the
routed sub-multiset's chained fingerprint, so a recovered engine or an
epoch rebuild off unchanged content loads its plan from disk.  An
optional IVF index (`repro_torch.index`) covers the owned slice; the
engine owns its centroids and its re-quantization.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.encoder import Embedder, EncoderConfig
from repro_torch.encoder.plan_cache import PlanDiskCache
from repro_torch.graph.edges import Graph
from repro_torch.serving import queries as Q


class EmbeddingShard:
    """Owns Z rows [lo, hi); embeds and serves only its slice."""

    def __init__(self, shard_id: int, lo: int, hi: int, *, K: int,
                 n: Optional[int] = None, chunk_size: int = 1 << 20,
                 backend: str = "streaming",
                 plan_cache: Union[str, PlanDiskCache, None] = "auto",
                 device: Union[str, torch.device] = "cuda"):
        self.shard_id = int(shard_id)
        self.lo, self.hi = int(lo), int(hi)
        #: owned-rows mode: the Embedder accumulates ONLY [lo, hi)
        self.owned_only = (n is not None
                           and (self.lo, self.hi) != (0, int(n)))
        self.embedder = Embedder(
            EncoderConfig(K=int(K), chunk_size=int(chunk_size),
                          row_partition=((self.lo, self.hi)
                                         if self.owned_only else None)),
            backend=backend, plan_cache=plan_cache, device=device)
        #: cuda shards use the fused kernels for writes and reads
        self._fused = (backend == "cuda")
        self._Zn: Optional[torch.Tensor] = None
        #: the IVF index over the owned slice, or None (`build_index`)
        self._index = None

    @property
    def device(self) -> torch.device:
        return self.embedder.device

    # -- write path --------------------------------------------------------

    def build(self, graph_or_source, Y: np.ndarray) -> None:
        """(Re)fit on the routed sub-multiset (a Graph or a GraphSource)
        under GLOBAL labels `Y`."""
        self.embedder.fit(graph_or_source, Y)
        self._Zn = None
        if obs.enabled():
            # per-shard accumulator bytes shrink ~ n/p as shards are added
            obs.gauge("repro_serving_shard_accumulator_bytes",
                      self.accumulator_nbytes, shard=str(self.shard_id))

    def apply_delta(self, sub: Graph) -> None:
        """Fold a routed edge sub-batch into Z (exact by linearity).
        Cuda shards refill the Zn cache in the same kernel pass instead
        of invalidating it."""
        if sub.s:
            if self._fused:
                self._Zn = self.embedder.partial_fit_norm(sub)
            else:
                self.embedder.partial_fit(sub)
                self._Zn = None

    # -- read path (everything leaves in global coordinates) ---------------

    @property
    def Z_owned(self) -> torch.Tensor:
        """The owned (hi - lo, K) slice."""
        if self.owned_only:
            return self.embedder.Z_
        return self.embedder.Z_[self.lo:self.hi]

    @property
    def accumulator_nbytes(self) -> int:
        """Device bytes held by this shard's Z accumulator."""
        Z = self.embedder.Z_
        return 0 if Z is None else Z.numel() * Z.element_size()

    def rows(self, nodes: np.ndarray) -> torch.Tensor:
        """Z rows for OWNED global node ids (IndexError otherwise)."""
        nodes = np.asarray(nodes)
        if nodes.size and (nodes.min() < self.lo
                           or nodes.max() >= self.hi):
            raise IndexError(
                f"shard {self.shard_id} owns rows [{self.lo}, "
                f"{self.hi}), got range [{nodes.min()}, {nodes.max()}]")
        off = self.lo if self.owned_only else 0
        return self.embedder.Z_[torch.as_tensor(nodes - off,
                                                device=self.device)]

    def normalized(self) -> torch.Tensor:
        """Row-normalized owned slice, cached until the next write."""
        if self._Zn is None:
            self._Zn = Q.normalize_rows(self.Z_owned)
        return self._Zn

    def class_stats(self, Y: np.ndarray):
        """Per-class (sums, counts) over owned rows."""
        return Q.class_sums(
            self.Z_owned,
            torch.as_tensor(np.asarray(Y)[self.lo:self.hi],
                            device=self.device),
            K=self.embedder.config.K)

    def topk_candidates(self, q, qnodes, *, k: int,
                        block_rows: int = 1 << 14):
        """This shard's global-id-stamped top-k candidates for unit-norm
        queries `q`, ready for `queries.merge_topk`.  Cuda shards answer
        through the fused kernel: cold, it normalizes in flight and its
        Zn output becomes the cache; warm, it scans the cached Zn."""
        if self._fused:
            if self._Zn is None:
                idx, vals, Zn = Q.topk_cosine_fused_norm(
                    self.Z_owned, q, qnodes, k=k, row_offset=self.lo)
                self._Zn = Zn
                return idx, vals
            return Q.topk_cosine_fused(self._Zn, q, qnodes, k=k,
                                       row_offset=self.lo)
        return Q.topk_cosine_q(self.normalized(), q, qnodes, k=k,
                               block_rows=block_rows, row_offset=self.lo)

    # -- IVF index over the owned slice (repro_torch.index) --------------

    @property
    def index(self):
        """The shard's `IVFIndex`, or None when indexing is off."""
        return self._index

    def build_index(self, centroids) -> None:
        """(Re)quantize the owned slice under the engine's shared
        `centroids`, creating the index on first use."""
        from repro_torch.index import IVFIndex
        if self._index is None:
            self._index = IVFIndex(K=self.embedder.config.K,
                                   row_offset=self.lo)
        self._index.build(self.normalized(), centroids)

    def update_index(self, touched_global: np.ndarray) -> int:
        """Re-assign the owned GLOBAL rows an edge batch rewrote; returns
        the rows that changed cell."""
        if self._index is None:
            return 0
        local = np.asarray(touched_global, np.int64) - self.lo
        return self._index.update_rows(self.normalized(), local)

    def index_topk(self, q, qnodes, probe, *, k: int,
                   block_rows: int = 1 << 14):
        """This shard's candidates in the probed cells, as
        `topk_candidates`, plus the count of rows scanned."""
        return self._index.topk(self.normalized(), q, qnodes, probe, k=k,
                                block_rows=block_rows)

    @property
    def plan_stats(self) -> dict:
        return self.embedder.plan_stats
