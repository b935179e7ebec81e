"""EmbeddingShard: one worker owning a contiguous slice of Z rows.

The port of `repro.serving.shard.EmbeddingShard` (the IVF index over a
shard waits for its own slice, and the persistent plan cache for the
encoder's: `plan_cache` takes None only).  Shard i is the single writer and
reader of rows [lo, hi).  Every edge incident to an owned row is in the
shard's routed sub-multiset, so its slice is exact in isolation, and an
edge delta touches only the shards owning its endpoints.

A proper sub-range shard gives its Embedder
``EncoderConfig.row_partition=(lo, hi)``, so only the (hi - lo, K) rows
are held on the device; the full-range shard keeps an unpartitioned
Embedder.  With ``backend="cuda"`` the shard folds deltas through the
`gee_delta_renorm` kernel and answers top-k through `topk_fused`; the
other backends use `partial_fit` and the blocked scan.  On the same Z
the answers are bit-identical either way.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.encoder import Embedder, EncoderConfig
from repro_torch.graph.edges import Graph
from repro_torch.serving import queries as Q


class EmbeddingShard:
    """Owns Z rows [lo, hi); embeds and serves only its slice."""

    def __init__(self, shard_id: int, lo: int, hi: int, *, K: int,
                 n: Optional[int] = None, chunk_size: int = 1 << 20,
                 backend: str = "streaming", plan_cache: None = None,
                 device: Union[str, torch.device] = "cuda"):
        if plan_cache is not None:
            raise NotImplementedError(
                "the persistent plan cache (encoder/plan_cache.py) is not "
                "ported yet (ROADMAP queue A.4): pass plan_cache=None")
        self.shard_id = int(shard_id)
        self.lo, self.hi = int(lo), int(hi)
        #: owned-rows mode: the Embedder accumulates ONLY [lo, hi)
        self.owned_only = (n is not None
                           and (self.lo, self.hi) != (0, int(n)))
        self.embedder = Embedder(
            EncoderConfig(K=int(K), chunk_size=int(chunk_size),
                          row_partition=((self.lo, self.hi)
                                         if self.owned_only else None)),
            backend=backend, device=device)
        #: cuda shards use the fused kernels for writes and reads
        self._fused = (backend == "cuda")
        self._Zn: Optional[torch.Tensor] = None

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

    @property
    def plan_stats(self) -> dict:
        """Plan builds and hits; the disk tier's keys stay 0 until the
        persistent plan cache is ported."""
        return {"built": self.embedder.plan_stats["built"],
                "hits": self.embedder.plan_stats["hits"],
                "disk_hits": 0, "disk_stores": 0}
