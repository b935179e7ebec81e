"""Plan: the label-independent half of an embedding.

The port of `repro.encoder.plan`.  A backend splits into **plan**
(host or device preprocessing that depends only on the edge multiset
and the config: Laplacian scaling, owned-row bucketing, destination
packing, chunking, placement) and **embed** (resolve classes and values
from the current labels and scatter).  Labels change every refinement
round and serving epoch, the edges do not, so a plan is reused across
`fit`/`refit` on the same arrays (matched by identity).

The plan splits once more (`Backend.plan_host` / `plan_finalize`): the
host half is the expensive label-free preprocessing, which the
persistent plan cache (`encoder.plan_cache`) stores keyed on the graph's
content fingerprint; the finalize half (uploads, chunk views) runs in
every process.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.encoder.config import EncoderConfig
from repro_torch.graph.edges import Graph


def owned_contributions(graph: Graph, w_eff: np.ndarray, lo: int,
                        hi: int) -> tuple:
    """Bucket the edge multiset by OWNED destination row.

    Each edge (u, v, w) contributes to rows u (from source v) and v
    (from source u); a partition owning [lo, hi) keeps the
    contributions landing there.  Returns (rows, src, w): LOCAL rows in
    [0, hi - lo), GLOBAL label donors, effective weights."""
    u = np.asarray(graph.u)
    v = np.asarray(graph.v)
    w = np.asarray(w_eff, np.float32)
    dst = np.concatenate([u, v])
    src = np.concatenate([v, u])          # label donor
    wc = np.concatenate([w, w])
    m = (dst >= lo) & (dst < hi)
    return ((dst[m] - lo).astype(np.int32),
            src[m].astype(np.int32),
            wc[m].astype(np.float32))


def effective_weights(graph: Graph, config: EncoderConfig) -> np.ndarray:
    """Laplacian-scaled weights, computed once per plan from the
    unpadded graph's float64 degrees (as the reference does)."""
    w = np.asarray(graph.w, np.float32)
    if not config.laplacian:
        return w
    deg = graph.degrees()
    scale = 1.0 / np.sqrt(np.maximum(deg, 1.0), dtype=np.float64)
    w_eff = (w.astype(np.float64) * scale[graph.u] * scale[graph.v])
    return w_eff.astype(np.float32)


@dataclass
class Plan:
    """Per-backend preprocessing for one (graph, config) pair."""

    backend: str
    config: EncoderConfig
    n: int
    s: int
    w_eff: np.ndarray                   # laplacian-scaled edge weights
    data: Dict[str, Any] = field(default_factory=dict)
    #: the persistable host half (`Backend.plan_host`); carries "w_eff"
    #: only where Laplacian scaling makes it an artifact of its own
    host: Dict[str, Any] = field(default_factory=dict)
    # identity anchors for O(1) matching
    _u: Optional[np.ndarray] = None
    _v: Optional[np.ndarray] = None
    _w: Optional[np.ndarray] = None

    @property
    def n_local(self) -> int:
        """Accumulator height: hi - lo under a row partition, else n."""
        rp = self.config.row_partition
        return self.n if rp is None else rp[1] - rp[0]

    @classmethod
    def anchors(cls, graph: Graph) -> dict:
        return {"_u": graph.u, "_v": graph.v, "_w": graph.w}

    def matches(self, graph: Graph, backend: str,
                config: EncoderConfig) -> bool:
        """True iff this plan was built for exactly these arrays."""
        return (self.backend == backend and self.config == config
                and self.n == graph.n
                and self._u is graph.u and self._v is graph.v
                and self._w is graph.w)
