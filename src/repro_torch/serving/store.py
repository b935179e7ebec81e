"""Versioned in-memory graph store with an append-only delta log.

The port's own copy of `repro.serving.store` (numpy only): the same
snapshot files (`<prefix>.edges.npz` through `graph/io`, and
`<prefix>.meta.npz`), so a snapshot written by either package loads in
the other, and the same chained fingerprint.

The store separates a compacted **base** edge multiset from a log of
deltas applied since the last compaction.  Because GEE is linear in
the edge multiset, a deletion is represented exactly as the same edge
with negated weight — the materialized multiset `base ++ log` always
reproduces the live graph, and `compact()` folds the log into the base
by coalescing duplicate (u, v) keys and dropping ~zero weights.

Every applied delta (edge batch or label update) bumps `version`, the
store's logical clock; readers use it to tell which graph state a
result was computed against (see the version/epoch model in
`repro.serving.__init__`).  Label updates materialize straight into Y
rather than the log — they are not replayable against Z and only feed
the service's next rebuild.  Snapshots go through `graph/io.py`
(`save_graph`/`load_graph`) plus a sibling `.meta.npz` for labels and
counters, so a snapshot can be re-served or streamed back through
`ShardedEdgeReader`.

The store also maintains the multiset's **content fingerprint** — the
key of the encoder's persistent plan cache — incrementally: the base's
fingerprint is hashed once, then each logged edge batch is CHAINED on
in O(batch) (`extend_fingerprint`), so a store serving billions of
edges never rehashes its edge list.  `edges()` stamps the fingerprint
onto the materialized graph; two replicas replaying the same snapshot
+ delta sequence therefore agree on it and share plan-cache entries.
Label updates leave it untouched (labels are not part of the edge
multiset); compaction rewrites the base arrays and rehashes them once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.edges import (  # noqa: F401 (re-export)
    Graph, bucket_size, extend_fingerprint)
from repro_torch.graph.io import load_graph, save_graph

_ZERO_W = 1e-12       # coalesced weights below this are dropped


def check_labels(nodes: np.ndarray, labels: np.ndarray, n: int,
                 K: int) -> None:
    """Raise unless (nodes, labels) is a valid label update: equal
    shapes, nodes in [0, n), labels in [-1, K)."""
    if nodes.shape != labels.shape:
        raise ValueError(f"nodes {nodes.shape} and labels {labels.shape} "
                         "differ in shape")
    if nodes.size:
        if nodes.min() < 0 or nodes.max() >= n:
            raise ValueError(f"label update nodes outside [0, {n})")
        if labels.min() < -1 or labels.max() >= K:
            raise ValueError(f"labels outside [-1, {K})")


@dataclass(frozen=True)
class EdgeDelta:
    """One logged edge batch.  `w` is already sign-folded: deletions are
    stored with negative weights (exact under GEE's linearity)."""
    version: int
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray


class GraphStore:
    """Append-only delta log over a compacted base edge multiset."""

    def __init__(self, g: Graph, Y: np.ndarray, K: int):
        g.validate()
        self.base = Graph(np.asarray(g.u, np.int32),
                          np.asarray(g.v, np.int32),
                          np.asarray(g.w, np.float32), g.n)
        self.Y = np.asarray(Y, np.int32).copy()
        if self.Y.shape != (g.n,):
            raise ValueError(f"Y shape {self.Y.shape} != ({g.n},)")
        self.K = int(K)
        self.version = 0
        self.compactions = 0
        self.edge_log: list[EdgeDelta] = []
        self._fp = self.base.fingerprint()     # hashed once, then chained
        self._coalesced = False    # base known duplicate-free? (compact)

    # -- delta application ------------------------------------------------

    def apply_edges(self, u, v, w, *, delete: bool = False) -> int:
        """Log an edge insert (or delete) batch; returns the new version.

        Empty batches are legal (a no-op that still bumps the clock)."""
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        w = np.asarray(w, np.float32)
        Graph(u, v, w, self.base.n).validate()
        self.version += 1
        w = -w if delete else w
        self.edge_log.append(EdgeDelta(self.version, u, v, w))
        self._fp = extend_fingerprint(self._fp, u, v, w)   # O(batch)
        return self.version

    def apply_labels(self, nodes, labels) -> int:
        """Point-update labels; returns the new version.

        Labels are materialized straight into Y (not logged): a label
        change is not replayable against Z — the service re-derives the
        projection weights from Y on its next rebuild."""
        nodes = np.asarray(nodes, np.int64)
        labels = np.asarray(labels, np.int32)
        check_labels(nodes, labels, self.base.n, self.K)
        self.version += 1
        self.Y[nodes] = labels
        return self.version

    # -- materialization --------------------------------------------------

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def log_edges(self) -> int:
        return sum(d.u.shape[0] for d in self.edge_log)

    def fingerprint(self) -> str:
        """Content fingerprint of the live multiset (chained, O(batch)
        per delta — never a full rehash while the log grows)."""
        return self._fp

    def edges(self) -> Graph:
        """Current edge multiset = base ++ log (deletes as negative w),
        fingerprint pre-stamped so downstream plan caching never
        rehashes the materialized arrays."""
        if not self.edge_log:
            return self.base
        g = Graph(
            np.concatenate([self.base.u] + [d.u for d in self.edge_log]),
            np.concatenate([self.base.v] + [d.v for d in self.edge_log]),
            np.concatenate([self.base.w] + [d.w for d in self.edge_log]),
            self.base.n)
        g._fp = self._fp
        return g

    def churn_fraction(self, Y_epoch: np.ndarray) -> float:
        """Fraction of nodes whose label differs from an epoch snapshot."""
        return float((self.Y != Y_epoch).mean()) if self.n else 0.0

    # -- compaction & snapshots -------------------------------------------

    def compact(self) -> dict:
        """Fold the log into the base: coalesce duplicate (u, v) keys,
        sum weights, drop ~zero entries.  Logical content is unchanged
        (GEE is linear, so coalescing parallel edges is exact); the
        version counter is NOT bumped.

        A no-op compaction (empty log over an already-coalesced base —
        e.g. a snapshot right after a compact, the engine's checkpoint
        path) returns early: no O(s log s) re-sort, no fp rehash, no
        base rewrite."""
        if not self.edge_log and self._coalesced:
            return {"edges_before": self.base.s,
                    "edges_after": self.base.s,
                    "compactions": self.compactions}
        g = self.edges()
        before = g.s
        key = g.u.astype(np.int64) * g.n + g.v
        uniq, inv = np.unique(key, return_inverse=True)
        w = np.zeros(uniq.shape[0], np.float64)
        np.add.at(w, inv, g.w.astype(np.float64))
        keep = np.abs(w) > _ZERO_W
        uniq, w = uniq[keep], w[keep]
        self.base = Graph((uniq // g.n).astype(np.int32),
                          (uniq % g.n).astype(np.int32),
                          w.astype(np.float32), g.n)
        self.edge_log.clear()
        # coalescing rewrote the arrays: rehash once (plan artifacts
        # depend on the physical edge list, so the identity SHOULD move)
        self._fp = self.base.fingerprint()
        self.compactions += 1
        self._coalesced = True
        return {"edges_before": before, "edges_after": self.base.s,
                "compactions": self.compactions}

    def snapshot(self, prefix: str) -> None:
        """Write `<prefix>.edges.npz` (via graph/io) + `<prefix>.meta.npz`.

        Compacts first so the snapshot is the minimal coalesced multiset
        and the delta log is empty on reload."""
        self.compact()
        save_graph(prefix + ".edges.npz", self.base)
        np.savez_compressed(prefix + ".meta.npz", Y=self.Y,
                            K=np.int64(self.K),
                            version=np.int64(self.version),
                            compactions=np.int64(self.compactions))

    @classmethod
    def load(cls, prefix: str) -> "GraphStore":
        g = load_graph(prefix + ".edges.npz")
        with np.load(prefix + ".meta.npz") as meta:
            store = cls(g, meta["Y"], int(meta["K"]))
            store.version = int(meta["version"])
            store.compactions = int(meta["compactions"])
        store._coalesced = True        # snapshots are written compacted
        return store
