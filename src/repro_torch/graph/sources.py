"""GraphSource: one protocol for every way a graph enters the system.

The port's own copy of `repro.graph.sources`: the same registry, names
and fingerprints (a synthetic source's hash covers the same generator
call, `GENERATORS_VERSION` and numpy release).

Graphs reach the encoder through four historically ad-hoc paths —
synthetic generators, `load_graph` npz snapshots, `ShardedEdgeReader`
streams, and the serving `GraphStore`'s live multiset.  A `GraphSource`
unifies them behind two methods:

    graph()        -> Graph   materialized edge list, fingerprint stamped
    fingerprint()  -> str     cheap content identity (NOT array identity)

The fingerprint is what makes the encoder's persistent plan cache work:
`Embedder.plan` keys host preprocessing on *content*, so a fresh process
(restart, CI rerun, new serving replica) embedding the same graph skips
packing entirely.  Each source computes its fingerprint the cheapest
way it can:

  synthetic   hash of (generator, params) — no array hashing at all;
              generators are deterministic per seed.
  snapshot    content hash of the loaded arrays, computed once.
  sharded     content hash folded incrementally while chunks stream.
  store       the GraphStore's incrementally-maintained chain (O(batch)
              per delta — serving never rehashes the full edge list).

Register new ingestion paths with ``@register_source("name")``; callers
construct them via ``get_source("name", **kwargs)`` or directly.
`Embedder.fit`/`plan` accept a GraphSource anywhere a Graph is accepted
(duck-typed on ``.graph()`` — no import cycle with the encoder).
"""
from __future__ import annotations

import hashlib
import json
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.graph import generators as G
from repro_torch.graph.edges import FingerprintAccumulator, Graph
from repro_torch.graph.io import ShardedEdgeReader, load_graph

_SOURCES: Dict[str, type] = {}


def register_source(name: str):
    """Class decorator: make a GraphSource constructible by name."""
    def deco(cls):
        cls.name = name
        _SOURCES[name] = cls
        return cls
    return deco


def get_source(name: str, **kwargs) -> "GraphSource":
    try:
        cls = _SOURCES[name]
    except KeyError:
        raise KeyError(f"unknown graph source {name!r}; registered: "
                       f"{', '.join(sorted(_SOURCES))}") from None
    return cls(**kwargs)


def list_sources() -> list[str]:
    return sorted(_SOURCES)


def as_graph(obj) -> Graph:
    """Materialize a Graph from either a Graph or a GraphSource."""
    if isinstance(obj, Graph):
        return obj
    g = getattr(obj, "graph", None)
    if callable(g):
        return g()
    raise TypeError(f"expected a Graph or GraphSource, got {type(obj)!r}")


class GraphSource:
    """Base class / protocol for graph inputs (see module docstring)."""

    name: str = "?"

    def graph(self) -> Graph:
        """The materialized edge list, fingerprint pre-stamped."""
        raise NotImplementedError

    def fingerprint(self) -> str:
        """Content identity, computed as cheaply as the source allows."""
        return self.graph().fingerprint()


@register_source("synthetic")
class SyntheticSource(GraphSource):
    """A deterministic generator call: fingerprint = hash of the
    (generator, params) tuple, so identity costs nothing — the arrays
    are never hashed.  `kind` names a function in `graph.generators`
    (erdos_renyi, sbm, powerlaw); sbm's true labels are exposed as
    `.labels` after materialization."""

    def __init__(self, kind: str, **params):
        self.kind = kind
        self.params = params
        self.labels: Optional[np.ndarray] = None
        self._graph: Optional[Graph] = None
        fn: Optional[Callable] = getattr(G, kind, None)
        if fn is None or not callable(fn):
            raise KeyError(f"unknown generator {kind!r}")
        self._fn = fn
        # the call is the identity ONLY while its output is: salt with
        # the generator code version and the numpy release (Generator
        # bit streams may change between numpy versions), so drift in
        # either reads as new content, never as a stale plan-cache hit
        token = json.dumps({"kind": kind, "params": params,
                            "generators_version": G.GENERATORS_VERSION,
                            "numpy": np.__version__}, sort_keys=True)
        self._fp = "syn-" + hashlib.blake2b(
            token.encode(), digest_size=16).hexdigest()

    def graph(self) -> Graph:
        if self._graph is None:
            out = self._fn(**self.params)
            if isinstance(out, tuple):           # sbm: (graph, labels)
                self._graph, self.labels = out
            else:
                self._graph = out
            self._graph._fp = self._fp
        return self._graph

    def fingerprint(self) -> str:
        return self._fp


@register_source("snapshot")
class SnapshotSource(GraphSource):
    """An npz snapshot written by `save_graph` (or a GraphStore
    snapshot's `.edges.npz`).  Fingerprint = content hash of the loaded
    arrays — stable across re-saves and across processes, unlike a hash
    of the file bytes (zip metadata varies)."""

    def __init__(self, path: str):
        self.path = path
        self._graph: Optional[Graph] = None

    def graph(self) -> Graph:
        if self._graph is None:
            self._graph = load_graph(self.path)
        return self._graph


@register_source("sharded")
class ShardedSource(GraphSource):
    """This host's contiguous slice of an npz snapshot, materialized
    from `ShardedEdgeReader` chunks with the fingerprint folded
    incrementally while streaming — one pass over the bytes, O(chunk)
    extra memory beyond the assembled slice.  The fingerprint depends
    only on the slice's CONTENT (chunk_size is a tuning knob, not
    identity), so the full slice of a snapshot agrees with
    `SnapshotSource` of the same file."""

    def __init__(self, path: str, host_id: int = 0, num_hosts: int = 1,
                 chunk_size: int = 1 << 22, mmap: Optional[bool] = None):
        self.reader = ShardedEdgeReader(path, host_id, num_hosts,
                                        chunk_size=chunk_size, mmap=mmap)
        self._graph: Optional[Graph] = None

    def chunks(self) -> Iterator[Graph]:
        """The raw chunk stream (for out-of-core consumers that never
        want the whole slice resident)."""
        return iter(self.reader)

    def graph(self) -> Graph:
        if self._graph is None:
            n = self.reader.n
            acc = FingerprintAccumulator(n)
            us, vs, ws = [], [], []
            for c in self.reader:
                acc.update(c.u, c.v, c.w)
                us.append(np.asarray(c.u, np.int32))
                vs.append(np.asarray(c.v, np.int32))
                ws.append(np.asarray(c.w, np.float32))
            cat = (np.concatenate(a) if a else z
                   for a, z in ((us, np.zeros(0, np.int32)),
                                (vs, np.zeros(0, np.int32)),
                                (ws, np.zeros(0, np.float32))))
            self._graph = Graph(*cat, n)
            self._graph._fp = acc.digest()
        return self._graph


@register_source("store")
class StoreSource(GraphSource):
    """A live `serving.GraphStore` version.  The store maintains its
    fingerprint incrementally (chained per delta batch), so serving
    cold-starts and rebuilds get content identity for free — no rehash
    of the base multiset, ever.  Duck-typed: anything with `.edges()`
    and `.fingerprint()` works (avoids a graph -> serving import
    cycle)."""

    def __init__(self, store):
        self.store = store

    def graph(self) -> Graph:
        return self.store.edges()

    def fingerprint(self) -> str:
        return self.store.fingerprint()
