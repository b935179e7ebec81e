"""Partitioning policies for distributed and sharded GEE (own copy of
`repro.graph.partition`).

* Edge partitioning (distributed fits, `core.distributed`): a shuffled
  edge list makes every rank's per-owner bucket sizes concentrate
  around the mean, which the capacity-padded a2a and ring modes rely
  on; `plan_capacity` bounds the tail, `owner_histogram` measures it.
* Row partitioning (serving): an edge (u, v, w) contributes only to
  rows u and v, so a delta batch fans out only to the shards owning its
  endpoints, and each shard's routed sub-multiset holds every edge
  incident to its rows: its owned slice of Z is exact in isolation.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.edges import Graph


def shuffle_edges(g: Graph, seed: int = 0) -> Graph:
    return g.permuted(np.random.default_rng(seed))


def owner_histogram(g: Graph, p: int) -> np.ndarray:
    """(p, p) int64 matrix: [shard, owner] contribution counts, with the
    edges padded to a multiple of p and split into p contiguous shards
    (`np.bincount`: the reference's `np.add.at` counts, in a fraction of
    its time at LiveJournal scale)."""
    s_pad = ((g.s + p - 1) // p) * p
    gp = g.pad_to(s_pad)
    rows = (g.n + p - 1) // p
    per = s_pad // p
    hist = np.zeros((p, p), np.int64)
    for shard in range(p):
        sl = slice(shard * per, (shard + 1) * per)
        for ends in (gp.u[sl], gp.v[sl]):
            hist[shard] += np.bincount(np.minimum(ends // rows, p - 1),
                                       minlength=p)
    return hist


def plan_capacity(s: int, n: int, p: int, overflow_target: float = 1e-6
                  ) -> float:
    """Capacity factor such that P(bucket > cap) < target under a
    balanced multinomial (Chernoff bound: cap = mu + 3*sigma-ish)."""
    mu = 2 * (s / p) / p
    sigma = np.sqrt(max(mu, 1.0))
    z = np.sqrt(2 * np.log(p * p / max(overflow_target, 1e-12)))
    return float((mu + z * sigma) / max(mu, 1.0))


class RowPartition:
    """Contiguous row partition of n nodes across p shards.

    Shard i owns rows [bounds[i], bounds[i+1]) with a fixed stride of
    ceil(n/p) rows, so `shard_of` is one division; the last shard holds
    the remainder.  Layouts that would leave a shard empty are
    rejected."""

    def __init__(self, n: int, p: int):
        if p < 1:
            raise ValueError(f"need p >= 1 shards, got {p}")
        if n < p:
            raise ValueError(f"cannot split {n} rows across {p} shards")
        self.n = int(n)
        self.p = int(p)
        per = (self.n + p - 1) // p
        self.bounds = np.minimum(np.arange(p + 1, dtype=np.int64) * per,
                                 self.n)
        self._per = per
        if self.bounds[-2] >= self.n:
            raise ValueError(
                f"splitting {n} rows across {p} shards (stride {per}) "
                "leaves the last shard empty; use fewer shards")

    def slice(self, shard: int) -> tuple[int, int]:
        """(lo, hi) row range owned by `shard`."""
        return int(self.bounds[shard]), int(self.bounds[shard + 1])

    def slices(self):
        """All (lo, hi) ranges in shard order."""
        return [self.slice(i) for i in range(self.p)]

    def shard_of(self, nodes) -> np.ndarray:
        """Owning shard id per node (vectorized)."""
        return np.minimum(np.asarray(nodes, np.int64) // self._per,
                          self.p - 1).astype(np.int32)

    def route_nodes(self, nodes: np.ndarray):
        """Yield (shard, index_into_batch) for shards with work; order
        within a shard's sub-batch follows batch order."""
        owner = self.shard_of(nodes)
        for shard in range(self.p):
            idx = np.nonzero(owner == shard)[0]
            if idx.size:
                yield shard, idx

    def route_edges(self, u: np.ndarray, v: np.ndarray, w: np.ndarray):
        """Yield (shard, (u, v, w)) sub-batches: shard i receives every
        edge with an endpoint in its rows, once, in batch order."""
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        w = np.asarray(w, np.float32)
        if self.p == 1:
            yield 0, (u, v, w)
            return
        su, sv = self.shard_of(u), self.shard_of(v)
        for shard in range(self.p):
            mask = (su == shard) | (sv == shard)
            if mask.any():
                yield shard, (u[mask], v[mask], w[mask])

    def route_graph(self, g: Graph):
        """`route_edges` over a Graph; yields (shard, sub_graph) with
        `n` preserved (shards embed in global coordinates)."""
        for shard, (u, v, w) in self.route_edges(g.u, g.v, g.w):
            yield shard, Graph(u, v, w, g.n)
