"""Graph data structures: weighted directed edge lists.

The paper's convention: a graph G(n, s) is an edge list (source,
destination, weight); undirected graphs are two symmetric directed
edges; unweighted graphs have unit weights.  Labels use
{-1 = unknown, 0..K-1}.

The port's own copy of `repro.graph.edges` (the content-fingerprint
helpers wait for the plan cache).  Host numpy on purpose: the same seed
gives the same arrays in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Graph:
    """Edge-list graph. u, v: int32 (s,); w: float32 (s,); n nodes."""
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray
    n: int

    @property
    def s(self) -> int:
        return int(self.u.shape[0])

    def validate(self) -> None:
        if not self.u.shape == self.v.shape == self.w.shape:
            raise ValueError("u, v, w must have the same shape")
        if self.s == 0:        # empty edge list (e.g. an empty delta batch)
            return
        for name, a in (("u", self.u), ("v", self.v)):
            if a.min() < 0 or a.max() >= self.n:
                raise ValueError(f"{name} holds node ids outside "
                                 f"[0, {self.n})")

    def degrees(self) -> np.ndarray:
        """Weighted out+in degree (the Laplacian normalizer)."""
        d = np.zeros(self.n, np.float64)
        np.add.at(d, self.u, self.w)
        np.add.at(d, self.v, self.w)
        return d.astype(np.float32)


def bucket_size(size: int, floor: int = 256) -> int:
    """Next power-of-two >= size (>= floor): the batch-padding policy."""
    b = floor
    while b < size:
        b <<= 1
    return b


def chunk_edges(u: np.ndarray, v: np.ndarray, w: np.ndarray,
                chunk_size: int, floor: int = 256):
    """Yield (u, v, w) host chunks of at most `chunk_size` edges; the
    tail chunk is padded to a power-of-two bucket with zero-weight
    node-0 self-loops (no-op edges).  Non-tail chunks are views."""
    s = int(u.shape[0])
    for off in range(0, s, chunk_size):
        end = min(off + chunk_size, s)
        m = end - off
        if m < chunk_size:
            pad = bucket_size(m, floor) - m
            yield (np.concatenate([u[off:end], np.zeros(pad, np.int32)]),
                   np.concatenate([v[off:end], np.zeros(pad, np.int32)]),
                   np.concatenate([w[off:end], np.zeros(pad, np.float32)]))
        else:
            yield u[off:end], v[off:end], w[off:end]


def make_labels(n: int, K: int, labeled_frac: float,
                rng: np.random.Generator,
                true_labels: Optional[np.ndarray] = None) -> np.ndarray:
    """Labels uniform over [0, K) for `labeled_frac` of nodes chosen
    uniformly at random; -1 elsewhere.  If true_labels given, reveal
    those instead of random ones."""
    Y = np.full(n, -1, np.int32)
    m = max(1, int(n * labeled_frac))
    idx = rng.choice(n, size=m, replace=False)
    if true_labels is not None:
        Y[idx] = true_labels[idx]
    else:
        Y[idx] = rng.integers(0, K, size=m)
    return Y
