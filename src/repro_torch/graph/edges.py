"""Graph data structures: weighted directed edge lists.

The paper's convention: a graph G(n, s) is an edge list (source,
destination, weight); undirected graphs are two symmetric directed
edges; unweighted graphs have unit weights.  Labels use
{-1 = unknown, 0..K-1}.

The port's own copy of `repro.graph.edges`.  Host numpy on purpose:
the same seed gives the same arrays in both packages, and the content
fingerprints below are the reference's hex digests.  The hash is
xxh3-128 where `xxhash` imports and blake2b (16 bytes) otherwise, so a
digest is comparable only between processes of one installation.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

try:                                   # fast path where available
    import xxhash

    def _new_hash():
        return xxhash.xxh3_128()
except ImportError:                    # stdlib fallback, same interface
    def _new_hash():
        return hashlib.blake2b(digest_size=16)

_COLUMN_DTYPES = (np.int32, np.int32, np.float32)


def _hash_edges(h, u, v, w) -> None:
    """Feed (u, v, w) into hasher `h` in canonical dtypes, so two graphs
    with equal content but different array dtypes or layout agree."""
    for arr, dt in zip((u, v, w), _COLUMN_DTYPES):
        h.update(np.ascontiguousarray(arr, dt).data)


class FingerprintAccumulator:
    """Streaming edge fingerprint: feed (u, v, w) batches in
    order, read `digest()` at the end.  One hasher per column, combined
    at digest time, so the value depends only on the content streamed,
    never on how it was chunked."""

    def __init__(self, n: int):
        self._n = int(n)
        self._cols = (_new_hash(), _new_hash(), _new_hash())

    def update(self, u, v, w) -> "FingerprintAccumulator":
        for h, arr, dt in zip(self._cols, (u, v, w), _COLUMN_DTYPES):
            h.update(np.ascontiguousarray(arr, dt).data)
        return self

    def digest(self) -> str:
        h = _new_hash()
        h.update(np.int64(self._n).tobytes())
        for col in self._cols:
            h.update(col.digest())
        return h.hexdigest()


def edge_fingerprint(n: int, u, v, w) -> str:
    """Content fingerprint of an edge list: a hash over (n, u, v, w),
    O(s) over the raw bytes.  Order-sensitive by design (plan layouts
    depend on edge order)."""
    return FingerprintAccumulator(n).update(u, v, w).digest()


def extend_fingerprint(fp: str, u, v, w) -> str:
    """Chain an appended edge batch onto a fingerprint:
    fp' = H(fp || u || v || w), O(batch).  Differs from
    `edge_fingerprint` of the concatenated arrays; every process that
    replays the same base and deltas reaches the same value."""
    h = _new_hash()
    h.update(bytes.fromhex(fp))
    _hash_edges(h, u, v, w)
    return h.hexdigest()


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

    def fingerprint(self) -> str:
        """Content fingerprint (`edge_fingerprint`), computed once and
        cached on the instance.  Sources that already know it (the
        serving store's chained one, a generator call's hash) stamp
        `_fp` beforehand so that no rehash is forced.  Assumes the
        arrays are not changed in place afterwards."""
        fp = getattr(self, "_fp", None)
        if fp is None:
            fp = edge_fingerprint(self.n, self.u, self.v, self.w)
            self._fp = fp
        return fp

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
