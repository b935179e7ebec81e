"""Synthetic graph generators: Erdős–Rényi, SBM and power-law.

Own copy of `repro.graph.generators`: the same numpy draws in the same
order, so the same seed gives the same arrays in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.edges import Graph


def erdos_renyi(n: int, s: int, seed: int = 0, weighted: bool = False
                ) -> Graph:
    """G(n, s): s directed edges with uniform random endpoints."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=s, dtype=np.int32)
    v = rng.integers(0, n, size=s, dtype=np.int32)
    w = (rng.random(s, dtype=np.float32) + 0.5 if weighted
         else np.ones(s, np.float32))
    return Graph(u, v, w, n)


def sbm(n: int, K: int, s: int, p_in: float = 0.9, seed: int = 0
        ) -> tuple[Graph, np.ndarray]:
    """Stochastic block model with s edges; returns (graph,
    true_labels).  p_in = probability an edge is intra-community."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, K, size=n, dtype=np.int32)
    intra = rng.random(s) < p_in
    u = rng.integers(0, n, size=s, dtype=np.int32)
    v = rng.integers(0, n, size=s, dtype=np.int32)
    # intra edges: v is a random member of u's block, picked through
    # the sorted-by-label index
    order = np.argsort(labels, kind="stable")
    block_start = np.searchsorted(labels[order], np.arange(K))
    block_count = np.bincount(labels, minlength=K)
    lab_u = labels[u]
    offs = (rng.random(s) * block_count[lab_u]).astype(np.int64)
    v_intra = order[block_start[lab_u] + offs]
    v = np.where(intra, v_intra, v).astype(np.int32)
    return Graph(u, v, np.ones(s, np.float32), n), labels


def powerlaw(n: int, s: int, alpha: float = 1.5, seed: int = 0) -> Graph:
    """Skewed degree graph (Zipf sources, uniform destinations)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    p = ranks / ranks.sum()
    u = rng.choice(n, size=s, p=p).astype(np.int32)
    v = rng.integers(0, n, size=s, dtype=np.int32)
    return Graph(u, v, np.ones(s, np.float32), n)
