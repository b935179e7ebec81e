"""GEE <-> LM bridge: embedding-table initialization from a token
co-occurrence graph (the port of `repro.encoder.bridge`).

Build a co-occurrence graph over token ids (edge (a, b, count) when b
follows a within a window), cluster it with unsupervised GEE refinement
through the `Embedder` front door (the cuda backend: the scatter kernel
on a card, its plain version on the CPU), then project K -> d_model with
`Embedder.to_features`.  Random draws come from a `torch.Generator`, so
the bits differ from the reference's `jax.random`; shapes, scale and
structure do not.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.encoder.config import EncoderConfig
from repro_torch.encoder.embedder import Embedder
from repro_torch.graph.edges import Graph


def token_cooccurrence(tokens: np.ndarray, vocab: int, window: int = 2,
                       max_edges: int = 2_000_000) -> Graph:
    """tokens: (N,) int stream -> co-occurrence edge list (deduplicated,
    counts as weights)."""
    pairs = []
    for d in range(1, window + 1):
        a, b = tokens[:-d], tokens[d:]
        pairs.append(np.stack([a, b], 1))
    e = np.concatenate(pairs, 0)
    key = e[:, 0].astype(np.int64) * vocab + e[:, 1]
    uniq, counts = np.unique(key, return_counts=True)
    if uniq.shape[0] > max_edges:
        top = np.argsort(-counts)[:max_edges]
        uniq, counts = uniq[top], counts[top]
    u = (uniq // vocab).astype(np.int32)
    v = (uniq % vocab).astype(np.int32)
    return Graph(u, v, counts.astype(np.float32), vocab)


def gee_embedding_init(tokens: np.ndarray, vocab: int, d_model: int,
                       K: int = 64,
                       generator: Optional[torch.Generator] = None,
                       window: int = 2, refine_iters: int = 6,
                       blend: float = 0.5,
                       device: Union[str, torch.device] = "cuda"
                       ) -> np.ndarray:
    """(vocab, d_model) initializer from GEE over co-occurrences:
    unsupervised `Embedder.refine`, then `Embedder.to_features`.  Two
    seeds drawn from `generator` (default: seeded with 0) drive the
    refinement and the projection."""
    gen = (generator if generator is not None
           else torch.Generator().manual_seed(0))
    seeds = torch.randint(0, 2**31 - 1, (2,), generator=gen,
                          device=gen.device).tolist()
    g = token_cooccurrence(tokens, vocab, window)
    K = min(K, max(2, vocab // 4))
    emb = Embedder(EncoderConfig(K=K, refine_iters=refine_iters),
                   backend="cuda", device=device)
    emb.fit(g, np.full(vocab, -1, np.int32))
    emb.refine(seeds[0])
    return emb.to_features(
        d_model, generator=torch.Generator().manual_seed(seeds[1]),
        blend=blend)
