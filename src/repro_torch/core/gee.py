"""One-Hot Graph Encoder Embedding (GEE) in PyTorch.

The port of `repro.core.gee`.  Label convention: Y in {-1 = unknown,
0..K-1}.  The paper's serial edge loop with atomic ``writeAdd`` is a
vectorized scatter-add: jnp's ``.at[].add`` becomes
``index_put_(accumulate=True)``.  Every function works on tensors of
any one device; the caller places them.

Variants:
  * ``gee``            — one-pass embedding (weighted, directed;
                          symmetric contribution per the paper)
  * ``laplacian=True`` — w' = w / sqrt(deg_u * deg_v)
  * ``gee_apply_delta`` / ``gee_streaming`` — exact incremental and
                          chunked accumulate (Z is linear in the edges)
  * ``*_owned``        — the same over pre-bucketed owned-destination
                          contributions (a row partition's slice)
  * ``kmeans_refine_round`` — one round of unsupervised refinement
"""
from __future__ import annotations

from typing import Optional

import torch


def make_w(Y: torch.Tensor, K: int) -> torch.Tensor:
    """Per-node projection weight: 1/|class(Y_i)| (0 for unlabeled).

    float32 math as in `repro.core.gee.make_w` (counts summed in
    float32, one IEEE division), so Wv is bit-equal to the reference."""
    labeled = Y >= 0
    counts = torch.zeros(K, dtype=torch.float32, device=Y.device)
    counts.index_put_((torch.where(labeled, Y, 0).long(),),
                      labeled.to(torch.float32), accumulate=True)
    inv = torch.where(counts > 0, 1.0 / torch.clamp_min(counts, 1.0),
                      torch.zeros_like(counts))
    return torch.where(labeled, inv[torch.clamp_min(Y, 0).long()],
                       torch.zeros((), dtype=torch.float32,
                                   device=Y.device))


def edge_contributions(u, v, w, Y, Wv):
    """Per-directed-edge (dst, class, value), both directions.

    Returns (dst (2s,), cls (2s,), val (2s,)).  Edges whose source label
    is unknown contribute value 0 (class clamped to 0)."""
    u, v = u.long(), v.long()
    yv, yu = Y[v], Y[u]
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    dst = torch.cat([u, v])
    cls = torch.cat([torch.clamp_min(yv, 0), torch.clamp_min(yu, 0)])
    val = torch.cat([torch.where(yv >= 0, Wv[v] * w, zero),
                     torch.where(yu >= 0, Wv[u] * w, zero)])
    return dst, cls.long(), val


def _scatter(Z: torch.Tensor, rows, cls, val) -> torch.Tensor:
    """Z[rows, cls] += val, in place (duplicates accumulate)."""
    return Z.index_put_((rows.long(), cls.long()), val, accumulate=True)


def gee(u, v, w, Y, *, K: int, n: int, laplacian: bool = False,
        deg: Optional[torch.Tensor] = None,
        Wv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-pass GEE embedding. Returns Z (n, K) float32.

    Wv: optional precomputed projection weights (the Embedder passes
    the ones it owns); by default they are derived from Y."""
    w = w.to(torch.float32)
    if laplacian:
        if deg is None:
            deg = torch.zeros(n, dtype=torch.float32, device=w.device)
            deg.index_put_((u.long(),), w, accumulate=True)
            deg.index_put_((v.long(),), w, accumulate=True)
        scale = torch.rsqrt(torch.clamp_min(deg, 1.0))
        w = w * scale[u.long()] * scale[v.long()]
    if Wv is None:
        Wv = make_w(Y, K)
    dst, cls, val = edge_contributions(u, v, w, Y, Wv)
    Z = torch.zeros((n, K), dtype=torch.float32, device=w.device)
    return _scatter(Z, dst, cls, val)


def gee_apply_delta(Z, u, v, w, Y, Wv, *, K: int, sign: float = 1.0):
    """Fold an edge batch into Z: insertions (sign=+1) and deletions
    (sign=-1) in O(batch), exact by linearity.  Wv must be the weights
    Z was built with.  Returns a new tensor; Z is left as it was."""
    dst, cls, val = edge_contributions(u, v, w.to(torch.float32), Y, Wv)
    return _scatter(Z.clone(), dst, cls, sign * val)


def gee_streaming(chunks, Y, *, K: int, n: int,
                  Wv: Optional[torch.Tensor] = None):
    """Single-pass accumulate over an iterator of (u, v, w) chunks."""
    if Wv is None:
        Wv = make_w(Y, K)
    Z = torch.zeros((n, K), dtype=torch.float32, device=Y.device)
    for (u, v, w) in chunks:
        dst, cls, val = edge_contributions(u, v, w.to(torch.float32), Y,
                                           Wv)
        _scatter(Z, dst, cls, val)       # Z is ours: update in place
    return Z


# ---------------------------------------------------------------------------
# Owned-rows (partitioned) accumulate: O(n/p) accumulators per shard
# ---------------------------------------------------------------------------
#
# A row partition owns the contiguous Z rows [lo, hi).  The contributions
# landing there are a filterable subset of the edge multiset: (dst, src,
# w) triples with dst in [lo, hi), remapped to local row dst - lo.  Labels
# Y and weights Wv stay GLOBAL; only the accumulator shrinks.


def owned_edge_contributions(src, w, Y, Wv):
    """Per-contribution (class, value) for owned-destination triples;
    unknown source labels give value 0 (class clamped to 0)."""
    src = src.long()
    ys = Y[src]
    cls = torch.clamp_min(ys, 0)
    val = torch.where(ys >= 0, Wv[src] * w,
                      torch.zeros((), dtype=torch.float32,
                                  device=w.device))
    return cls.long(), val


def gee_owned(rows, src, w, Y, Wv, *, K: int, n_local: int):
    """One-pass GEE over owned-destination contributions.  Returns the
    (n_local, K) owned slice of Z."""
    cls, val = owned_edge_contributions(src, w.to(torch.float32), Y, Wv)
    Z = torch.zeros((n_local, K), dtype=torch.float32, device=w.device)
    return _scatter(Z, rows, cls, val)


def gee_apply_delta_owned(Z, rows, src, w, Y, Wv, *, K: int,
                          sign: float = 1.0):
    """Fold owned-destination contributions into an (n_local, K) slice.
    Padded slots carry w = 0 and are no-ops.  Returns a new tensor."""
    cls, val = owned_edge_contributions(src, w.to(torch.float32), Y, Wv)
    return _scatter(Z.clone(), rows, cls, sign * val)


def gee_streaming_owned(chunks, Y, *, K: int, n_local: int,
                        Wv: Optional[torch.Tensor] = None):
    """Chunked owned-rows accumulate; `chunks` yields (rows, src, w)."""
    if Wv is None:
        Wv = make_w(Y, K)
    Z = torch.zeros((n_local, K), dtype=torch.float32, device=Y.device)
    for (rows, src, w) in chunks:
        cls, val = owned_edge_contributions(src, w.to(torch.float32), Y,
                                            Wv)
        _scatter(Z, rows, cls, val)
    return Z


# ---------------------------------------------------------------------------
# Unsupervised refinement (GEE clustering)
# ---------------------------------------------------------------------------
#
# These use matrix products: where they run on a card, the caller keeps
# torch.backends.cuda.matmul.allow_tf32 = False (the default) so the
# products stay in full float32.


def _kmeans_assign(Z, centers):
    d2 = ((Z * Z).sum(1, keepdim=True) - 2 * Z @ centers.T
          + (centers * centers).sum(1))
    return torch.argmin(d2, dim=1).to(torch.int32)   # first minimum


def _kmeans_update(Z, labels, K):
    onehot = torch.nn.functional.one_hot(labels.long(), K).to(Z.dtype)
    sums = onehot.T @ Z
    counts = onehot.sum(0)[:, None]
    return sums / torch.clamp_min(counts, 1.0)


def kmeans_refine_round(Z, labels, Y0, K: int, kmeans_iters: int):
    """One refinement round's label update: row-normalize Z, k-means,
    reassign with the supervised labels in Y0 pinned."""
    if kmeans_iters < 1:
        raise ValueError("kmeans_iters must be >= 1")
    Zn = Z / torch.clamp_min(
        torch.linalg.vector_norm(Z, dim=1, keepdim=True), 1e-9)
    centers = _kmeans_update(Zn, labels, K)
    for _ in range(kmeans_iters):
        assign = _kmeans_assign(Zn, centers)
        centers = _kmeans_update(Zn, assign, K)
    return torch.where(Y0 >= 0, Y0.to(torch.int32), assign)
