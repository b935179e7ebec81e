"""One-Hot Graph Encoder Embedding (GEE) in PyTorch.

The port of `repro.core.gee`.  Label convention: Y in {-1 = unknown,
0..K-1}.  The paper's serial edge loop with atomic ``writeAdd`` is a
vectorized scatter-add: jnp's ``.at[].add``.  On the CPU it is
`add_in_order` (numpy's serial ``np.add.at``), which adds the
contributions to each entry in list order, so Z has the same bits on
every run and thread count (PyTorch's ``index_put_(accumulate=True)`` on
the CPU does not); on a card it is ``index_put_(accumulate=True)``.  Every function works on tensors of any
one device; the caller places them.

Variants:
  * ``gee``            — one-pass embedding (weighted, directed;
                          symmetric contribution per the paper)
  * ``laplacian=True`` — w' = w / sqrt(deg_u * deg_v)
  * ``gee_apply_delta`` / ``gee_streaming`` — exact incremental and
                          chunked accumulate (Z is linear in the edges)
  * ``*_owned``        — the same over pre-bucketed owned-destination
                          contributions (a row partition's slice)
  * ``kmeans_refine_round`` / ``gee_refine`` — unsupervised refinement
  * ``gee_dense_oracle`` — the O(n^2) dense form, a tiny-graph oracle
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def add_in_order(flat: torch.Tensor, idx, val) -> torch.Tensor:
    """flat[idx[i]] += val[i] for i = 0, 1, ... in turn, in place: each
    entry gets its own contributions in list order, a serial float32 sum
    starting from the entry's value, the same bits on every run and
    thread count.  On the CPU this is numpy's unbuffered ``np.add.at``
    on the tensor's memory; on a card `_add_by_rank`.  Returns `flat`."""
    if flat.device.type == "cpu":
        np.add.at(flat.numpy(), idx.long().numpy(),
                  val.to(flat.dtype).numpy())
        return flat
    return _add_by_rank(flat, idx, val)


def _add_by_rank(flat: torch.Tensor, idx, val) -> torch.Tensor:
    """`add_in_order` with tensor ops on any device: a stable sort of
    `idx` gives each contribution its rank within its entry's run, and
    the ranks are added one after another with `index_add_`, which then
    holds no index twice (one step per rank: as many as the longest
    run)."""
    idx = idx.long()
    val = val.to(flat.dtype)
    m = idx.shape[0]
    if m == 0:
        return flat
    order = torch.sort(idx, stable=True).indices
    ks = idx[order]
    pos = torch.arange(m, device=idx.device)
    first = torch.ones(m, dtype=torch.bool, device=idx.device)
    first[1:] = ks[1:] != ks[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = order[torch.sort(rank, stable=True).indices]
    start = 0
    for c in torch.bincount(rank).tolist():
        sel = by_rank[start:start + c]
        flat.index_add_(0, idx[sel], val[sel])
        start += c
    return flat


def scatter_add_ordered(Z: torch.Tensor, rows, cls, val) -> torch.Tensor:
    """Z[rows, cls] += val in list order (`add_in_order`), in place on a
    contiguous (n, K) Z.  Returns Z."""
    add_in_order(Z.view(-1), rows.long() * Z.shape[1] + cls.long(), val)
    return Z


def _add(flat: torch.Tensor, idx, val) -> torch.Tensor:
    """flat[idx] += val (duplicates accumulate), in place: in list order
    on the CPU, the library scatter on a card."""
    if flat.device.type == "cpu":
        return add_in_order(flat, idx, val)
    return flat.index_put_((idx.long(),), val.to(flat.dtype),
                           accumulate=True)


def make_w(Y: torch.Tensor, K: int) -> torch.Tensor:
    """Per-node projection weight: 1/|class(Y_i)| (0 for unlabeled).

    float32 math as in `repro.core.gee.make_w` (counts summed in
    float32, one IEEE division), so Wv is bit-equal to the reference."""
    labeled = Y >= 0
    counts = _add(torch.zeros(K, dtype=torch.float32, device=Y.device),
                  torch.where(labeled, Y, 0), labeled.to(torch.float32))
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
    """Z[rows, cls] += val, in place (duplicates accumulate; in list
    order on the CPU)."""
    _add(Z.view(-1), rows.long() * Z.shape[1] + cls.long(), val)
    return Z


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
            _add(deg, torch.cat([u.long(), v.long()]), torch.cat([w, w]))
        scale = torch.rsqrt(torch.clamp_min(deg, 1.0))
        w = w * scale[u.long()] * scale[v.long()]
    if Wv is None:
        Wv = make_w(Y, K)
    dst, cls, val = edge_contributions(u, v, w, Y, Wv)
    Z = torch.zeros((n, K), dtype=torch.float32, device=w.device)
    return _scatter(Z, dst, cls, val)


def gee_dense_oracle(u, v, w, Y, K: int, n: int) -> torch.Tensor:
    """O(n^2) dense formulation Z = A @ Wmat, a tiny-graph test oracle:
    Wmat is the paper's (n, K) one-hot projection matrix and A the
    adjacency symmetrized as Algorithm 1's two updates imply."""
    u, v = u.long(), v.long()
    w = w.to(torch.float32)
    A = torch.zeros(n * n, dtype=torch.float32, device=w.device)
    _add(A, torch.cat([u * n + v, v * n + u]), torch.cat([w, w]))
    Wv = make_w(Y, K)
    labeled = (Y >= 0).to(torch.float32)
    onehot = torch.nn.functional.one_hot(
        torch.clamp_min(Y, 0).long(), K).to(torch.float32)
    return A.view(n, n) @ (onehot * (labeled * Wv)[:, None])


def gee_apply_delta(Z, u, v, w, Y, Wv, *, K: int, sign: float = 1.0):
    """Fold an edge batch into Z: insertions (sign=+1) and deletions
    (sign=-1) in O(batch), exact by linearity.  Wv must be the weights
    Z was built with.  Returns a new tensor; Z is left as it was."""
    dst, cls, val = edge_contributions(u, v, w.to(torch.float32), Y, Wv)
    return _scatter(Z.clone(memory_format=torch.contiguous_format), dst,
                    cls, sign * val)


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
    return _scatter(Z.clone(memory_format=torch.contiguous_format), rows,
                    cls, sign * val)


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


def gee_refine(u, v, w, Y0, generator: torch.Generator, *, K: int, n: int,
               iters: int = 10, kmeans_iters: int = 3):
    """Iterative GEE clustering: embed with the current labels, k-means
    in the K-dim embedding, reassign, repeat.  Y0 may be all unknown
    (-1); unknowns bootstrap from a random assignment drawn from
    `generator` (other bits than the reference's `jax.random`).  Each
    round embeds through `kernels.ops.gee_cuda`: the scatter kernel on
    a card, its plain version on the CPU.  Returns (Z, labels)."""
    from repro_torch.kernels.ops import gee_cuda
    rand = torch.randint(0, K, (n,), generator=generator,
                         dtype=torch.int32, device=generator.device)
    Y0 = Y0.to(torch.int32)
    labels = torch.where(Y0 >= 0, Y0, rand.to(Y0.device))
    for _ in range(iters):
        Z = gee_cuda(u, v, w, labels, K=K, n=n)
        labels = kmeans_refine_round(Z, labels, Y0, K, kmeans_iters)
    return gee_cuda(u, v, w, labels, K=K, n=n), labels
