"""Query paths over a served embedding slice, in PyTorch.

The port of `repro.serving.queries` (the row-sliced forms a shard and
its merge need):

* ``topk_cosine_q``    — top-k of query vectors against a shard's
  unit-norm rows living at ``row_offset`` in the global id space.
* ``topk_cosine_ids``  — the same for gathered rows with explicit
  ascending global ids.
* ``topk_cosine_fused`` / ``topk_cosine_fused_norm`` — the same answers
  through the `topk_fused` kernel, on cached Zn or raw rows.
* ``merge_topk``       — merge per-shard candidate lists.
* ``class_sums`` / ``predict_rows`` — centroid statistics and
  prediction.

**Tie-breaking contract.**  Every top-k orders candidates by
``(-score, ascending global id)``.  The blocked scan gets it from a
stable sort with the running list placed before each block
(`kernels.query_fused.topk_block`, the reference's `_topk_block`;
`_topk_blocked` below is its blocked scan), the kernel from an explicit
comparison, `merge_topk` from a stable double argsort.  Scores and
norms are computed in one fixed order everywhere
(`kernels.query_fused.row_scores`, `normalize_rows`), so sharded,
single-slice, blocked and fused answers are bit-identical.

Results leave as numpy (idx int32, score float32), as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.query_fused import (normalize_rows, topk_block,
                                             topk_fused, topk_scan)

__all__ = ["normalize_rows", "class_sums", "predict_rows", "topk_block",
           "topk_cosine_q", "topk_cosine_ids", "topk_cosine_fused",
           "topk_cosine_fused_norm", "merge_topk"]


def class_sums(Z_rows: torch.Tensor, Y_rows: torch.Tensor, *, K: int):
    """Per-class (sums (K, K), counts (K,)) over a row slice; sum across
    shards and divide once for the global centroids.  (A matrix product:
    on a card keep torch.backends.cuda.matmul.allow_tf32 False.)"""
    labeled = (Y_rows >= 0).to(Z_rows.dtype)
    onehot = torch.nn.functional.one_hot(
        torch.clamp_min(Y_rows, 0).long(), K).to(Z_rows.dtype)
    onehot = onehot * labeled[:, None]
    return onehot.T @ Z_rows, onehot.sum(0)


def predict_rows(rows: torch.Tensor, centroids: torch.Tensor):
    """Label = argmax cosine(row, centroid_k) (first maximum).  Returns
    (pred int32, score)."""
    sims = normalize_rows(rows) @ normalize_rows(centroids).T
    return torch.argmax(sims, 1).to(torch.int32), torch.max(sims, 1).values


def _as_rows(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(torch.float32)


def _topk_blocked(Zn_rows, ids, q, qnodes, *, k: int, block_rows: int,
                  exclude_self: bool):
    vals, idxs = topk_scan(Zn_rows, ids, _as_rows(q, Zn_rows), qnodes,
                           k=k, block_rows=block_rows,
                           exclude_self=exclude_self)
    return idxs.cpu().numpy(), vals.cpu().numpy()


def topk_cosine_q(Zn_rows, q, qnodes, *, k: int = 10,
                  block_rows: int = 1 << 14, exclude_self: bool = True,
                  row_offset: int = 0):
    """Top-k of unit-norm queries `q` against unit-norm rows `Zn_rows`
    at global ids [row_offset, row_offset + len(Zn_rows)).  `qnodes`
    are the queries' global ids for self-exclusion.  Returns
    (indices (q, k) int32, scores (q, k) float32) as numpy; k beyond
    the candidates is clamped to idx -1 / score -inf."""
    ids = torch.arange(row_offset, row_offset + Zn_rows.shape[0],
                       dtype=torch.int32, device=Zn_rows.device)
    return _topk_blocked(Zn_rows, ids, q, qnodes, k=k,
                         block_rows=block_rows, exclude_self=exclude_self)


def topk_cosine_ids(Zn_rows, ids, q, qnodes, *, k: int = 10,
                    block_rows: int = 1 << 14, exclude_self: bool = True):
    """Top-k against GATHERED rows whose global ids `ids` are sorted
    ascending (so ties resolve exactly as the contiguous scan's)."""
    ids = torch.as_tensor(np.asarray(ids, np.int32), device=Zn_rows.device)
    return _topk_blocked(Zn_rows, ids, q, qnodes, k=k,
                         block_rows=block_rows, exclude_self=exclude_self)


def _fused_args(Z_rows, q, qnodes):
    return (Z_rows.contiguous(), _as_rows(q, Z_rows).contiguous(),
            torch.as_tensor(np.asarray(qnodes, np.int32),
                            device=Z_rows.device))


def topk_cosine_fused(Zn_rows, q, qnodes, *, k: int = 10,
                      exclude_self: bool = True, row_offset: int = 0):
    """`topk_cosine_q` through the `topk_fused` kernel: the same answer,
    bit for bit.  Rows must be unit-norm (a shard's cached Zn)."""
    vals, idxs = topk_fused(*_fused_args(Zn_rows, q, qnodes), k=k,
                            row_offset=int(row_offset),
                            exclude_self=exclude_self, normalize=False)
    return idxs.cpu().numpy(), vals.cpu().numpy()


def topk_cosine_fused_norm(Z_rows, q, qnodes, *, k: int = 10,
                           exclude_self: bool = True, row_offset: int = 0):
    """Fused normalize + cosine + top-k over RAW rows: one pass yields
    the answer and the slice's Zn.  Returns (idx, vals, Zn); (idx,
    vals) equal ``topk_cosine_q(normalize_rows(Z_rows), ...)``."""
    vals, idxs, Zn = topk_fused(*_fused_args(Z_rows, q, qnodes), k=k,
                                row_offset=int(row_offset),
                                exclude_self=exclude_self, normalize=True)
    return idxs.cpu().numpy(), vals.cpu().numpy(), Zn


def merge_topk(idx_parts, val_parts, *, k: int):
    """Merge per-part (idx, val) candidate lists into the global top-k,
    ordered by (-score, ascending id) via a stable double argsort — the
    result does not depend on the order of the parts.  Unfilled slots
    (idx -1, -inf) lose to any real candidate and stay clamped."""
    cat_v = torch.as_tensor(np.concatenate(
        [np.asarray(v, np.float32) for v in val_parts], 1))
    cat_i = torch.as_tensor(np.concatenate(
        [np.asarray(i, np.int32) for i in idx_parts], 1))
    order = torch.argsort(cat_i, dim=1, stable=True)      # secondary: id
    v = torch.take_along_dim(cat_v, order, 1)
    i = torch.take_along_dim(cat_i, order, 1)
    order = torch.argsort(-v, dim=1, stable=True)         # primary: score
    v = torch.take_along_dim(v, order, 1)[:, :k]
    i = torch.take_along_dim(i, order, 1)[:, :k]
    i = torch.where(torch.isfinite(v), i, torch.full_like(i, -1))
    return i.numpy(), v.numpy()
