"""Fused query-side kernels: cosine top-k and delta + renormalize.

The port of `repro.kernels.query_fused` (``csrc/query_fused.cu``):

``topk_fused``
    optional row-normalize (emitting Zn) + cosine scores + top-k over a
    shard's candidate rows, ordered by (-score, ascending global id).
    Two launches: a select pass, in which each block walks a contiguous
    range of row tiles and keeps per query only the rows that beat its
    running k-th best, then writes its k candidates per query; and a
    merge pass, one block per query, over the blocks' candidates.  The
    select grid comes from the card's occupancy (`topk_select_grid`);
    the answer does not depend on it.
``gee_delta_renorm``
    Z_new = Z + delta contributions, Zn = normalize_rows(Z_new), for the
    whole owned slice, with Z read once.

Both take any width.  The select bodies that the main path runs hold
their lists, buffers and query group in shared memory, for k <= 64 and
K <= 256; any other (K, k) takes a general path that scores rows from
device memory and keeps its lists there, chosen by the launchers from
the shape.  The delta kernel stages 256 rows in shared memory for
K <= 128 and works on its rows in device memory above that.  The answer
has the same bits either way.

**One arithmetic for norms and scores.**  `normalize_rows` and
`row_scores` spell out a fixed-order elementwise loop over the K
columns (``((x0*x0 + x1*x1) + ...)``, each product and sum rounded on
its own), and the kernels do exactly the same with explicitly rounded
operations.  A row's Zn and a (query, row) score therefore have the same
bits on the card and in the plain versions, whatever the block, chunk or
shard split: the kernels are held to their plain versions with
`array_equal`, and sharded answers are bit-equal to single-slice ones.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises (a TypeError for float inputs that require
grad: neither kernel has a backward).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.gee import scatter_add_ordered
from repro_torch.kernels import _build

EPS = 1e-9        # normalize_rows' clamp


def normalize_rows(X: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """X / max(||X||_2, eps) row-wise, the norm summed over the K columns
    in order (the kernels' arithmetic, see the module docstring).  The
    square root is taken in float64 and rounded once to float32, which
    is the correctly rounded float32 root (53 >= 2 x 24 + 2 bits), as
    the kernels' `__fsqrt_rn`: the host's float32 `torch.sqrt` is not
    always correctly rounded, the card's is."""
    ss = X[..., 0] * X[..., 0]
    for c in range(1, X.shape[-1]):
        ss = ss + X[..., c] * X[..., c]
    norm = torch.sqrt(ss.to(torch.float64)).to(X.dtype)
    return X / norm.clamp_min(eps)[..., None]


def row_scores(q: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """(nq, m) dot products q @ Z.T, each a fixed-order K-term sum."""
    s = q[:, None, 0] * Z[None, :, 0]
    for c in range(1, q.shape[-1]):
        s = s + q[:, None, c] * Z[None, :, c]
    return s


def topk_block(vals, idxs, q, block, gidx, qnodes, *, exclude_self: bool,
               k: int):
    """Merge one candidate block into the running (vals, idxs) top-k.

    `gidx` holds each block row's global id (-1: padding, masked).  The
    running candidates go BEFORE the block and the stable descending
    sort keeps the earlier position on ties, so with blocks in ascending
    id order ties resolve to the ascending global id."""
    scores = row_scores(q, block)
    mask = (gidx < 0)[None, :]
    if exclude_self:
        mask = mask | (gidx[None, :] == qnodes[:, None])
    scores = scores.masked_fill(mask, float("-inf"))
    cat_v = torch.cat([vals, scores], 1)
    cat_i = torch.cat([idxs, gidx[None, :].expand(scores.shape[0], -1)], 1)
    v, sel = torch.sort(cat_v, dim=1, descending=True, stable=True)
    return v[:, :k], torch.take_along_dim(cat_i, sel[:, :k], 1)


def topk_scan(Zn_rows, ids, q, qnodes, *, k: int, block_rows: int,
              exclude_self: bool):
    """Blocked scan of unit-norm rows `Zn_rows` carrying ascending global
    `ids` (int32): the running top-k merged block by block.  Unfilled
    slots (k > candidates) come out as idx -1 / score -inf.  Returns
    (vals (nq, k) float32, idxs (nq, k) int32) on the rows' device."""
    nq = q.shape[0]
    dev = Zn_rows.device
    vals = torch.full((nq, k), float("-inf"), dtype=torch.float32,
                      device=dev)
    idxs = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    qnodes = torch.as_tensor(qnodes, device=dev).to(torch.int32)
    for base in range(0, Zn_rows.shape[0], block_rows):
        vals, idxs = topk_block(vals, idxs, q,
                                Zn_rows[base:base + block_rows],
                                ids[base:base + block_rows], qnodes,
                                exclude_self=exclude_self, k=k)
    return vals, torch.where(torch.isfinite(vals), idxs,
                             torch.full_like(idxs, -1))


def topk_fused_plain(Z_rows, q, qnodes, *, k: int, row_offset: int = 0,
                     exclude_self: bool = True, normalize: bool = False,
                     eps: float = EPS, block_rows: int = 1 << 14):
    """Plain PyTorch version of `topk_fused`: normalize_rows, then the
    blocked scan."""
    Zn = normalize_rows(Z_rows, eps) if normalize else Z_rows
    ids = torch.arange(row_offset, row_offset + Z_rows.shape[0],
                       dtype=torch.int32, device=Z_rows.device)
    vals, idxs = topk_scan(Zn, ids, q, qnodes, k=k, block_rows=block_rows,
                           exclude_self=exclude_self)
    return (vals, idxs, Zn) if normalize else (vals, idxs)


def _topk_select(Z_rows, q, qnodes, zn, *, k: int, row_offset: int,
                 exclude_self: bool, eps: float):
    """The select pass alone: every candidate list's top-k per query
    (one list a block, or a warp on the general path), as (cand_s, cand_i)
    of shape (nq, grid, k); Zn written into `zn` when it is not None.  No
    launch count (`topk_fused` counts its call)."""
    dev = Z_rows.device
    m, K = Z_rows.shape
    nq = q.shape[0]
    grid = ctypes.c_int(0)
    err = _build.function("query_fused", "topk_select_grid",
                          [_build.P] + [_build.I] * 4 + [_build.P])(
        Z_rows.data_ptr(), m, K, k, nq, ctypes.byref(grid))
    _build.check("query_fused", err)
    cand_s = torch.empty((nq, grid.value, k), dtype=torch.float32,
                         device=dev)
    cand_i = torch.empty((nq, grid.value, k), dtype=torch.int32, device=dev)
    if grid.value > 0:
        # the blocks' shared thresholds, one 64-bit key a query; 0: none
        gkey = torch.zeros(nq, dtype=torch.int64, device=dev)
        fn = _build.function("query_fused", "topk_select_launch",
                             [_build.P] * 7 + [_build.I] * 7
                             + [_build.F, _build.P])
        err = fn(Z_rows.data_ptr(), q.data_ptr(), qnodes.data_ptr(),
                 None if zn is None else zn.data_ptr(), cand_s.data_ptr(),
                 cand_i.data_ptr(), gkey.data_ptr(), m, K, nq, k,
                 grid.value, int(row_offset), int(exclude_self), eps,
                 _build.stream_of(dev))
        _build.check("query_fused", err)
    return cand_s, cand_i


def _topk_merge(cand_s, cand_i, *, k: int):
    """The merge pass alone: each query's top-k of its grid x k
    candidates, as (vals, idxs) of shape (nq, k)."""
    nq, grid = cand_s.shape[:2]
    dev = cand_s.device
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    fn = _build.function("query_fused", "topk_merge_launch",
                         [_build.P] * 4 + [_build.I] * 3 + [_build.P])
    err = fn(cand_s.data_ptr(), cand_i.data_ptr(), vals.data_ptr(),
             idxs.data_ptr(), grid, nq, k, _build.stream_of(dev))
    _build.check("query_fused", err)
    return vals, idxs


def topk_fused(Z_rows, q, qnodes, *, k: int, row_offset: int = 0,
               exclude_self: bool = True, normalize: bool = False,
               eps: float = EPS):
    """Normalize (optionally) + cosine score + top-k on the card: a
    select pass and a merge pass (``csrc/query_fused.cu``).

    Z_rows (m, K) float32: candidate rows at global ids [row_offset,
    row_offset + m), RAW when normalize=True, unit-norm otherwise.
    q (nq, K) float32 unit-norm queries; qnodes (nq,) int32 global ids
    for self-exclusion.  Returns (vals (nq, k) float32, idxs (nq, k)
    int32), plus Zn (m, K) when normalize=True; unfilled slots (k beyond
    the candidates) are already clamped to idx -1 / score -inf."""
    if k < 1:
        raise ValueError(f"topk_fused takes k >= 1, got {k}")
    dev = Z_rows.device
    if dev.type == "cpu":
        return topk_fused_plain(Z_rows, q, qnodes, k=k,
                                row_offset=row_offset,
                                exclude_self=exclude_self,
                                normalize=normalize, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"topk_fused runs on cpu or cuda, not {dev}")
    m, K = Z_rows.shape
    nq = q.shape[0]
    if row_offset + m > 2**31 - 1:
        raise ValueError("global row ids must fit in int32")
    _build.refuse_grad("topk_fused", Z_rows, q)
    _build.require("Z_rows", Z_rows, torch.float32, (m, K), dev)
    _build.require("q", q, torch.float32, (nq, K), dev)
    _build.require("qnodes", qnodes, torch.int32, (nq,), dev)
    zn = (torch.empty((m, K), dtype=torch.float32, device=dev)
          if normalize else None)
    with torch.cuda.device(dev):
        cand = _topk_select(Z_rows, q, qnodes, zn, k=k,
                            row_offset=row_offset,
                            exclude_self=exclude_self, eps=eps)
        vals, idxs = _topk_merge(*cand, k=k)
    _build.launches["topk_fused"] += 1
    return (vals, idxs, zn) if normalize else (vals, idxs)


def gee_delta_renorm_plain(Z, rows, cls, val, *, eps: float = EPS):
    """Plain PyTorch version of `gee_delta_renorm`: each entry of Z plus
    its contributions in list order, as the kernel adds them (the same
    bits)."""
    Z_new = scatter_add_ordered(Z.contiguous().clone(), rows, cls, val)
    return Z_new, normalize_rows(Z_new, eps)


def gee_delta_renorm(Z, rows, cls, val, *, eps: float = EPS):
    """Fold delta contributions into Z and renormalize, Z read once.

    Z (n_local, K) float32.  rows int32 (m,): LOCAL destination rows,
    sorted ascending (the kernel finds each row's run by binary search);
    cls int32 (m,) in [0, K); val float32 (m,), added in list order.
    Returns (Z_new, Zn), both (n_local, K) float32; Z is left as it
    was."""
    dev = Z.device
    if dev.type == "cpu":
        return gee_delta_renorm_plain(Z, rows, cls, val, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"gee_delta_renorm runs on cpu or cuda, not {dev}")
    n_local, K = Z.shape
    m = rows.shape[0]
    _build.refuse_grad("gee_delta_renorm", Z, val)
    _build.require("Z", Z, torch.float32, (n_local, K), dev)
    _build.require("rows", rows, torch.int32, (m,), dev)
    _build.require("cls", cls, torch.int32, (m,), dev)
    _build.require("val", val, torch.float32, (m,), dev)
    Z_new = torch.empty_like(Z)
    Zn = torch.empty_like(Z)
    fn = _build.function("query_fused", "delta_renorm_launch",
                         [_build.P] * 4 + [_build.I] + [_build.P] * 2
                         + [_build.I, _build.I, _build.F, _build.P])
    with torch.cuda.device(dev):
        err = fn(Z.data_ptr(), rows.data_ptr(), cls.data_ptr(),
                 val.data_ptr(), m, Z_new.data_ptr(), Zn.data_ptr(),
                 n_local, K, eps, _build.stream_of(dev))
    _build.check("query_fused", err)
    _build.launches["gee_delta_renorm"] += 1
    return Z_new, Zn
