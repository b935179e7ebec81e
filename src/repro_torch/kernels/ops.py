"""Packing and the kernel-path GEE (`gee_cuda`, the `gee_pallas` analog).

`pack_edges` differs from the reference's in one respect: it sorts
contributions stably by destination ROW, not only by tile, and pads each
tile's slot range with row `tile_n - 1`, so every tile's slots are in
non-decreasing row order.  That is what lets the scatter kernel add each
row's run with one thread and no atomics.  Each tile holds the same
multiset as the reference's packing; only the order inside it differs.
It runs with torch on the inputs' device.
"""
from __future__ import annotations

import torch

from repro_torch.core.gee import edge_contributions, make_w
from repro_torch.kernels.gee_scatter import EDGE_BLOCK, TILE_N, gee_scatter


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_edges(dst, src, val, n: int, tile_n: int = TILE_N,
               edge_block: int = EDGE_BLOCK):
    """Sort contributions stably by destination row and pack them into
    uniform (T, BPT, EB) blocks, tile t holding rows [t*tile_n,
    (t+1)*tile_n) as tile-local rows.

    `src` is whatever rides with each contribution (a class, or the
    label-donor node of a label-free plan), `val` its value or weight.
    Returns (rows int32, src int32, val float32, T, counts int32 (T,)):
    counts[t] real entries sit at the start of tile t's slots, the rest
    are padding with row tile_n - 1, src 0 and val 0."""
    dst = torch.as_tensor(dst).long()
    dev = dst.device
    src = torch.as_tensor(src, device=dev).to(torch.int32)
    val = torch.as_tensor(val, device=dev).to(torch.float32)
    T = _round_up(n, tile_n) // tile_n
    order = torch.sort(dst, stable=True).indices
    dst_s = dst[order]
    tile_s = dst_s // tile_n
    counts = torch.bincount(tile_s, minlength=T)
    bpt = max(1, -(-int(counts.max()) // edge_block)) if T else 1
    per_tile = bpt * edge_block
    starts = torch.cumsum(counts, 0) - counts
    slot = tile_s * per_tile + (torch.arange(dst_s.shape[0], device=dev)
                                - starts[tile_s])
    rows_buf = torch.full((T * per_tile,), tile_n - 1, dtype=torch.int32,
                          device=dev)
    src_buf = torch.zeros(T * per_tile, dtype=torch.int32, device=dev)
    val_buf = torch.zeros(T * per_tile, dtype=torch.float32, device=dev)
    rows_buf[slot] = (dst_s - tile_s * tile_n).to(torch.int32)
    src_buf[slot] = src[order]
    val_buf[slot] = val[order]
    shape = (T, bpt, edge_block)
    return (rows_buf.reshape(shape), src_buf.reshape(shape),
            val_buf.reshape(shape), T, counts.to(torch.int32))


def gee_cuda(u, v, w, Y, *, K: int, n: int, tile_n: int = TILE_N,
             edge_block: int = EDGE_BLOCK) -> torch.Tensor:
    """GEE through the scatter kernel (its plain version on CPU
    tensors).  Returns Z (n, K) float32 on the inputs' device."""
    Wv = make_w(Y, K)
    dst, cls, val = edge_contributions(u, v, w.to(torch.float32), Y, Wv)
    rows, clsb, valb, T, counts = pack_edges(dst, cls, val, n, tile_n,
                                             edge_block)
    Z = gee_scatter(rows, clsb, valb, counts, num_tiles=T, tile_n=tile_n,
                    kdim=K)
    return Z[:n]
