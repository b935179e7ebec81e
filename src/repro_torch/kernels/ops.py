"""Packing and the kernel-path GEE (`gee_cuda`, the `gee_pallas` analog).

`pack_edges` does not build the reference's uniform (T, BPT, EB) blocks,
whose size follows the largest tile.  It sorts the contributions stably
by destination row into flat buffers of exactly S slots and describes
them with one offset per row (`row_ptr`), the layout the scatter kernel
reads.  Each tile holds the same multiset as the reference's packing;
only the order inside it differs.  It runs with torch on the inputs'
device.
"""
from __future__ import annotations

import torch

from repro_torch.core.gee import edge_contributions, make_w
from repro_torch.kernels.gee_scatter import TILE_N, gee_scatter


def pack_edges(dst, src, val, n: int, tile_n: int = TILE_N):
    """Sort contributions stably by destination row (contributions of one
    row keep their input order).

    `src` is whatever rides with each contribution (a class, or the
    label-donor node of a label-free plan), `val` its value or weight.
    Returns (row_ptr int64 (T * tile_n + 1,), src int32 (S,), val float32
    (S,), T) with T = ceil(n / tile_n): row r's contributions sit at
    [row_ptr[r], row_ptr[r + 1]), rows past n are empty, and tile t is
    rows [t * tile_n, (t + 1) * tile_n)."""
    dst = torch.as_tensor(dst).long()
    dev = dst.device
    src = torch.as_tensor(src, device=dev).to(torch.int32)
    val = torch.as_tensor(val, device=dev).to(torch.float32)
    T = -(-n // tile_n)
    order = torch.sort(dst, stable=True).indices
    row_ptr = torch.zeros(T * tile_n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(dst, minlength=T * tile_n), 0,
                 out=row_ptr[1:])
    return row_ptr, src[order], val[order], T


def gee_cuda(u, v, w, Y, *, K: int, n: int, tile_n: int = TILE_N
             ) -> torch.Tensor:
    """GEE through the scatter kernel (its plain version on CPU
    tensors).  Returns Z (n, K) float32 on the inputs' device."""
    Wv = make_w(Y, K)
    dst, cls, val = edge_contributions(u, v, w.to(torch.float32), Y, Wv)
    row_ptr, clsb, valb, T = pack_edges(dst, cls, val, n, tile_n)
    Z = gee_scatter(row_ptr, clsb, valb, num_tiles=T, tile_n=tile_n, kdim=K)
    return Z[:n]
