"""GEE edge scatter: row-sorted contributions -> Z, one tile per block.

The port of `repro.kernels.gee_scatter.gee_scatter_pallas`.  It takes
the flat layout of `repro_torch.kernels.ops.pack_edges`: the
contributions sorted stably by destination row, row r's at
``[row_ptr[r], row_ptr[r + 1])`` of `cls` and `val`, with no padding.
The kernel (``csrc/gee_scatter.cu``) gives each tile of `tile_n` rows
to one block of 8 warps; each warp owns whole rows, so there are no
atomics, and every (row, class) sum is taken in packed order: Z has the
same bits on every run.  A tile whose Z rows do not fit in shared
memory is processed in sub-tiles (`subtile`), so any K is taken.

On CPU tensors `gee_scatter` runs `gee_scatter_plain`; on CUDA tensors
it launches the kernel or raises (a TypeError for values that require
grad: the kernel has no backward).
"""
from __future__ import annotations

import torch

from repro_torch.core.gee import scatter_add_ordered
from repro_torch.kernels import _build

TILE_N = 256          # Z rows per tile (one thread block each)
Z_FLOATS = 16_384     # most Z entries a block holds in shared memory
RP_ROWS = 2_048       # most rows a block holds offsets for at once


def subtile(tile_n: int, kdim: int) -> tuple:
    """(rows, columns) of the Z sub-tile one pass of a block holds: the
    whole tile where it fits, else row sub-ranges, and for a K wider than
    `Z_FLOATS` column ranges too (each column range reads its rows'
    contributions again)."""
    cols = min(kdim, Z_FLOATS)
    return min(tile_n, Z_FLOATS // cols, RP_ROWS), cols


def gee_scatter_plain(row_ptr, cls, val, *, num_tiles: int, tile_n: int,
                      kdim: int) -> torch.Tensor:
    """Plain PyTorch version: the rows expanded from `row_ptr`, each
    (row, class) summed serially in packed order
    (`core.gee.scatter_add_ordered`), which is the kernel's order: the
    same bits as the kernel, on every run.  Returns Z (num_tiles *
    tile_n, kdim) float32."""
    nrows = num_tiles * tile_n
    rows = torch.repeat_interleave(
        torch.arange(nrows, device=row_ptr.device), row_ptr.diff())
    Z = torch.zeros((nrows, kdim), dtype=torch.float32,
                    device=row_ptr.device)
    return scatter_add_ordered(Z, rows, cls, val)


def gee_scatter(row_ptr, cls, val, *, num_tiles: int, tile_n: int,
                kdim: int) -> torch.Tensor:
    """row_ptr: int64 (num_tiles * tile_n + 1,), non-decreasing from 0 to
    S; cls int32, val float32: (S,), row r's contributions at
    [row_ptr[r], row_ptr[r + 1]) (see `ops.pack_edges`).  Returns
    Z (num_tiles * tile_n, kdim) float32."""
    if tile_n < 1 or kdim < 1:
        raise ValueError(f"tile_n ({tile_n}) and kdim ({kdim}) must be >= 1")
    nrows = num_tiles * tile_n
    if row_ptr.shape != (nrows + 1,):
        raise ValueError(f"row_ptr has shape {tuple(row_ptr.shape)}, "
                         f"expected ({nrows + 1},) for {num_tiles} tiles")
    dev = row_ptr.device
    if dev.type == "cpu":
        return gee_scatter_plain(row_ptr, cls, val, num_tiles=num_tiles,
                                 tile_n=tile_n, kdim=kdim)
    if dev.type != "cuda":
        raise ValueError(f"gee_scatter runs on cpu or cuda, not {dev}")
    S = cls.shape[0] if cls.dim() == 1 else -1
    _build.refuse_grad("gee_scatter", val)
    _build.require("row_ptr", row_ptr, torch.int64, (nrows + 1,), dev)
    _build.require("cls", cls, torch.int32, (S,), dev)
    _build.require("val", val, torch.float32, (S,), dev)
    if cls.data_ptr() % 16 or val.data_ptr() % 16:
        raise ValueError("cls and val must start on 16 bytes (the kernel "
                         "copies them 16 bytes at a time)")
    Z = torch.empty((nrows, kdim), dtype=torch.float32, device=dev)
    if nrows == 0:
        return Z
    sub_rows, sub_cols = subtile(tile_n, kdim)
    fn = _build.function("gee_scatter", "gee_scatter_launch",
                         [_build.P] * 4 + [_build.I] * 5
                         + [_build.L, _build.P])
    with torch.cuda.device(dev):
        err = fn(row_ptr.data_ptr(), cls.data_ptr(), val.data_ptr(),
                 Z.data_ptr(), num_tiles, tile_n, kdim, sub_rows, sub_cols,
                 S, _build.stream_of(dev))
    _build.check("gee_scatter", err)
    _build.launches["gee_scatter"] += 1
    return Z
