"""GEE edge scatter: packed contributions -> Z, one tile per block.

The port of `repro.kernels.gee_scatter.gee_scatter_pallas`.  The kernel
(``csrc/gee_scatter.cu``) keeps each destination tile of Z in shared
memory and adds the tile's contributions in packed order, with no
atomics: Z has the same bits on every run.  It relies on the packing of
`repro_torch.kernels.ops.pack_edges`: contributions sorted by
destination row inside each tile, and `counts[t]` real entries at the
start of tile t's slot range.

On CPU tensors `gee_scatter` runs `gee_scatter_plain`; on CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE_N = 256          # Z rows per tile (one thread block each)
EDGE_BLOCK = 512      # packing granule: slots per tile are a multiple
SMEM_LIMIT = 232_448  # shared memory one block may use on sm_90
THREADS = 256         # threads per block, as in csrc/gee_scatter.cu


def gee_scatter_plain(rows, cls, val, counts=None, *, num_tiles: int,
                      tile_n: int, kdim: int) -> torch.Tensor:
    """Plain PyTorch version: one scatter-add over every packed slot
    (padding slots carry val 0 and add nothing).  Returns
    Z (num_tiles * tile_n, kdim) float32."""
    base = torch.arange(num_tiles, device=rows.device) * tile_n
    grow = (rows.long() + base[:, None, None]).reshape(-1)
    Z = torch.zeros((num_tiles * tile_n, kdim), dtype=torch.float32,
                    device=rows.device)
    return Z.index_put_((grow, cls.reshape(-1).long()),
                        val.reshape(-1).to(torch.float32), accumulate=True)


def gee_scatter(rows, cls, val, counts, *, num_tiles: int, tile_n: int,
                kdim: int) -> torch.Tensor:
    """rows (tile-local), cls: int32 (T, BPT, EB); val: float32 (T, BPT,
    EB); counts: int32 (T,) real entries per tile (see
    `ops.pack_edges`).  Returns Z (num_tiles * tile_n, kdim) float32."""
    T, BPT, EB = rows.shape
    if T != num_tiles:
        raise ValueError(f"rows has {T} tiles, num_tiles={num_tiles}")
    dev = rows.device
    if dev.type == "cpu":
        return gee_scatter_plain(rows, cls, val, counts,
                                 num_tiles=num_tiles, tile_n=tile_n,
                                 kdim=kdim)
    if dev.type != "cuda":
        raise ValueError(f"gee_scatter runs on cpu or cuda, not {dev}")
    for what, t, dt in (("rows", rows, torch.int32),
                        ("cls", cls, torch.int32),
                        ("val", val, torch.float32)):
        _build.require(what, t, dt, (T, BPT, EB), dev)
    _build.require("counts", counts, torch.int32, (T,), dev)
    if 4 * tile_n * kdim + 12 * THREADS > SMEM_LIMIT:
        raise ValueError(f"a {tile_n} x {kdim} tile does not fit in "
                         "shared memory")
    Z = torch.empty((T * tile_n, kdim), dtype=torch.float32, device=dev)
    fn = _build.function("gee_scatter", "gee_scatter_launch",
                         [_build.P] * 5 + [_build.I, _build.L, _build.I,
                                           _build.I, _build.P])
    with torch.cuda.device(dev):
        err = fn(rows.data_ptr(), cls.data_ptr(), val.data_ptr(),
                 counts.data_ptr(), Z.data_ptr(), T, BPT * EB, tile_n,
                 kdim, _build.stream_of(dev))
    _build.check("gee_scatter", err)
    _build.launches["gee_scatter"] += 1
    return Z
