"""Graph IO: npz snapshots + host-sharded streaming loader.

The port's own copy of `repro.graph.io` (numpy only): the same file
format, so a file saved by either package loads in the other.

At Friendster scale (1.8 B edges = ~22 GB as int32 triples) a single
host cannot hold the edge list; `ShardedEdgeReader` streams fixed-size
chunks so each host of a pod loads only its slice (the production
ingestion path; tests exercise it with small files).

The reader does NOT materialize whole npz members: each array inside
the zip is opened as a stream, its npy header parsed, bytes up to the
host's slice skipped, and chunks decoded with `np.frombuffer` — peak
host memory is O(chunk_size), independent of the file's edge count.
"""
from __future__ import annotations

import mmap as _mmap_mod
import os
import zipfile
from typing import IO, Iterator

import numpy as np

from repro_torch.graph.edges import Graph

_SKIP_BUF = 1 << 24        # discard stride while seeking into a slice


def _advise_sequential(arr: np.ndarray) -> None:
    """Hint the kernel that a memory-mapped array will be scanned
    front-to-back (`madvise(MADV_SEQUENTIAL)`): readahead doubles and
    pages behind the scan are dropped early, which is exactly the
    access pattern of a sharded edge scan.  Purely advisory — guarded
    for platforms (or numpy internals) without madvise, where it is a
    silent no-op."""
    mm = getattr(arr, "_mmap", None)
    advise = getattr(mm, "madvise", None)                 # py>=3.8, unix
    flag = getattr(_mmap_mod, "MADV_SEQUENTIAL", None)    # not on win
    if advise is None or flag is None:
        return
    try:
        advise(flag)
    except (OSError, ValueError):      # e.g. offset-page quirks: hint
        pass                           # only, never fail the read


def save_graph(path: str, g: Graph, *, compressed: bool = True) -> None:
    """Atomic npz snapshot.  compressed=False writes STORED zip members,
    which `ShardedEdgeReader` can memory-map instead of stream-decode."""
    tmp = path + ".tmp.npz"     # keep the suffix so savez doesn't append
    savez = np.savez_compressed if compressed else np.savez
    savez(tmp, u=g.u, v=g.v, w=g.w, n=np.int64(g.n))
    os.replace(tmp, path)


def load_graph(path: str) -> Graph:
    with np.load(path) as d:    # context-managed: no leaked zip handle
        return Graph(d["u"], d["v"], d["w"], int(d["n"]))


def _check_header(name: str, fortran: bool, shape: tuple) -> None:
    if fortran or len(shape) > 1:
        raise ValueError(f"npz member {name!r} is not a flat C-order "
                         f"array (shape {shape})")


def _open_member(zf: zipfile.ZipFile, name: str) -> tuple[IO[bytes],
                                                          np.dtype, int]:
    """Open `name.npy` inside the zip positioned at the data section.

    Returns (stream, dtype, count) without reading the array body."""
    f = zf.open(name + ".npy")
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    else:
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    _check_header(name, fortran, shape)
    return f, dtype, int(shape[0]) if shape else 1


def _skip(f: IO[bytes], nbytes: int) -> None:
    """Advance a (possibly compressed, forward-only) stream by nbytes."""
    while nbytes > 0:
        got = f.read(min(nbytes, _SKIP_BUF))
        if not got:
            raise EOFError("npz member shorter than header promised")
        nbytes -= len(got)


def _read_exact(f: IO[bytes], nbytes: int) -> bytes:
    parts = []
    while nbytes > 0:
        got = f.read(nbytes)
        if not got:
            raise EOFError("npz member shorter than header promised")
        parts.append(got)
        nbytes -= len(got)
    return b"".join(parts)


def _mmap_member(path: str, name: str) -> np.ndarray:
    """Memory-map `name.npy` inside an UNCOMPRESSED (ZIP_STORED) npz.

    A stored zip member is a verbatim .npy file at a fixed offset, so
    the array body can be mapped directly — zero decode, zero copy, the
    OS pages in only the slices actually read."""
    with zipfile.ZipFile(path) as zf:
        zi = zf.getinfo(name + ".npy")
        if zi.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"member {name!r} is compressed; mmap needs "
                             "an uncompressed snapshot "
                             "(save_graph(..., compressed=False))")
        with zf.open(zi) as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(f)
            _check_header(name, fortran, shape)
            header_len = f.tell()      # npy magic+header inside the member
        # data offset in the outer file: local header + npy header.
        # Parse the LOCAL header's name/extra lengths (the central
        # directory's extra field may differ from the local one).
        with open(path, "rb") as raw:
            raw.seek(zi.header_offset + 26)
            name_len, extra_len = np.frombuffer(raw.read(4), "<u2")
        data_off = (zi.header_offset + 30 + int(name_len) + int(extra_len)
                    + header_len)
    count = int(shape[0]) if shape else 1
    return np.memmap(path, dtype=dtype, mode="r", offset=data_off,
                     shape=(count,))


def is_mmapable(path: str) -> bool:
    """True iff every edge member of the npz is ZIP_STORED."""
    with zipfile.ZipFile(path) as zf:
        return all(zf.getinfo(k + ".npy").compress_type
                   == zipfile.ZIP_STORED for k in ("u", "v", "w"))


class ShardedEdgeReader:
    """Streams the edge slice belonging to (host_id, num_hosts).

    Edges are split contiguously; random edge order must be pre-shuffled
    on disk (generators do).  chunk_size bounds host memory: members are
    decoded chunk-by-chunk from the zip streams, never loaded whole.

    For UNCOMPRESSED snapshots (`save_graph(..., compressed=False)`) the
    reader takes an mmap fast-path: members are memory-mapped in place
    and chunks are zero-copy views — no inflate, no byte shuffling, and
    the page cache is shared across readers on the same host.  `mmap`
    is auto-detected (None); pass False to force the streaming path or
    True to require mapping (raises on a compressed file)."""

    def __init__(self, path: str, host_id: int, num_hosts: int,
                 chunk_size: int = 1 << 22, mmap: bool | None = None):
        self.path = path
        self.mmap = is_mmapable(path) if mmap is None else mmap
        with zipfile.ZipFile(path) as zf:
            f, _, s = _open_member(zf, "u")
            f.close()
            fn, ndt, _ = _open_member(zf, "n")
            self.n = int(np.frombuffer(_read_exact(fn, ndt.itemsize),
                                       dtype=ndt)[0])
            fn.close()
        per = (s + num_hosts - 1) // num_hosts
        self.lo = host_id * per
        self.hi = min(s, self.lo + per)
        self.chunk = chunk_size

    def _iter_mmap(self) -> Iterator[Graph]:
        u, v, w = (_mmap_member(self.path, k) for k in ("u", "v", "w"))
        for arr in (u, v, w):          # sequential-scan readahead hint
            _advise_sequential(arr)
        for off in range(self.lo, self.hi, self.chunk):
            end = min(off + self.chunk, self.hi)
            yield Graph(u[off:end], v[off:end], w[off:end], self.n)

    def __iter__(self) -> Iterator[Graph]:
        if self.lo >= self.hi:
            return
        if self.mmap:
            yield from self._iter_mmap()
            return
        with zipfile.ZipFile(self.path) as zf:
            streams = {}
            for key in ("u", "v", "w"):
                f, dtype, _ = _open_member(zf, key)
                _skip(f, self.lo * dtype.itemsize)
                streams[key] = (f, dtype)
            for off in range(self.lo, self.hi, self.chunk):
                m = min(self.chunk, self.hi - off)
                u, v, w = (
                    np.frombuffer(_read_exact(f, m * dt.itemsize), dtype=dt)
                    for (f, dt) in (streams[k] for k in ("u", "v", "w")))
                yield Graph(u, v, w, self.n)
            for f, _ in streams.values():
                f.close()
