"""Durable write-ahead delta log for the serving engine.

The port's own copy of `repro.serving.wal`: records are byte-for-byte
the reference's (`_encode` / `_decode`), so a log written by either
package replays in the other.  The INDEX kind is kept for that: the
port's engine has no IVF index yet and writes none, and a reference log
that holds one does not open in the port's engine.

The `GraphStore`'s in-memory delta log dies with the process; the WAL
is its durable twin.  Every mutation the engine accepts is appended
here BEFORE it is applied (append-before-apply), so a crashed engine
can be reconstructed exactly: load the last snapshot, replay the WAL
suffix, and the recovered `(version, epoch, fingerprint)` triple — and
the rebuilt Z — match the crashed process (tested).

Record kinds mirror the engine's write surface:

  EDGES    an edge batch with sign-folded weights (deletions carry
           negative w, exactly as the store logs them);
  LABELS   a label point-update (nodes, labels);
  COMPACT  a compaction marker — compaction is a deterministic pure
           function of store state, so replaying the marker reproduces
           the coalesced base (and its rehashed fingerprint);
  REBUILD  an explicit rebuild (``refresh()``), which advances the
           epoch without changing the multiset;
  INDEX    an IVF (re-)quantization: the payload is the engine's
           quantizer centroid matrix (K*K float32), so replay restores
           the exact quantizer and the recovered index — a pure
           function of (Z, centroids) — answers identically.

On-disk format (version-stamped file header, then records):

    [u32 payload_len][u32 crc32(payload)][payload]
    payload = [u8 kind][u64 version][u64 count][column bytes...]

Appends are flushed per record, so the log survives process death
(the crash-recovery contract).  ``fsync=True`` additionally fsyncs
every append for power-failure durability at a latency cost.  A torn
tail — a crash mid-append — is detected by length/CRC and truncated on
open: the WAL can lose at most the record being written, never parse
garbage into the store.

**Group commit** (``group_commit_ms`` / ``group_commit_bytes``, only
meaningful with ``fsync=True``): instead of one fsync per append,
records accumulate in an open *commit group* and a single fsync
barrier covers them all — closed when the group's bytes pass
``group_commit_bytes``, when its oldest append is older than
``group_commit_ms`` (checked on the next append and by the engine's
flush loop via :meth:`sync_if_due`), or explicitly via :meth:`sync`.
Every record is still written + flushed per append, so
append-before-apply and process-death durability are unchanged; only
the power-loss barrier is batched.  Submitters learn their version
only after the covering fsync: the engine's batcher finishes write
tickets after calling the target's ``sync_durable()``, so an
acknowledged write is always on stable storage.  ``appends_per_fsync``
and ``fsync_seconds`` quantify the batching in ``engine.stats()`` and
the ``repro_wal_group_*`` metric family.

**Read-side tailing** (read replicas): :func:`scan_wal` returns the
valid records *and* the byte offset they end at, and
:func:`tail_records` resumes parsing from such an offset — a replica
bootstraps from the owner's snapshot, replays the scan, then polls the
tail for fresh records.  A half-flushed record at the tail simply
reads as end-of-log and is retried on the next poll; the reader never
writes, truncates, or holds a lock on the owner's file.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch import obs

_FILE_MAGIC = b"REPROWAL1\n"
_HEADER = struct.Struct("<II")          # payload_len, crc32
_PREFIX = struct.Struct("<BQQ")         # kind, version, count

EDGES, LABELS, COMPACT, REBUILD, INDEX = 1, 2, 3, 4, 5
_MARKERS = (COMPACT, REBUILD)


@dataclass(frozen=True)
class WalRecord:
    """One replayable mutation.  For EDGES, `a, b, c` are (u, v, w)
    with w sign-folded; for LABELS they are (nodes, labels, None);
    for INDEX `a` is the flat float32 quantizer centroid matrix
    (reshaped to (K, K) by the replayer — K is the engine's);
    markers carry no arrays."""
    kind: int
    version: int
    a: Optional[np.ndarray] = None
    b: Optional[np.ndarray] = None
    c: Optional[np.ndarray] = None


def _encode(rec: WalRecord) -> bytes:
    if rec.kind == EDGES:
        u = np.ascontiguousarray(rec.a, np.int32)
        v = np.ascontiguousarray(rec.b, np.int32)
        w = np.ascontiguousarray(rec.c, np.float32)
        count = u.shape[0]
        cols = u.tobytes() + v.tobytes() + w.tobytes()
    elif rec.kind == LABELS:
        nodes = np.ascontiguousarray(rec.a, np.int64)
        labels = np.ascontiguousarray(rec.b, np.int32)
        count = nodes.shape[0]
        cols = nodes.tobytes() + labels.tobytes()
    elif rec.kind == INDEX:
        cent = np.ascontiguousarray(rec.a, np.float32).ravel()
        count = cent.shape[0]
        cols = cent.tobytes()
    elif rec.kind in _MARKERS:
        count, cols = 0, b""
    else:
        raise ValueError(f"unknown WAL record kind {rec.kind}")
    return _PREFIX.pack(rec.kind, rec.version, count) + cols


def _decode(payload: bytes) -> WalRecord:
    kind, version, count = _PREFIX.unpack_from(payload)
    body = payload[_PREFIX.size:]
    if kind == EDGES:
        expect = count * (4 + 4 + 4)
        if len(body) != expect:
            raise ValueError("EDGES record length mismatch")
        u = np.frombuffer(body[:4 * count], np.int32)
        v = np.frombuffer(body[4 * count:8 * count], np.int32)
        w = np.frombuffer(body[8 * count:], np.float32)
        return WalRecord(kind, version, u, v, w)
    if kind == LABELS:
        expect = count * (8 + 4)
        if len(body) != expect:
            raise ValueError("LABELS record length mismatch")
        nodes = np.frombuffer(body[:8 * count], np.int64)
        labels = np.frombuffer(body[8 * count:], np.int32)
        return WalRecord(kind, version, nodes, labels)
    if kind == INDEX:
        if len(body) != count * 4:
            raise ValueError("INDEX record length mismatch")
        return WalRecord(kind, version, np.frombuffer(body, np.float32))
    if kind in _MARKERS and not body:
        return WalRecord(kind, version)
    raise ValueError(f"unknown WAL record kind {kind}")


def _scan_valid(path: str) -> tuple[list[WalRecord], int]:
    """Parse records up to the first torn/corrupt one.

    Returns (records, valid_byte_length).  Standard WAL semantics: a
    crash mid-append leaves a torn tail, which reads as end-of-log."""
    records: list[WalRecord] = []
    with open(path, "rb") as f:
        magic = f.read(len(_FILE_MAGIC))
        if magic != _FILE_MAGIC:
            return [], 0 if len(magic) < len(_FILE_MAGIC) else -1
        good = f.tell()
        while True:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                break
            length, crc = _HEADER.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break
            try:
                records.append(_decode(payload))
            except ValueError:
                break
            good = f.tell()
    return records, good


def scan_wal(path: str) -> tuple[list[WalRecord], int]:
    """Valid records plus the byte offset they end at — the tail
    position a read replica resumes from with `tail_records`."""
    records, good = _scan_valid(path)
    if good < 0:
        raise ValueError(f"{path} is not a WAL file")
    return records, good


def tail_records(path: str, offset: int) -> tuple[list[WalRecord], int]:
    """Parse records appended after `offset` (a position previously
    returned by `scan_wal`/`tail_records`).  A torn or half-flushed
    record reads as end-of-log — the next poll retries from the same
    offset.  Read-only: never truncates the live writer's file.  A file
    shorter than `offset` (rotation raced the reader) yields nothing."""
    records: list[WalRecord] = []
    good = offset
    try:
        f = open(path, "rb")
    except OSError:                      # rotated away mid-poll
        return records, good
    with f:
        f.seek(0, os.SEEK_END)
        if f.tell() < offset:
            return records, good
        f.seek(offset)
        while True:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                break
            length, crc = _HEADER.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break
            try:
                records.append(_decode(payload))
            except ValueError:
                break
            good = f.tell()
    return records, good


class WriteAheadLog:
    """Append-only durable delta log (single writer).

    ``open()`` scans the file, truncates any torn tail, and returns the
    valid records so the engine can replay them; subsequent ``append_*``
    calls extend the same file.  A missing file is created empty."""

    _KIND_NAMES = {EDGES: "edges", LABELS: "labels",
                   COMPACT: "compact", REBUILD: "rebuild",
                   INDEX: "index"}

    def __init__(self, path: str, *, fsync: bool = False,
                 group_commit_ms: Optional[float] = None,
                 group_commit_bytes: Optional[int] = None):
        self.path = str(path)
        self.fsync = bool(fsync)
        #: group commit is an fsync-batching policy: without fsync
        #: there is no barrier to batch, so the knobs are inert
        self.group_commit_ms = (float(group_commit_ms)
                                if group_commit_ms is not None else None)
        self.group_commit_bytes = (int(group_commit_bytes)
                                   if group_commit_bytes is not None
                                   else None)
        self.group_commit = self.fsync and (
            self.group_commit_ms is not None
            or self.group_commit_bytes is not None)
        self.records_appended = 0
        #: wall seconds of the most recent append (write+flush[+fsync])
        #: — always tracked (cheap next to the flush syscall) because
        #: the engine's health() degrades on it even with obs off
        self.last_append_seconds = 0.0
        self.last_fsync_seconds = 0.0
        #: fsync-barrier accounting (`engine.stats()`'s wal_group row)
        self.fsyncs = 0
        self.fsync_seconds_total = 0.0
        self.appends_covered = 0
        self._pending = 0                # appends since the last barrier
        self._pending_bytes = 0
        self._pending_since = 0.0        # perf_counter of oldest pending
        self._f: Optional[object] = None

    # -- lifecycle ---------------------------------------------------------

    def open(self) -> list[WalRecord]:
        """Open for append; returns the existing valid records."""
        records: list[WalRecord] = []
        if os.path.exists(self.path):
            records, good = _scan_valid(self.path)
            if good < 0:
                raise ValueError(f"{self.path} is not a WAL file")
            if good < os.path.getsize(self.path):
                with open(self.path, "r+b") as f:  # torn tail: drop it
                    f.truncate(good)
        self._f = open(self.path, "ab")
        if self._f.tell() == 0:
            self._f.write(_FILE_MAGIC)
            self._f.flush()
        return records

    def close(self) -> None:
        if self._f is not None:
            self.sync()                  # never orphan an open group
            self._f.close()
            self._f = None

    @property
    def bytes_written(self) -> int:
        """Current file length (the checkpoint-trigger signal)."""
        if self._f is not None:
            return self._f.tell()
        return os.path.getsize(self.path) if os.path.exists(self.path) \
            else 0

    # -- appends (append-before-apply: callers write here FIRST) ----------

    def _append(self, rec: WalRecord) -> None:
        if self._f is None:
            raise RuntimeError("WAL not open")
        t0 = time.perf_counter()
        payload = _encode(rec)
        self._f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self._f.flush()                 # survives process death
        if self.fsync:                  # survives power loss
            if self.group_commit:
                # join the open commit group; the barrier comes later
                if not self._pending:
                    self._pending_since = t0
                self._pending += 1
                self._pending_bytes += _HEADER.size + len(payload)
                if ((self.group_commit_bytes is not None
                     and self._pending_bytes >= self.group_commit_bytes)
                    or (self.group_commit_ms is not None
                        and (time.perf_counter() - self._pending_since)
                        * 1e3 >= self.group_commit_ms)):
                    self.sync()
            else:
                tf = time.perf_counter()
                os.fsync(self._f.fileno())
                self.last_fsync_seconds = time.perf_counter() - tf
                self.fsyncs += 1
                self.fsync_seconds_total += self.last_fsync_seconds
                self.appends_covered += 1
        self.last_append_seconds = time.perf_counter() - t0
        self.records_appended += 1
        if obs.enabled():
            obs.observe("repro_serving_wal_append_seconds",
                        self.last_append_seconds)
            if self.fsync and not self.group_commit:
                obs.observe("repro_serving_wal_fsync_seconds",
                            self.last_fsync_seconds)
            obs.counter("repro_serving_wal_append_bytes_total",
                        _HEADER.size + len(payload))
            obs.counter("repro_serving_wal_records_total",
                        kind=self._KIND_NAMES.get(rec.kind,
                                                  str(rec.kind)))

    # -- group commit (fsync batching) ------------------------------------

    @property
    def pending_appends(self) -> int:
        """Appends flushed but not yet covered by an fsync barrier."""
        return self._pending

    @property
    def appends_per_fsync(self) -> float:
        """Mean records per fsync barrier — the group-commit win
        (1.0 under flush-per-record fsync)."""
        return self.appends_covered / self.fsyncs if self.fsyncs else 0.0

    def sync(self) -> int:
        """Close the open commit group with one fsync; returns the
        number of appends the barrier covered.  A no-op when nothing is
        pending (non-group mode fsyncs inline, fsync=False has no
        power-loss contract to uphold)."""
        if self._f is None or not self._pending:
            return 0
        tf = time.perf_counter()
        os.fsync(self._f.fileno())
        self.last_fsync_seconds = time.perf_counter() - tf
        covered, self._pending, self._pending_bytes = self._pending, 0, 0
        self.fsyncs += 1
        self.fsync_seconds_total += self.last_fsync_seconds
        self.appends_covered += covered
        if obs.enabled():
            obs.observe("repro_serving_wal_fsync_seconds",
                        self.last_fsync_seconds)
            obs.counter("repro_wal_group_fsyncs_total")
            obs.observe("repro_wal_group_appends_per_fsync", covered)
        return covered

    def sync_if_due(self) -> int:
        """Barrier the open group iff its oldest append has aged past
        ``group_commit_ms`` — the engine's flush loop calls this every
        iteration so a write trickle is never left pending for longer
        than the knob promises."""
        if (self._pending and self.group_commit_ms is not None
                and (time.perf_counter() - self._pending_since) * 1e3
                >= self.group_commit_ms):
            return self.sync()
        return 0

    def append_edges(self, version: int, u, v, w) -> None:
        """w must already be sign-folded (deletions negative)."""
        self._append(WalRecord(EDGES, version, u, v, w))

    def append_labels(self, version: int, nodes, labels) -> None:
        self._append(WalRecord(LABELS, version, nodes, labels))

    def append_marker(self, kind: int, version: int) -> None:
        if kind not in _MARKERS:
            raise ValueError(f"WAL record kind {kind} is not a marker")
        self._append(WalRecord(kind, version))

    def append_index(self, version: int, centroids) -> None:
        """Log an IVF (re-)quantization's centroids so recovery can
        rebuild the same index deterministically."""
        self._append(WalRecord(INDEX, version, centroids))


def read_wal(path: str) -> Iterator[WalRecord]:
    """Read-only replay of a WAL file (torn tail treated as EOF)."""
    records, good = _scan_valid(path)
    if good < 0:
        raise ValueError(f"{path} is not a WAL file")
    return iter(records)
