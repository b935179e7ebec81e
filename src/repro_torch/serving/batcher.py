"""Microbatching request queue for the serving engine.

The port's own copy of `repro.serving.batcher`.  One change: a read
window's node batch goes to the target as it is, not padded to a
power-of-two bucket (the reference pads only so that its jitted
kernels compile once per bucket; nothing here compiles per shape).

Concurrent read requests of the same kind are coalesced into one
kernel launch (node arrays concatenated, one gather / predict / top-k
call, results split back per ticket).  Writes are barriers: a write
request flushes all reads queued before it, then runs alone against
the store's version counter, so every read observes a single
well-defined (version, epoch) and writes apply in submission order.

The batcher is transport only — it talks to any **target** exposing
the small serving protocol (`n`, `version`, `epoch`,
`apply_edge_delta`, `apply_label_delta`, `query_embed`,
`query_predict`, `query_topk`): the sharded `ServingEngine` and the
1-shard `EmbeddingService` shim both do.  Kernel dispatch lives on the
target, so the sharded scatter/gather path and the single-host path
are interchangeable behind the same queue.

Each ticket records the (version, epoch) it executed against plus wall
latency; `stats()` aggregates per-kind counts, batch sizes, end-to-end
latency, and execution throughput — the observability surface
`server.py` prints.

A bad request (out-of-range node ids, malformed batch) fails only its
own ticket(s): the exception is captured on the ticket and re-raised
from `ticket.result()`; the rest of the queue is still served, so a
producer can never be left hanging on a poisoned flush.

Thread-safe: `submit` may be called from many threads; `flush` drains
the queue under a lock (single consumer — `ServingEngine.start()` runs
it in a background thread so submitters never block on kernel
launches).  Tickets carry an Event so producers can block on
`ticket.result()`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch import obs

READ_KINDS = ("embed", "predict", "topk")
WRITE_KINDS = ("insert", "delete", "labels")


@dataclass
class Ticket:
    kind: str
    payload: Any
    submitted: float
    done: threading.Event = field(default_factory=threading.Event)
    value: Any = None
    error: Optional[BaseException] = None
    version: int = -1
    epoch: int = -1
    latency: float = 0.0

    def result(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError(f"{self.kind} ticket not served")
        if self.error is not None:
            raise self.error
        return self.value


class _KindStats:
    __slots__ = ("requests", "batches", "items", "wall", "exec_wall",
                 "errors")

    def __init__(self):
        self.requests = 0
        self.batches = 0
        self.items = 0
        self.wall = 0.0          # sum of per-ticket end-to-end latencies
        self.exec_wall = 0.0     # kernel/apply execution time per batch
        self.errors = 0


class MicroBatcher:
    """Coalesces reads, serializes writes, keeps per-kind stats."""

    def __init__(self, target, *, topk: int = 10,
                 topk_block_rows: int = 1 << 14,
                 topk_mode: str = "exact",
                 topk_nprobe: Optional[int] = None):
        self.target = target
        self.topk = int(topk)
        self.topk_block_rows = int(topk_block_rows)
        #: "ivf" routes coalesced top-k batches through the target's
        #: IVF index (`repro.index`); targets without mode support
        #: (the 1-shard EmbeddingService shim) only accept "exact"
        self.topk_mode = str(topk_mode)
        self.topk_nprobe = topk_nprobe
        self._lock = threading.Lock()
        self._queue: list[Ticket] = []   # guarded by: _lock
        # guarded by: _lock
        self._stats = {k: _KindStats()
                       for k in READ_KINDS + WRITE_KINDS}

    @property
    def service(self):
        """Back-compat alias for the serving target."""
        return self.target

    # -- producer side -----------------------------------------------------

    def submit(self, kind: str, payload: Any) -> Ticket:
        """Enqueue a request.  Reads: payload = node array.  Writes:
        insert/delete -> (u, v, w); labels -> (nodes, labels)."""
        # repro: allow(lock-discipline) — membership test on a key set fixed at construction; only the values behind it mutate
        if kind not in self._stats:
            raise ValueError(f"unknown request kind {kind!r}")
        t = Ticket(kind, payload, time.perf_counter())
        with self._lock:
            self._queue.append(t)
            self._stats[kind].requests += 1
        obs.counter("repro_serving_batcher_requests_total", kind=kind)
        return t

    # -- consumer side -----------------------------------------------------

    def flush(self) -> int:
        """Drain the queue: coalesced read batches between write barriers.
        Returns the number of tickets served.

        Group-commit interplay: when the target's WAL batches fsync
        barriers (``group_commit_*``), successful writes are APPLIED in
        order as usual but their tickets are held back and released
        only after one ``target.sync_durable()`` covering the whole
        drain — a submitter learns its version strictly after the fsync
        that made the write power-loss durable.  Reads still coalesce
        between the write barriers and are never held (they see applied
        state, same as before)."""
        with self._lock:
            batch, self._queue = self._queue, []
        served = 0
        reads: list[Ticket] = []
        deferred: list[tuple[Ticket, int, int]] = []
        defer = self._defer_writes()
        for t in batch:
            if t.kind in WRITE_KINDS:
                served += self._run_reads(reads)
                reads = []
                served += self._run_write(
                    t, deferred if defer else None)
            else:
                reads.append(t)
        served += self._run_reads(reads)
        if deferred:
            try:
                self.target.sync_durable()
            except Exception as e:       # barrier failed: the writes
                for t, _, _ in deferred:     # are NOT durable — error
                    self._finish(t, None, e)     # the tickets
            else:
                for t, version, epoch in deferred:
                    self._finish(t, version, version=version,
                                 epoch=epoch)
        return served

    def _defer_writes(self) -> bool:
        """Hold write tickets for a covering fsync barrier?  Only when
        the target's WAL actually batches barriers — otherwise ticket
        latency semantics are unchanged."""
        wal = getattr(self.target, "wal", None)
        return (wal is not None and getattr(wal, "group_commit", False)
                and callable(getattr(self.target, "sync_durable",
                                     None)))

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- execution ---------------------------------------------------------

    def _finish(self, t: Ticket, value: Any,
                error: Optional[BaseException] = None,
                version: Optional[int] = None,
                epoch: Optional[int] = None) -> None:
        t.value = value
        t.error = error
        # deferred write tickets pass the (version, epoch) captured at
        # APPLY time — by release time later writes may have advanced
        # the live counters past this ticket's write
        t.version = self.target.version if version is None else version
        t.epoch = self.target.epoch if epoch is None else epoch
        t.latency = time.perf_counter() - t.submitted
        with self._lock:          # stats() reads under the same lock
            st = self._stats[t.kind]
            st.wall += t.latency
            if error is not None:
                st.errors += 1
        # EVERY ticket — reads AND write barriers — lands in the same
        # per-kind latency histogram, so the distribution's count equals
        # the submit count (tested; write barriers used to be invisible
        # in latency summaries)
        if obs.enabled():
            obs.observe("repro_serving_batcher_ticket_seconds",
                        t.latency, kind=t.kind)
            if error is not None:
                obs.counter("repro_serving_batcher_errors_total",
                            kind=t.kind)
        t.done.set()

    def _count_batch(self, kind: str, items: int, exec_s: float) -> None:
        with self._lock:
            st = self._stats[kind]
            st.batches += 1
            st.items += items
            st.exec_wall += exec_s
        if obs.enabled():
            obs.counter("repro_serving_batcher_batches_total", kind=kind)
            if items:
                obs.counter("repro_serving_batcher_items_total", items,
                            kind=kind)
                obs.observe("repro_serving_batcher_batch_items", items,
                            kind=kind)
            obs.observe("repro_serving_batcher_exec_seconds", exec_s,
                        kind=kind)

    def _run_write(self, t: Ticket,
                   deferred: Optional[list] = None) -> int:
        t0 = time.perf_counter()
        try:
            if t.kind == "labels":
                nodes, labels = t.payload
                version = self.target.apply_label_delta(nodes, labels)
                items = len(np.atleast_1d(nodes))
            else:
                u, v, w = t.payload
                version = self.target.apply_edge_delta(
                    u, v, w, delete=(t.kind == "delete"))
                items = len(np.atleast_1d(u))
        except Exception as e:        # bad batch: fail the ticket, not
            self._count_batch(t.kind, 0, 0.0)
            self._finish(t, None, e)  # the queue behind it
        else:
            self._count_batch(t.kind, items, time.perf_counter() - t0)
            if deferred is not None:  # released after the fsync barrier
                deferred.append((t, version, self.target.epoch))
            else:
                self._finish(t, version)
        return 1

    def _run_reads(self, tickets: list[Ticket]) -> int:
        """One kernel launch per kind present in this read window."""
        by_kind: dict[str, list[Ticket]] = {}
        for t in tickets:
            by_kind.setdefault(t.kind, []).append(t)
        n = self.target.n
        for kind, group in by_kind.items():
            served, nodes, sizes = [], [], []
            for t in group:
                try:
                    x = np.atleast_1d(np.asarray(t.payload, np.int32))
                    # reject out-of-range ids here, per ticket, so that
                    # one bad request fails alone
                    if x.size and (x.min() < 0 or x.max() >= n):
                        raise IndexError(
                            f"{kind} node ids outside [0, {n})")
                except Exception as e:     # fail this ticket only
                    self._finish(t, None, e)
                    continue
                served.append(t)
                nodes.append(x)
                sizes.append(x.shape[0])
            if not served:
                continue
            t0 = time.perf_counter()
            try:
                cat = np.concatenate(nodes)
                parts = self._run_read_kernel(kind, cat, sizes)
            except Exception as e:
                self._count_batch(kind, 0, 0.0)
                for t in served:
                    self._finish(t, None, e)
            else:
                self._count_batch(kind, cat.shape[0],
                                  time.perf_counter() - t0)
                for t, part in zip(served, parts):
                    self._finish(t, part)
        return len(tickets)

    def _run_read_kernel(self, kind: str, cat: np.ndarray,
                         sizes: list[int]) -> list:
        if kind == "embed":
            out = self.target.query_embed(cat)
            return self._split(np.asarray(out), sizes)
        if kind == "predict":
            pred, score = self.target.query_predict(cat)
            return list(zip(self._split(np.asarray(pred), sizes),
                            self._split(np.asarray(score), sizes)))
        kwargs = {}
        if self.topk_mode != "exact":     # only pass when asked: keeps
            kwargs["mode"] = self.topk_mode   # mode-less targets working
            kwargs["nprobe"] = self.topk_nprobe
        idx, val = self.target.query_topk(
            cat, k=self.topk, block_rows=self.topk_block_rows, **kwargs)
        return list(zip(self._split(idx, sizes),
                        self._split(val, sizes)))

    @staticmethod
    def _split(arr: np.ndarray, sizes: list[int]) -> list[np.ndarray]:
        out, off = [], 0
        for s in sizes:
            out.append(arr[off:off + s])
            off += s
        return out

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            rows = {}
            for kind, st in self._stats.items():
                if not st.requests:
                    continue
                rows[kind] = {
                    "requests": st.requests, "batches": st.batches,
                    "items": st.items, "errors": st.errors,
                    "mean_batch": st.items / max(st.batches, 1),
                    # end-to-end (incl. queue wait), per request
                    "mean_latency_ms": 1e3 * st.wall / max(st.requests, 1),
                    # kernel/apply throughput: items over *execution*
                    # time, counted once per coalesced batch
                    "items_per_s": (st.items / st.exec_wall
                                    if st.exec_wall else 0.0),
                }
            return rows
