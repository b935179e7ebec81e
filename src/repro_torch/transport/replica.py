"""WAL-tail read replica: a volatile engine kept fresh by the owner's log.

The port of `repro.transport.replica`, on one explicit `device` (the
inner engine's; "cuda" by default, where its shards run the cuda
backend's kernels when asked to).  The tail thread runs under that
device, as the engine's flush loop does.

One-Hot GEE is linear in the edge multiset, so a replica never needs
the owner's device state — the WAL *is* the state.  `ReplicaEngine`
bootstraps exactly like crash recovery (load the manifest's snapshot
generation, replay the WAL suffix, build Z once) and then keeps
replaying: a poll loop tails the owner's live WAL file read-only
(`serving.wal.tail_records`) and feeds each fresh record through the
same write path the owner ran, so the replica's
`(version, epoch, fingerprint)` trajectory is the owner's, record for
record.  The inner engine is a real volatile `ServingEngine` with the
owner's `num_shards` — answers are therefore **bit-identical** to the
owner's (all top-k surfaces are tie-stable and owned-rows plans are
shard-count invariant), which is what lets the router fan reads across
replicas without weakening its `np.array_equal` contract.

Freshness model — reads are **version-pinned**: every read carries the
router's current version; a replica that has not applied that version
yet raises `ReplicaLagError` instead of serving stale rows, and the
router falls back to the owner (and surfaces the lag through
`engine.health()`).  Checkpoints rotate the owner's WAL; the tail loop
watches the MANIFEST generation and re-bootstraps from the new
snapshot when it flips.  An ``mode="ivf"`` read on a replica that has
not yet seen the owner's INDEX record is also a lag (the replica must
never invent its own quantizer — divergent centroids would break
bit-equality), routed the same way.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serving import wal as W
from repro_torch.serving.store import GraphStore
from repro_torch.transport.errors import ReplicaLagError

_MANIFEST = "MANIFEST"


class ReplicaEngine:
    """Read-only replica of a durable deployment at `data_dir`."""

    def __init__(self, data_dir: str, *, poll_s: float = 0.02,
                 backend: str = "streaming", plan_cache="auto",
                 chunk_size: int = 1 << 20,
                 start_tail: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.data_dir = str(data_dir)
        self._device_arg = device
        self.poll_s = float(poll_s)
        self.backend = backend
        self.plan_cache = plan_cache
        self.chunk_size = int(chunk_size)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.records_applied = 0         # guarded by: _lock
        self.reloads = 0                 # guarded by: _lock
        #: last exception the tail loop swallowed (kept serving — a
        #: replica with a sick tail is stale, not dead; version pinning
        #: turns staleness into clean owner fallbacks)
        self.tail_error: Optional[BaseException] = None  # guarded by: _lock
        #: the wrapped volatile engine + tail cursor, all rewritten
        #: together on a generation flip (_load)
        self.engine = None               # guarded by: _lock
        self.generation = -1             # guarded by: _lock
        self._offset = 0                 # guarded by: _lock
        self._wal_path = ""              # guarded by: _lock
        self._load()
        #: the inner engine's device, index pinned (reloads keep it)
        self.device: torch.device = self.engine.device
        if start_tail:
            self._thread = threading.Thread(
                target=self._tail_loop, name="replica-tail", daemon=True)
            self._thread.start()

    # -- bootstrap (the crash-recovery path, minus the WAL append handle) --

    def _load(self) -> None:
        """(Re)bootstrap from the current manifest generation: snapshot
        + full WAL replay + one Z build.  Mirrors `ServingEngine.open`
        except the WAL is read with `scan_wal` — never opened for
        append, never truncated: the file belongs to the owner."""
        from repro_torch.serving.engine import ServingEngine
        with self._lock:
            with open(os.path.join(self.data_dir, _MANIFEST)) as f:
                gen = int(json.load(f)["generation"])
            prefix = os.path.join(self.data_dir, f"snap-{gen}")
            store = GraphStore.load(prefix)
            with open(prefix + ".engine.json") as f:
                emeta = json.load(f)
            eng = ServingEngine(
                store, num_shards=int(emeta["num_shards"]),
                rebuild_churn=float(emeta["rebuild_churn"]),
                chunk_size=self.chunk_size, backend=self.backend,
                plan_cache=self.plan_cache, device=self._device_arg,
                _boot=False)
            eng.epoch = int(emeta["epoch"])
            eng.rebuilds = int(emeta["rebuilds"])
            eng.deltas_applied = int(emeta["deltas_applied"])
            eng.Y_epoch = store.Y.copy()
            eng._reset_shard_fps()
            imeta = emeta.get("index")
            if imeta is not None:
                eng.index_mode = imeta["mode"]
                eng.index_churn = float(imeta["churn"])
                eng.nprobe = (int(imeta["nprobe"])
                              if imeta["nprobe"] is not None else None)
                eng._index_centroids = np.asarray(
                    imeta["centroids"], np.float32).reshape(
                        store.K, store.K)
            self._wal_path = os.path.join(self.data_dir, f"wal-{gen}.log")
            records, offset = W.scan_wal(self._wal_path)
            for rec in records:
                eng._replay(rec)
            eng.version = store.version
            eng._embed_epoch()           # Z built once, post-replay
            if eng.index_mode is not None:
                eng._build_index(eng._index_centroids, record=False)
            self.engine = eng
            self.generation = gen
            self._offset = offset
            self.records_applied += len(records)
            self.reloads += 1
            if obs.enabled():
                obs.counter("repro_transport_replica_reloads_total")

    # -- WAL tail ----------------------------------------------------------

    def _tail_loop(self) -> None:
        dev = self.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            while not self._stop.wait(self.poll_s):
                try:
                    self.poll()
                except Exception as e:   # keep tailing; reads stay pinned
                    with self._lock:
                        self.tail_error = e
                    if obs.enabled():
                        obs.counter(
                            "repro_transport_replica_tail_errors_total")

    def poll(self) -> int:
        """One tail step: re-bootstrap if the manifest generation
        flipped (owner checkpoint rotated the WAL), otherwise apply any
        fresh records through the live write path.  Returns records
        applied; also callable directly for deterministic tests."""
        with open(os.path.join(self.data_dir, _MANIFEST)) as f:
            gen = int(json.load(f)["generation"])
        with self._lock:                 # RLock: _load re-enters fine
            if gen != self.generation:
                self._load()
                return 0
            records, offset = W.tail_records(self._wal_path,
                                             self._offset)
            for rec in records:
                self._apply_live(rec)
            self._offset = offset
            self.records_applied += len(records)
        if records and obs.enabled():
            obs.counter("repro_transport_replica_applied_total",
                        len(records))
        return len(records)

    # holds: _lock — poll() wraps the apply batch
    def _apply_live(self, rec: W.WalRecord) -> None:
        """Feed one tailed record through the SAME public write path the
        owner ran — versions, epochs, fingerprints, and churn-gated
        rebuilds advance at identical points.  (The inner engine is
        volatile: its `wal` is None, so nothing is re-logged.)"""
        eng = self.engine
        if rec.kind == W.EDGES:          # weights arrive sign-folded
            # copies: the log's arrays are read-only views of its bytes
            eng.apply_edge_delta(np.array(rec.a), np.array(rec.b),
                                 np.array(rec.c))
        elif rec.kind == W.LABELS:
            eng.apply_label_delta(rec.a, rec.b)
        elif rec.kind == W.COMPACT:
            eng.compact()
        elif rec.kind == W.REBUILD:
            eng.refresh()
        elif rec.kind == W.INDEX:
            cent = np.asarray(rec.a, np.float32).reshape(
                eng.store.K, eng.store.K).copy()
            with eng._mu:
                eng.index_mode = "ivf"
                eng._build_index(cent, record=False)

    # -- version-pinned reads ---------------------------------------------

    # holds: _lock — every read entry point locks before pinning
    def _pin(self, min_version: int) -> None:
        if self.engine.version < min_version:
            if obs.enabled():
                obs.counter("repro_transport_replica_lag_rejects_total")
            raise ReplicaLagError(
                f"replica at version {self.engine.version} < pinned "
                f"{min_version}", have=self.engine.version,
                want=min_version)

    def embed(self, nodes, min_version: int = 0) -> np.ndarray:
        with self._lock:
            self._pin(min_version)
            return np.asarray(self.engine.query_embed(nodes))

    def predict(self, nodes, min_version: int = 0):
        with self._lock:
            self._pin(min_version)
            pred, score = self.engine.query_predict(nodes)
            return np.asarray(pred), np.asarray(score)

    def topk(self, nodes, *, k: int = 10, block_rows: int = 1 << 14,
             mode: str = "exact", nprobe: Optional[int] = None,
             min_version: int = 0):
        with self._lock:
            self._pin(min_version)
            if mode == "ivf" and self.engine.index_mode is None:
                # the owner's INDEX record hasn't reached us: serving
                # would mean inventing a quantizer and breaking
                # bit-equality — treat as lag, owner takes the read
                raise ReplicaLagError("replica has no quantizer yet "
                                      "(INDEX record not applied)")
            idx, val = self.engine.query_topk(
                nodes, k=k, block_rows=block_rows, mode=mode,
                nprobe=nprobe)
            return np.asarray(idx), np.asarray(val)

    def status(self) -> dict:
        with self._lock:
            return {"version": self.engine.version,
                    "epoch": self.engine.epoch,
                    "fingerprint": self.engine.fingerprint(),
                    "generation": self.generation,
                    "records_applied": self.records_applied,
                    "reloads": self.reloads,
                    "tail_error": (repr(self.tail_error)
                                   if self.tail_error else None)}

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:                 # tail thread is gone; reads
            self.engine.close()          # racing close get a clean cut
