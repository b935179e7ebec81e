"""ServingEngine: the sharded, durable, asynchronous front door for
online GEE, in PyTorch.

The port of `repro.serving.engine.ServingEngine`.  A deployment of

* a **shard router**: Z rows are partitioned across N `EmbeddingShard`
  workers by `graph.partition.RowPartition`; edge deltas fan out only
  to the shards owning their endpoint rows, and queries scatter and
  gather (row gathers go to owners; top-k scores every shard's owned
  slice with global-id-stamped candidates and merges the lists,
  `queries.merge_topk`).  A sub-range shard holds only its (n/p, K)
  rows (`EncoderConfig.row_partition`);
* a **durable write-ahead delta log** (`serving.wal`): every accepted
  mutation is appended BEFORE it is applied, so a crashed engine
  recovers by replaying the log onto the last snapshot to the exact
  `(version, epoch, fingerprint)`;
* an **asynchronous flush and checkpoint loop**: `start()` runs a
  background consumer that drains a `MicroBatcher` and rolls a
  checkpoint (snapshot + log rotation) when the log outgrows
  `checkpoint_bytes`;
* an optional **IVF index** (`repro_torch.index`): every shard keeps
  inverted lists of its rows by nearest class centroid, delta-maintained
  under centroids the engine fixes and re-quantizes past `index_churn`;
  ``query_topk(mode="ivf", nprobe=...)`` scores only the probed cells
  and, at ``nprobe = K``, answers as the exact scan bit for bit.

The data directory is the reference's, file for file (`MANIFEST`,
`snap-{gen}.edges.npz`, `.meta.npz`, `.engine.json`, `wal-{gen}.log`,
format 1, the WAL's INDEX records and the index in ``.engine.json``
included), so a directory written by either package opens in the other.
The engine lives on one explicit `device` ("cuda" by default); with
``backend="cuda"`` its shards build through `gee_scatter`, fold deltas
through `gee_delta_renorm` and answer top-k through `topk_fused`.  Each
shard's plan goes through the persistent plan cache (`plan_cache`,
"auto" by default as in the reference).  Not ported yet, and refused
with NotImplementedError: the socket transport and read replicas
(``transport="socket"``, ``shard_addrs``, ``replicas``,
``replica_addrs``; ROADMAP queue A.7).

Threads: the flush loop launches kernels from its own thread.  It runs
under the engine's device and the stream that was current on that
device when `start()` was called, so its work is ordered with the
caller's, and a read issued after a write sees it.

`EmbeddingService` (service.py) is the 1-shard volatile special case.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.encoder.plan_cache import PlanDiskCache
from repro_torch.graph.edges import (Graph, edge_fingerprint,
                                     extend_fingerprint)
from repro_torch.graph.partition import RowPartition
from repro_torch.graph.sources import StoreSource
from repro_torch.kernels.query_fused import row_scores
from repro_torch.obs.health import DEGRADED, SERVING, STARTING, HealthTracker
from repro_torch.serving import queries as Q
from repro_torch.serving import wal as W
from repro_torch.serving.shard import EmbeddingShard
from repro_torch.serving.store import GraphStore, check_labels
from repro_torch.serving.wal import WriteAheadLog

_MANIFEST = "MANIFEST"
_FORMAT = 1

_NO_TRANSPORT = ("the socket transport and read replicas (transport/) "
                 "are not ported yet (ROADMAP queue A.7)")


def _atomic_write_json(path: str, obj: dict) -> None:
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _engine_device(device) -> torch.device:
    """The engine's device, with its index pinned: the flush loop's
    thread must name the same card as the caller's."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ServingEngine:
    """Partitioned, durable, asynchronous serving deployment of a live
    GEE.

    Construct fresh over a `GraphStore` (pass ``data_dir`` to make it
    durable: the engine snapshots generation 0 and opens a WAL), or
    recover an existing deployment with :meth:`open`.  The signature is
    the reference's: `rpc_timeout_s` belongs to the unported transport
    and is not used.
    """

    def __init__(self, store: GraphStore, *, data_dir: Optional[str] = None,
                 num_shards: int = 1, rebuild_churn: float = 0.05,
                 chunk_size: int = 1 << 20, backend: str = "streaming",
                 plan_cache: Union[str, PlanDiskCache, None] = "auto",
                 fsync: bool = False, degraded_append_s: float = 0.5,
                 index: Optional[str] = None, index_churn: float = 0.25,
                 nprobe: Optional[int] = None,
                 transport: str = "local",
                 shard_addrs: Optional[list] = None,
                 replicas: int = 0,
                 replica_addrs: Optional[list] = None,
                 rpc_timeout_s: float = 60.0,
                 group_commit_ms: Optional[float] = None,
                 group_commit_bytes: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 _boot: bool = True):
        if index not in (None, "ivf"):
            raise ValueError(f"unknown index mode {index!r} "
                             "(None or 'ivf')")
        if transport not in ("local", "socket"):
            raise ValueError(f"unknown transport {transport!r} "
                             "('local' or 'socket')")
        if (transport != "local" or shard_addrs or replicas
                or replica_addrs):
            raise NotImplementedError(_NO_TRANSPORT)
        self.device = _engine_device(device)
        self.store = store
        self.source = StoreSource(store)
        self.rebuild_churn = float(rebuild_churn)
        self.fsync = bool(fsync)
        #: WAL group-commit knobs (fsync batching, see serving.wal),
        #: kept so that checkpoint rotation re-creates the log alike
        self.group_commit_ms = group_commit_ms
        self.group_commit_bytes = group_commit_bytes
        #: a WAL append slower than this marks the deployment degraded
        self.degraded_append_s = float(degraded_append_s)
        self._health = HealthTracker("serving")
        self.partition = RowPartition(store.n, num_shards)
        # n=store.n makes every proper sub-range shard an owned-rows
        # Embedder: its accumulator is (n/p, K), not (n, K)
        self.shards = [
            EmbeddingShard(i, *self.partition.slice(i), K=store.K,
                           n=store.n, chunk_size=chunk_size,
                           backend=backend, plan_cache=plan_cache,
                           device=self.device)
            for i in range(num_shards)]
        self.epoch = 0
        self.rebuilds = 0
        self.deltas_applied = 0
        self.checkpoints = 0
        self.version = store.version     # guarded by: _mu
        self.Y_epoch = store.Y.copy()
        self.data_dir: Optional[str] = None
        self.generation: Optional[int] = None
        self.wal: Optional[WriteAheadLog] = None
        self._shard_fps: list = []       # guarded by: _mu
        self._routed_for_build = None    # guarded by: _mu
        self._centroids = None           # guarded by: _mu
        #: IVF index state: the engine owns the shared quantizer
        #: centroids (fixed between builds, which is what makes delta
        #: maintenance equal a rebuild) and the churn-gated
        #: re-quantization, mirroring `rebuild_churn`
        self.index_mode: Optional[str] = None        # guarded by: _mu
        self.index_churn = float(index_churn)
        self.nprobe = int(nprobe) if nprobe is not None else None
        # guarded by: _mu
        self._index_centroids: Optional[np.ndarray] = None
        # row-normalized quantizer on the device — guarded by: _mu
        self._index_cn: Optional[torch.Tensor] = None
        self._index_moved = 0   # rows that changed cell; guarded by: _mu
        self.requantizes = 0
        self._mu = threading.RLock()
        self._loop_thread: Optional[threading.Thread] = None
        self._loop_stop: Optional[threading.Event] = None
        #: last engine-level exception swallowed by the flush loop
        self.loop_error: Optional[BaseException] = None  # guarded by: _mu
        if not _boot:
            return                      # open() finishes construction
        if data_dir is None:
            self._reset_shard_fps()
            self._rebuild()
            if index is not None:
                self.enable_index()
        else:
            self.data_dir = str(data_dir)
            os.makedirs(self.data_dir, exist_ok=True)
            if os.path.exists(os.path.join(self.data_dir, _MANIFEST)):
                raise FileExistsError(
                    f"{self.data_dir} already holds a deployment; "
                    "recover it with ServingEngine.open()")
            # fold the log so generation 0's snapshot IS the live state
            self.store.compact()
            self._reset_shard_fps()
            self._rebuild()
            if index is not None:
                self.enable_index()      # generation 0 carries it
            self._write_generation(0)
        self._health.to(SERVING)        # boot complete: starting -> serving

    # -- recovery ----------------------------------------------------------

    @classmethod
    def open(cls, data_dir: str, *, num_shards: Optional[int] = None,
             rebuild_churn: Optional[float] = None,
             chunk_size: int = 1 << 20, backend: str = "streaming",
             plan_cache: Union[str, PlanDiskCache, None] = "auto",
             fsync: bool = False,
             degraded_append_s: float = 0.5,
             transport: str = "local",
             shard_addrs: Optional[list] = None,
             replicas: int = 0,
             replica_addrs: Optional[list] = None,
             rpc_timeout_s: float = 60.0,
             group_commit_ms: Optional[float] = None,
             group_commit_bytes: Optional[int] = None,
             device: Union[str, torch.device] = "cuda"
             ) -> "ServingEngine":
        """Recover a deployment: load the manifest's snapshot, replay the
        WAL suffix (append-before-apply puts every applied mutation
        there), and rebuild Z once at the end.  The recovered `(version,
        epoch, fingerprint)` and the epoch's labels match the crashed
        process exactly.  One ``serving.recovery`` span, mirrored into
        ``repro_serving_recovery_seconds``."""
        data_dir = str(data_dir)
        t0 = time.perf_counter()
        with obs.span("serving.recovery", data_dir=data_dir) as sp:
            with open(os.path.join(data_dir, _MANIFEST)) as f:
                gen = int(json.load(f)["generation"])
            prefix = os.path.join(data_dir, f"snap-{gen}")
            with open(prefix + ".engine.json") as f:
                emeta = json.load(f)
            store = GraphStore.load(prefix)
            eng = cls(store,
                      num_shards=(num_shards if num_shards is not None
                                  else int(emeta["num_shards"])),
                      rebuild_churn=(rebuild_churn
                                     if rebuild_churn is not None
                                     else float(emeta["rebuild_churn"])),
                      chunk_size=chunk_size, backend=backend,
                      plan_cache=plan_cache, fsync=fsync,
                      degraded_append_s=degraded_append_s,
                      transport=transport, shard_addrs=shard_addrs,
                      replicas=replicas, replica_addrs=replica_addrs,
                      rpc_timeout_s=rpc_timeout_s,
                      group_commit_ms=group_commit_ms,
                      group_commit_bytes=group_commit_bytes,
                      device=device, _boot=False)
            eng.data_dir = data_dir
            eng.generation = gen
            eng.epoch = int(emeta["epoch"])
            eng.rebuilds = int(emeta["rebuilds"])
            eng.deltas_applied = int(emeta["deltas_applied"])
            eng.checkpoints = int(emeta.get("checkpoints", 0))
            eng.Y_epoch = store.Y.copy()  # a snapshot always post-rebuild
            eng._reset_shard_fps()
            imeta = emeta.get("index")
            if imeta is not None:        # the snapshot carried an index
                eng.index_mode = imeta["mode"]
                eng.index_churn = float(imeta["churn"])
                eng.nprobe = (int(imeta["nprobe"])
                              if imeta["nprobe"] is not None else None)
                eng.requantizes = int(imeta.get("requantizes", 0))
                eng._index_centroids = np.asarray(
                    imeta["centroids"], np.float32).reshape(
                        store.K, store.K)
            eng.wal = WriteAheadLog(
                os.path.join(data_dir, f"wal-{gen}.log"), fsync=fsync,
                group_commit_ms=group_commit_ms,
                group_commit_bytes=group_commit_bytes)
            replayed = 0
            for rec in eng.wal.open():   # replay; Z built once, after
                eng._replay(rec)
                replayed += 1
            eng.version = store.version
            eng._embed_epoch()
            if eng.index_mode is not None:
                # memberships are a function of (Z, centroids): rebuilt
                # under the replayed quantizer they answer as the crashed
                # process did (the churn counter restarts at 0)
                eng._build_index(eng._index_centroids, record=False)
            sp.set(generation=gen, wal_records=replayed)
            sp.fence([s.Z_owned for s in eng.shards])
        if obs.enabled():
            obs.observe("repro_serving_recovery_seconds",
                        time.perf_counter() - t0)
            obs.counter("repro_serving_recovery_replayed_total",
                        replayed)
        eng._health.to(SERVING)          # recovery complete
        return eng

    # holds: _mu — recovery runs before the engine is shared
    def _replay(self, rec: W.WalRecord) -> None:
        """Re-apply one WAL record to the store and the epoch counters
        WITHOUT embedding (Z is built once after replay).  Mirrors the
        live write path, so epochs advance at the same points."""
        if rec.kind == W.EDGES:          # weights arrive sign-folded
            self.store.apply_edges(rec.a, rec.b, rec.c)
            self._routed_for_build = None    # multiset moved: stash stale
            if self.partition.p > 1:
                for i, (su, sv, sw) in self.partition.route_edges(
                        rec.a, rec.b, rec.c):
                    self._shard_fps[i] = extend_fingerprint(
                        self._shard_fps[i], su, sv, sw)
            self.deltas_applied += 1
        elif rec.kind == W.LABELS:
            self.store.apply_labels(rec.a, rec.b)
            if self.churn > self.rebuild_churn:
                self._advance_epoch()
        elif rec.kind == W.COMPACT:
            self.store.compact()
            self._reset_shard_fps()
            self._advance_epoch()
        elif rec.kind == W.REBUILD:
            self._advance_epoch()
        elif rec.kind == W.INDEX:
            # a live (re-)quantization: restore the exact quantizer; the
            # index itself is built once after the replay
            K = self.store.K
            self._index_centroids = np.asarray(
                rec.a, np.float32).reshape(K, K).copy()
            self.index_mode = "ivf"

    def _advance_epoch(self) -> None:
        """Epoch bookkeeping shared by live rebuilds and replay."""
        self.Y_epoch = self.store.Y.copy()
        self.epoch += 1
        self.rebuilds += 1

    # -- shard plumbing ----------------------------------------------------

    # holds: _mu — called from locked write paths and the boot path
    def _reset_shard_fps(self) -> None:
        """(Re)derive each shard's sub-multiset fingerprint from the live
        store whenever the base arrays are rewritten (boot, compaction,
        recovery); deltas then chain in O(batch), as the store's own.
        The routed dict is stashed for the `_embed_epoch` that every
        caller runs next, so the multiset is routed once."""
        if self.partition.p == 1:
            return                       # the store's own chain is used
        g = self.store.edges()
        routed = {i: sub for i, sub in self.partition.route_graph(g)}
        self._routed_for_build = routed
        self._shard_fps = [
            (routed[i].fingerprint() if i in routed
             else edge_fingerprint(g.n, np.zeros(0, np.int32),
                                   np.zeros(0, np.int32),
                                   np.zeros(0, np.float32)))
            for i in range(self.partition.p)]

    # holds: _mu
    def _embed_epoch(self) -> None:
        """Build every shard's Z from the live multiset under the
        current epoch labels (`Y_epoch`)."""
        with obs.span("serving.rebuild",
                      metric="repro_serving_rebuild_seconds",
                      epoch=self.epoch, shards=self.partition.p) as sp:
            if self.partition.p == 1:
                # the store source keeps array identity, so a quiet
                # store's rebuild reuses the shard's plan
                self.shards[0].build(self.source, self.Y_epoch)
            else:
                routed, self._routed_for_build = self._routed_for_build, None
                if routed is None:
                    routed = {i: sub for i, sub in
                              self.partition.route_graph(self.store.edges())}
                for i, shard in enumerate(self.shards):
                    sub = routed.get(i)
                    if sub is None:
                        sub = Graph(np.zeros(0, np.int32),
                                    np.zeros(0, np.int32),
                                    np.zeros(0, np.float32), self.n)
                    sub._fp = self._shard_fps[i]   # chained: never rehashed
                    shard.build(sub, self.Y_epoch)
            sp.fence([s.Z_owned for s in self.shards])
        self._invalidate_query_cache()

    # holds: _mu
    def _rebuild(self) -> None:
        """Full re-embed under the store's current labels; new epoch.  A
        rewritten Z invalidates every cell assignment, so an enabled
        index re-quantizes under fresh centroids."""
        self._advance_epoch()
        self._embed_epoch()
        self.version = self.store.version
        if self.index_mode is not None:
            self._requantize()

    # holds: _mu
    def _invalidate_query_cache(self) -> None:
        self._centroids = None

    # -- IVF index (repro_torch.index) ------------------------------------

    def enable_index(self) -> None:
        """Turn on IVF serving: quantize every shard's owned rows under
        the current global class centroids.  Idempotent."""
        with self._mu:
            if self.index_mode is None:
                self.index_mode = "ivf"
                self._build_index()

    # holds: _mu
    def _build_index(self, centroids=None, *, record: bool = True) -> None:
        """(Re)quantize all shards under `centroids` (default: the epoch's
        class centroids).  On a durable engine the quantizer goes to the
        WAL (record=False in recovery, where it came from the log or the
        snapshot).  One ``index.build`` span."""
        if centroids is None:
            centroids = self.centroids().cpu().numpy()
        centroids = np.array(centroids, np.float32)
        with obs.span("index.build", shards=self.partition.p,
                      epoch=self.epoch):
            for shard in self.shards:
                shard.build_index(centroids)
        self._index_centroids = centroids
        self._index_cn = Q.normalize_rows(
            torch.as_tensor(centroids, device=self.device))
        self._index_moved = 0
        if record and self.wal is not None:
            self.wal.append_index(self.store.version, centroids)

    # holds: _mu
    def _requantize(self) -> None:
        """Fresh centroids and a full re-assign: the churn-gated way out
        of accumulated delta drift, and forced after any epoch
        rebuild."""
        self._build_index()
        self.requantizes += 1
        obs.counter("repro_index_requantizes_total")

    # -- durability --------------------------------------------------------

    # holds: _mu — checkpoint() locks; the boot path is pre-publication
    def _write_generation(self, gen: int) -> None:
        """Write snapshot + engine meta + fresh WAL, then flip the
        manifest.  A crash anywhere before the manifest replace leaves
        the previous generation intact."""
        prefix = os.path.join(self.data_dir, f"snap-{gen}")
        self.store.snapshot(prefix)
        emeta = {
            "format": _FORMAT, "epoch": self.epoch,
            "rebuilds": self.rebuilds,
            "deltas_applied": self.deltas_applied,
            "checkpoints": self.checkpoints,
            "num_shards": self.partition.p,
            "rebuild_churn": self.rebuild_churn}
        if self.index_mode is not None:
            # the quantizer is the index's durable state: memberships
            # are a function of (Z, centroids), both replayable
            emeta["index"] = {
                "mode": self.index_mode, "churn": self.index_churn,
                "nprobe": self.nprobe,
                "requantizes": self.requantizes,
                "centroids": self._index_centroids.ravel().tolist()}
        _atomic_write_json(prefix + ".engine.json", emeta)
        if self.wal is not None:
            self.wal.close()
        old = self.generation
        self.wal = WriteAheadLog(
            os.path.join(self.data_dir, f"wal-{gen}.log"),
            fsync=self.fsync, group_commit_ms=self.group_commit_ms,
            group_commit_bytes=self.group_commit_bytes)
        self.wal.open()
        _atomic_write_json(os.path.join(self.data_dir, _MANIFEST),
                           {"format": _FORMAT, "generation": gen})
        self.generation = gen
        if old is not None and old != gen:       # best-effort cleanup
            for name in (f"snap-{old}.edges.npz", f"snap-{old}.meta.npz",
                         f"snap-{old}.engine.json", f"wal-{old}.log"):
                try:
                    os.unlink(os.path.join(self.data_dir, name))
                except OSError:
                    pass

    def sync_durable(self) -> int:
        """Close any open WAL commit group with one fsync barrier;
        returns the appends it covered.  The batcher calls this before
        releasing write tickets, so an acknowledged write is on stable
        storage."""
        if self.wal is not None:
            return self.wal.sync()
        return 0

    def checkpoint(self) -> dict:
        """Durable compaction: fold the log into the base, rebuild (new
        epoch), snapshot the result as a new generation, and rotate the
        WAL.  Bounds both recovery time and log size."""
        if self.data_dir is None:
            raise RuntimeError("checkpoint() needs a durable engine "
                               "(construct with data_dir=...)")
        with self._mu, obs.span(
                "serving.checkpoint",
                metric="repro_serving_checkpoint_seconds") as sp:
            info = self.store.compact()
            self._reset_shard_fps()
            self._rebuild()
            self.checkpoints += 1      # before the meta write, so a
            self._write_generation(self.generation + 1)   # recovered
            info["generation"] = self.generation   # engine restores it
            sp.set(generation=self.generation)
            obs.counter("repro_serving_checkpoints_total")
            return info

    def close(self) -> None:
        """Stop the flush loop (if running) and close the WAL."""
        self.stop()
        if self.wal is not None:
            self.wal.close()

    # -- writes ------------------------------------------------------------

    def apply_edge_delta(self, u, v, w, *, delete: bool = False) -> int:
        """Fold an edge batch into store + owning shards.  O(batch).
        Appended to the WAL before any state changes; a bad batch raises
        before either.  Returns the new version."""
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        w = np.asarray(w, np.float32)
        t0 = obs.tick()
        with self._mu:
            Graph(u, v, w, self.n).validate()    # reject BEFORE the WAL
            wsigned = -w if delete else w
            if self.wal is not None:
                self.wal.append_edges(self.store.version + 1, u, v, wsigned)
            version = self.store.apply_edges(u, v, w, delete=delete)
            self._routed_for_build = None
            fanout = 0
            if u.shape[0]:
                for i, (su, sv, sw) in self.partition.route_edges(
                        u, v, wsigned):
                    if self.partition.p > 1:
                        self._shard_fps[i] = extend_fingerprint(
                            self._shard_fps[i], su, sv, sw)
                    self.shards[i].apply_delta(Graph(su, sv, sw, self.n))
                    if self.index_mode is not None:
                        # re-assign exactly the owned rows this batch
                        # rewrote (O(batch))
                        lo, hi = self.partition.slice(i)
                        pts = np.concatenate([su, sv])
                        own = np.unique(pts[(pts >= lo) & (pts < hi)])
                        self._index_moved += \
                            self.shards[i].update_index(own)
                    fanout += 1
                self._invalidate_query_cache()
                if (self.index_mode is not None
                        and self._index_moved
                        > self.index_churn * self.n):
                    self._requantize()
            self.version = version
            self.deltas_applied += 1
            if obs.enabled():
                obs.observe("repro_serving_delta_apply_seconds",
                            obs.tock(t0))
                obs.observe("repro_serving_delta_fanout_shards", fanout)
                obs.counter("repro_serving_delta_edges_total",
                            int(u.shape[0]))
            return version

    def apply_label_delta(self, nodes, labels) -> int:
        """Update labels; rebuild every shard if churn passes the
        threshold, otherwise keep serving the current epoch's Z."""
        nodes = np.asarray(nodes, np.int64)
        labels = np.asarray(labels, np.int32)
        t0 = obs.tick()
        with self._mu:
            # reject BEFORE the WAL
            check_labels(nodes, labels, self.n, self.store.K)
            if self.wal is not None:
                self.wal.append_labels(self.store.version + 1, nodes,
                                       labels)
            version = self.store.apply_labels(nodes, labels)
            self.version = version
            if self.churn > self.rebuild_churn:
                self._rebuild()
            if obs.enabled():
                obs.observe("repro_serving_label_apply_seconds",
                            obs.tock(t0))
                obs.counter("repro_serving_label_updates_total",
                            int(nodes.size))
            return version

    def compact(self) -> dict:
        """Compact the store and start a fresh epoch (volatile
        compaction; `checkpoint()` is the durable one).  On a durable
        engine a marker record keeps the WAL replayable."""
        with self._mu:
            if self.wal is not None:
                self.wal.append_marker(W.COMPACT, self.store.version)
            info = self.store.compact()
            self._reset_shard_fps()
            self._rebuild()
            return info

    def refresh(self) -> None:
        """Force a rebuild (e.g. to pick up sub-threshold label churn)."""
        with self._mu:
            if self.wal is not None:
                self.wal.append_marker(W.REBUILD, self.store.version)
            self._rebuild()

    # -- reads (scatter/gather across shards) ------------------------------

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def num_shards(self) -> int:
        return self.partition.p

    def fingerprint(self) -> str:
        return self.store.fingerprint()

    @property
    def churn(self) -> float:
        return self.store.churn_fraction(self.Y_epoch)

    @property
    def stale_labels(self) -> int:
        return int((self.store.Y != self.Y_epoch).sum())

    @property
    def Z(self) -> torch.Tensor:
        """The live embedding, assembled from the owned shard slices (for
        1 shard the Embedder's own Z, no copy)."""
        if self.partition.p == 1:
            return self.shards[0].embedder.Z_
        return torch.cat([s.Z_owned for s in self.shards], 0)

    @property
    def Wv(self) -> torch.Tensor:
        """Projection weights Z was built with (the same on every shard:
        all fit under the epoch labels)."""
        return self.shards[0].embedder.Wv_

    @property
    def embedder(self):
        """The single Embedder: only for 1 shard (the `EmbeddingService`
        surface)."""
        if self.partition.p != 1:
            raise AttributeError(
                "a sharded engine has per-shard embedders "
                "(engine.shards[i].embedder)")
        return self.shards[0].embedder

    def _check_nodes(self, nodes: np.ndarray) -> None:
        if nodes.size and (nodes.min() < 0 or nodes.max() >= self.n):
            raise IndexError(f"node ids must be in [0, {self.n}), got "
                             f"range [{nodes.min()}, {nodes.max()}]")

    # holds: _mu
    def _gather_rows(self, nodes: np.ndarray) -> torch.Tensor:
        """Z rows in request order, on the device: the gather half of
        every read.  1 shard gathers directly; sharded reads gather per
        owner and land in request order through one `index_put_`."""
        if self.partition.p == 1:
            return self.shards[0].rows(nodes)
        t0 = obs.tick()
        where, rows = [], []
        for shard, idx in self.partition.route_nodes(nodes):
            where.append(idx)
            rows.append(self.shards[shard].rows(nodes[idx]))
        out = torch.empty((nodes.shape[0], self.store.K),
                          dtype=torch.float32, device=self.device)
        if rows:
            out.index_put_((torch.as_tensor(np.concatenate(where),
                                            device=self.device),),
                           torch.cat(rows, 0))
        if obs.enabled():
            if out.is_cuda:              # the gather's device time too
                torch.cuda.synchronize(self.device)
            obs.observe("repro_serving_query_gather_seconds",
                        obs.tock(t0), shards=self.partition.p)
        return out

    def query_embed(self, nodes) -> np.ndarray:
        """Z rows for a node batch: scatter to owning shards, gather
        back in request order."""
        nodes = np.atleast_1d(np.asarray(nodes, np.int32))
        t0 = obs.tick()
        with self._mu:
            self._check_nodes(nodes)
            out = self._gather_rows(nodes).cpu().numpy()
        self._record_query("embed", t0, nodes.shape[0])
        return out

    def centroids(self) -> torch.Tensor:
        """Global class centroids: per-shard partial (sums, counts)
        reduced at the router, divided once.  Cached until the next
        write or rebuild."""
        with self._mu:
            if self._centroids is None:
                sums = counts = None
                for shard in self.shards:
                    s_, c_ = shard.class_stats(self.Y_epoch)
                    sums = s_ if sums is None else sums + s_
                    counts = c_ if counts is None else counts + c_
                self._centroids = sums / torch.clamp_min(counts[:, None],
                                                         1.0)
            return self._centroids

    def normalized_Z(self) -> torch.Tensor:
        """Row-normalized Z (shards cache their own normalized slices)."""
        with self._mu:
            if self.partition.p == 1:
                return self.shards[0].normalized()
            return torch.cat([s.normalized() for s in self.shards], 0)

    def query_predict(self, nodes):
        """Centroid label prediction: gather rows from owners, score
        against the merged centroids.  Returns (pred, score) as numpy."""
        nodes = np.atleast_1d(np.asarray(nodes, np.int32))
        t0 = obs.tick()
        with self._mu:
            self._check_nodes(nodes)
            pred, score = Q.predict_rows(self._gather_rows(nodes),
                                         self.centroids())
            out = pred.cpu().numpy(), score.cpu().numpy()
        self._record_query("predict", t0, nodes.shape[0])
        return out

    def query_topk(self, nodes, *, k: int = 10,
                   block_rows: int = 1 << 14, mode: str = "exact",
                   nprobe: Optional[int] = None):
        """Top-k cosine neighbours: gather and normalize the query rows,
        score them against candidate rows (global-id-stamped), merge the
        per-shard lists.  Ties order by (-score, ascending id), so the
        answer has the same bits for every shard count.

        ``mode="exact"`` scans every owned row; ``mode="ivf"`` scores
        only the `nprobe` cells nearest each query through the shards'
        IVF indexes (built on the first ivf query if the engine was made
        without ``index="ivf"``), and equals the exact answer bit for
        bit at ``nprobe = K``.  Returns (indices (q, k) int32, scores
        (q, k) float32)."""
        if mode not in ("exact", "ivf"):
            raise ValueError(f"unknown topk mode {mode!r} "
                             "('exact' or 'ivf')")
        nodes = np.atleast_1d(np.asarray(nodes, np.int32))
        t0 = obs.tick()
        with self._mu:
            self._check_nodes(nodes)
            if mode == "ivf" and self.index_mode is None:
                self.enable_index()
            if self.partition.p == 1:
                # gather from the cached normalized slice
                q = self.shards[0].normalized()[torch.as_tensor(
                    nodes, device=self.device).long()]
            else:
                q = Q.normalize_rows(self._gather_rows(nodes))
            ts = obs.tick()
            if mode == "ivf":
                probe = self._probe_cells(q, nprobe)
                parts = [s.index_topk(q, nodes, probe, k=k,
                                      block_rows=block_rows)
                         for s in self.shards]
                scanned = sum(p[2] for p in parts)
            else:
                parts = [s.topk_candidates(q, nodes, k=k,
                                           block_rows=block_rows)
                         for s in self.shards]
            if obs.enabled():
                obs.observe("repro_serving_query_scatter_seconds",
                            obs.tock(ts), shards=self.partition.p)
            if len(parts) == 1:
                out = parts[0][0], parts[0][1]
            else:
                out = Q.merge_topk([p[0] for p in parts],
                                   [p[1] for p in parts], k=k)
            if mode == "ivf" and obs.enabled():
                obs.observe("repro_index_topk_seconds", obs.tock(ts))
                obs.counter("repro_index_queries_total")
                obs.counter("repro_index_rows_scanned_total", scanned)
                obs.observe("repro_index_scan_fraction",
                            scanned / max(nodes.shape[0] * self.n, 1))
        self._record_query("topk" if mode == "exact" else "topk_ivf",
                           t0, nodes.shape[0])
        return out

    # holds: _mu — only called from the locked region of query_topk
    def _probe_cells(self, q: torch.Tensor,
                     nprobe: Optional[int]) -> np.ndarray:
        """The `nprobe` quantizer cells nearest each query (nq, nprobe)
        int32, shared by all shards.  Scores are the fixed-order
        `row_scores`; ties go to the lower cell (a stable sort).  nprobe
        defaults to the engine's, else `DEFAULT_NPROBE`, and is clamped
        to [1, K]."""
        from repro_torch.index import DEFAULT_NPROBE
        if nprobe is None:
            nprobe = self.nprobe
        if nprobe is None:
            nprobe = DEFAULT_NPROBE
        nprobe = max(1, min(int(nprobe), self.store.K))
        sims = row_scores(q, self._index_cn).cpu().numpy()
        return np.argsort(-sims, axis=1, kind="stable")[:, :nprobe] \
            .astype(np.int32)

    def _record_query(self, kind: str, t0: float, batch: int) -> None:
        """One histogram + counter pair per read, labelled by kind."""
        if not obs.enabled():
            return
        obs.observe("repro_serving_query_seconds", obs.tock(t0),
                    kind=kind)
        obs.counter("repro_serving_queries_total", kind=kind)
        obs.counter("repro_serving_query_nodes_total", batch, kind=kind)

    # -- asynchronous flush / compaction loop ------------------------------

    def start(self, batcher=None, *, interval: float = 1e-3,
              checkpoint_bytes: Optional[int] = None):
        """Run the deployment's consumer in a background thread: drain
        the batcher (coalesced reads between write barriers; writers get
        a ticket back at once) and roll a checkpoint whenever the WAL
        outgrows `checkpoint_bytes`.  The thread runs on the engine's
        device and on the stream current there now.  Returns the
        batcher to submit against."""
        if self._loop_thread is not None:
            raise RuntimeError("flush loop already running")
        if batcher is None:
            from repro_torch.serving.batcher import MicroBatcher
            batcher = MicroBatcher(self)
        self._loop_batcher = batcher
        self._loop_stop = threading.Event()
        self._checkpoint_bytes = checkpoint_bytes
        self._flush_interval = float(interval)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        self._loop_thread = threading.Thread(
            target=self._flush_loop, args=(stream,), name="serving-flush",
            daemon=True)
        self._loop_thread.start()
        return batcher

    def _flush_loop(self, stream) -> None:
        with (torch.cuda.device(self.device) if stream is not None
              else contextlib.nullcontext()), \
                (torch.cuda.stream(stream) if stream is not None
                 else contextlib.nullcontext()):
            self._drain_until_stopped()

    def _drain_until_stopped(self) -> None:
        """The background consumer must never die silently: per-ticket
        failures are captured by the batcher, so an exception here is
        engine-level (e.g. a checkpoint hitting a full disk).  It is
        recorded on `loop_error`, a failing auto-checkpoint is disabled
        rather than retried every iteration, and the loop keeps
        draining."""
        while not self._loop_stop.is_set():
            try:
                served = self._loop_batcher.flush()
                if self.wal is not None and self.wal.group_commit:
                    # a write trickle must not leave its commit group
                    # open past the group_commit_ms promise
                    self.wal.sync_if_due()
            except Exception as e:       # engine bug: record, keep going
                with self._mu:
                    self.loop_error = e
                served = 0
            if obs.enabled():
                obs.counter("repro_serving_flush_iterations_total")
                if served:
                    obs.counter("repro_serving_flush_served_total", served)
            if (self.wal is not None
                    and self._checkpoint_bytes is not None
                    and self.wal.bytes_written > self._checkpoint_bytes):
                try:
                    self.checkpoint()
                except Exception as e:
                    with self._mu:
                        self.loop_error = e
                    self._checkpoint_bytes = None
            if not served:
                self._loop_stop.wait(self._flush_interval)

    def stop(self) -> None:
        """Stop the flush loop and drain anything still queued."""
        if self._loop_thread is None:
            return
        self._loop_stop.set()
        self._loop_thread.join()
        self._loop_thread = None
        self._loop_batcher.flush()       # nothing left behind

    # -- observability -----------------------------------------------------

    def health(self) -> dict:
        """Deployment health, re-evaluated on every call: ``starting``
        until the boot or recovery rebuild lands, then ``serving``, and
        ``degraded`` while the flush loop has recorded an engine-level
        error or the last WAL append exceeded `degraded_append_s`."""
        with self._mu:
            reasons = []
            if self.loop_error is not None:
                reasons.append(f"loop_error: {self.loop_error!r}")
            if (self.wal is not None
                    and self.wal.last_append_seconds
                    > self.degraded_append_s):
                reasons.append(
                    "wal append "
                    f"{self.wal.last_append_seconds * 1e3:.1f}ms > "
                    f"{self.degraded_append_s * 1e3:.1f}ms")
            if reasons:
                self._health.to(DEGRADED, reason="; ".join(reasons))
            elif self._health.state != STARTING:
                self._health.to(SERVING)
            return self._health.as_dict()

    def stats(self) -> dict:
        """Introspection snapshot, read under the engine lock so that the
        `(version, epoch, fingerprint, durability)` group is never torn
        against a concurrent writer."""
        with self._mu:
            plan = {"built": 0, "hits": 0, "disk_hits": 0,
                    "disk_stores": 0}
            for s in self.shards:
                for key, val in s.plan_stats.items():
                    plan[key] += val
            acc = [s.accumulator_nbytes for s in self.shards]
            out = {"version": self.version, "epoch": self.epoch,
                   "num_shards": self.partition.p,
                   "deltas_applied": self.deltas_applied,
                   "rebuilds": self.rebuilds, "churn": self.churn,
                   "log_edges": self.store.log_edges,
                   "base_edges": self.store.base.s,
                   "fingerprint": self.store.fingerprint(),
                   "plan_stats": plan,
                   "shard_accumulator_bytes": acc,
                   "peak_shard_accumulator_bytes": max(acc, default=0),
                   "health": self.health()}
            if self.loop_error is not None:
                out["loop_error"] = repr(self.loop_error)
            if self.index_mode is not None:
                from repro_torch.index import DEFAULT_NPROBE
                out["index"] = {
                    "mode": self.index_mode,
                    "nprobe": (self.nprobe if self.nprobe is not None
                               else DEFAULT_NPROBE),
                    "churn_threshold": self.index_churn,
                    "moved_rows": self._index_moved,
                    "moved_fraction": self._index_moved / max(self.n, 1),
                    "requantizes": self.requantizes,
                    # per-shard rows per cell (sums to n)
                    "cell_sizes": [s.index.cell_sizes().tolist()
                                   for s in self.shards
                                   if s.index is not None]}
            if self.data_dir is not None:
                out["durability"] = {
                    "generation": self.generation,
                    "checkpoints": self.checkpoints,
                    "wal_records": self.wal.records_appended,
                    "wal_bytes": self.wal.bytes_written,
                    "fsync": self.fsync,
                    "group_commit": self.wal.group_commit,
                    "fsyncs": self.wal.fsyncs,
                    "fsync_seconds": self.wal.fsync_seconds_total,
                    "appends_per_fsync": self.wal.appends_per_fsync,
                    "pending_appends": self.wal.pending_appends}
            if obs.enabled():
                out["metrics"] = obs.snapshot(prefix="repro_serving")
            return out

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
