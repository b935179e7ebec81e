"""The port's transport (`repro_torch.transport`) on the CPU, against the
reference's (`repro.transport`).

The first half mirrors `tests/test_transport.py` on the port: the codec
and its frames under corruption, the RPC loop's robustness, WAL group
commit, the replica engine in-process, and the three multi-process
deployments (socket == in-process bit for bit, replica fallback and a
dead replica, a shard worker killed mid-batch then reopened exact), with
workers on ``--device cpu``.

The second half crosses the packages: the codec writes the reference's
bytes, a port client and a reference server talk (and the other way
round), a port `RemoteShard` drives the reference's `ShardHost`, and a
socket port engine answers as the reference's in-process engine (Z atol
1e-5, top-k under `topk_equivalent`).

Every spawning test bounds its handshake, reaps its workers in a
`finally` and gives them ``OMP_NUM_THREADS=1`` (several pytest workers
share the CPU)."""
import os
import socket
import struct
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import transport as RT
from repro.graph.edges import Graph as JGraph
from repro.serving import GraphStore as JStore
from repro.serving import ServingEngine as JEngine
from repro.serving.shard import EmbeddingShard as JShard
from repro_torch.graph.edges import Graph, make_labels
from repro_torch.graph.generators import erdos_renyi
from repro_torch.serving import GraphStore, ServingEngine
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.wal import WriteAheadLog, scan_wal
from repro_torch.transport import (MAX_FRAME, CallTimeout, FrameError,
                                   RemoteCallError, RemoteShard,
                                   ReplicaLagError, RpcClient, RpcServer,
                                   TransportError, pack_obj, recv_msg,
                                   send_msg, spawn_shard_worker, unpack_obj)
from repro_torch.transport.replica import ReplicaEngine

ROOT = Path(__file__).resolve().parents[1]
N, K = 60, 4
HANDSHAKE_S = 60.0


@pytest.fixture
def one_thread(monkeypatch):
    """Worker processes inherit one BLAS/OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _mkstore(seed=7, n=N):
    g = erdos_renyi(n, 500, seed=seed, weighted=True)
    Y = make_labels(n, K, 0.4, np.random.default_rng(seed))
    return GraphStore(g, Y, K)


def _engine(store, **kw):
    kw.setdefault("plan_cache", None)
    return ServingEngine(store, device="cpu", rpc_timeout_s=30.0, **kw)


# -- codec -------------------------------------------------------------------

def test_codec_roundtrip_preserves_structure_and_dtypes():
    msg = {"id": 3, "method": "class_stats", "none": None,
           "flags": [True, False], "pi": 3.5, "name": "shard-0",
           "raw": b"\x00\xff", "tup": (1, "two", None),
           "args": [np.arange(6, dtype=np.int32).reshape(2, 3),
                    np.linspace(0, 1, 5, dtype=np.float32),
                    np.array([], dtype=np.int64),
                    np.array(7.5, dtype=np.float64)]}
    out = unpack_obj(pack_obj(msg))
    assert out["id"] == 3 and out["none"] is None
    assert out["flags"] == [True, False] and out["tup"] == (1, "two", None)
    assert out["raw"] == b"\x00\xff"
    for a, b in zip(msg["args"], out["args"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_codec_rejects_unencodable_and_corrupt():
    with pytest.raises(TypeError):
        pack_obj({"fn": object()})
    with pytest.raises(TypeError):
        pack_obj({1: "non-str key"})
    # a tensor is not silently pickled or copied: the caller converts it
    with pytest.raises(TypeError, match="Tensor"):
        pack_obj({"q": torch.zeros(3)})
    with pytest.raises(TypeError, match="Tensor"):
        pack_obj([torch.tensor(1)])
    good = pack_obj({"a": np.arange(4)})
    with pytest.raises(FrameError):
        unpack_obj(good + b"x")          # trailing bytes
    with pytest.raises(FrameError):
        unpack_obj(b"\x7f")              # unknown tag
    with pytest.raises(FrameError):
        unpack_obj(good[:-3])            # truncated payload


def test_codec_fuzz_never_returns_garbage(rng):
    """Random corruption of a valid payload either decodes to SOME value
    (the RPC layer still checks ids) or raises FrameError; never
    anything else."""
    base = pack_obj({"id": 1, "method": "rows",
                     "args": [np.arange(32, dtype=np.int32)],
                     "kwargs": {}})
    for _ in range(200):
        blob = bytearray(base)
        if rng.random() < 0.5:
            blob = blob[:int(rng.integers(0, len(blob)))]
        else:
            off = int(rng.integers(0, len(blob)))
            blob[off] ^= 1 << int(rng.integers(0, 8))
        try:
            unpack_obj(bytes(blob))
        except FrameError:
            pass


# -- socket framing ----------------------------------------------------------

def test_frame_roundtrip_and_torn_stream(rng):
    a, b = socket.socketpair()
    try:
        payload = {"z": np.arange(100, dtype=np.float32)}
        send_msg(a, payload)
        assert np.array_equal(recv_msg(b)["z"], payload["z"])
        frame_bytes = pack_obj(payload)
        cut = int(rng.integers(1, len(frame_bytes) + 8))
        header = struct.pack("<II", len(frame_bytes),
                             zlib.crc32(frame_bytes))
        a.sendall((header + frame_bytes)[:cut])
        a.close()
        with pytest.raises(FrameError):
            recv_msg(b)
    finally:
        b.close()


def test_frame_bitflip_detected(rng):
    payload = pack_obj([1, 2, 3, "four"])
    for _ in range(32):
        a, b = socket.socketpair()
        try:
            blob = bytearray(struct.pack(
                "<II", len(payload), zlib.crc32(payload)) + payload)
            off = int(rng.integers(8, len(blob)))
            blob[off] ^= 1 << int(rng.integers(0, 8))
            a.sendall(bytes(blob))
            a.close()
            with pytest.raises(FrameError):
                recv_msg(b)
        finally:
            b.close()


def test_oversized_frame_rejected_without_allocation():
    assert MAX_FRAME == RT.MAX_FRAME == 512 << 20
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<II", (1 << 31), 0))   # 2 GiB claim
        with pytest.raises(FrameError, match="MAX_FRAME"):
            recv_msg(b)
    finally:
        a.close()
        b.close()


def test_oversized_frame_refused_before_sending(monkeypatch):
    """A payload over MAX_FRAME raises FrameError and puts no byte on
    the wire (the same check at a small limit)."""
    from repro_torch.transport import framing
    monkeypatch.setattr(framing, "MAX_FRAME", 64)
    a, b = socket.socketpair()
    try:
        with pytest.raises(FrameError, match="exceeds MAX_FRAME"):
            framing.send_msg(a, {"z": np.zeros(64, np.float32)})
        b.setblocking(False)
        with pytest.raises(BlockingIOError):
            b.recv(1)
    finally:
        a.close()
        b.close()


# -- RPC ---------------------------------------------------------------------

class _Handler:
    """Tiny RPC target for protocol tests."""

    def __init__(self):
        self.count = 0

    def add(self, a, b):
        return a + b

    def rows(self, x):
        return np.asarray(x) * 2

    def bump(self):
        self.count += 1
        return self.count

    def bad_index(self):
        raise IndexError("node ids outside [0, 60)")

    def lagging(self):
        raise ReplicaLagError("replica at 3, pinned 7", have=3, want=7)

    def weird(self):
        raise OSError("handler-side disk error")

    def nap(self, seconds):
        time.sleep(seconds)
        return "woke"


@pytest.fixture
def server():
    srv = RpcServer(_Handler()).start()
    yield srv
    srv.close()


def test_rpc_loopback_arrays_and_typed_errors(server):
    c = RpcClient(server.address, timeout_s=5)
    assert c.call("add", 2, 3) == 5
    out = c.call("rows", np.arange(5, dtype=np.int32), idempotent=True)
    assert np.array_equal(out, np.arange(5) * 2)
    with pytest.raises(IndexError, match="outside"):
        c.call("bad_index")
    with pytest.raises(ReplicaLagError):
        c.call("lagging")
    with pytest.raises(RemoteCallError, match="OSError"):
        c.call("weird", idempotent=True)
    c.close()


def test_rpc_blocks_private_and_unknown_methods(server):
    c = RpcClient(server.address, timeout_s=5)
    with pytest.raises(RemoteCallError, match="AttributeError"):
        c.call("_Handler__count")
    with pytest.raises(RemoteCallError, match="AttributeError"):
        c.call("no_such_method")
    c.close()


def test_rpc_call_timeout_is_transport_error(server):
    c = RpcClient(server.address, timeout_s=5)
    with pytest.raises(CallTimeout):
        c.call("nap", 3.0, timeout_s=0.2)
    c.close()


def test_rpc_torn_connection_isolated_from_other_clients(server):
    good = RpcClient(server.address, timeout_s=5)
    assert good.call("add", 1, 1) == 2
    for junk in (b"not a frame at all", b"\xff" * 7):
        rogue = socket.create_connection(
            ("127.0.0.1", int(server.address.rsplit(":", 1)[1])))
        rogue.sendall(junk)
        rogue.close()
    assert good.call("add", 2, 2) == 4
    good.close()


def test_rpc_duplicate_and_interleaved_idempotent_reads(server):
    c1 = RpcClient(server.address, timeout_s=5)
    c2 = RpcClient(server.address, timeout_s=5)
    x = np.arange(16, dtype=np.int64)
    for i in range(8):
        a = c1.call("rows", x + i, idempotent=True)
        b = c2.call("rows", x + i, idempotent=True)
        again = c1.call("rows", x + i, idempotent=True)
        assert np.array_equal(a, b) and np.array_equal(a, again)
    c1.close()
    c2.close()


def test_rpc_retry_policy_idempotent_reads_only(server, monkeypatch):
    c = RpcClient(server.address, timeout_s=5, retries=2, backoff_s=0.01)
    real = c._call_once
    fails = {"left": 1}

    def flaky(method, args, kwargs, timeout):
        if fails["left"]:
            fails["left"] -= 1
            raise TransportError("injected torn stream")
        return real(method, args, kwargs, timeout)

    monkeypatch.setattr(c, "_call_once", flaky)
    out = c.call("rows", np.arange(3), idempotent=True)
    assert np.array_equal(out, [0, 2, 4])
    fails["left"] = 1
    with pytest.raises(TransportError, match="injected"):
        c.call("bump")
    assert server.handler.count == 0    # the mutation was never re-sent
    c.close()


def test_rpc_dead_server_errors_loudly():
    srv = RpcServer(_Handler()).start()
    addr = srv.address
    srv.close()
    c = RpcClient(addr, timeout_s=2, retries=2, backoff_s=0.01)
    with pytest.raises(TransportError):
        c.call("bump")
    with pytest.raises(TransportError):
        c.call("rows", np.arange(2), idempotent=True)
    c.close()


def test_rpc_client_reconnects_after_server_restart():
    srv = RpcServer(_Handler()).start()
    host, port = srv.addr
    c = RpcClient(srv.address, timeout_s=5)
    assert c.call("add", 1, 2) == 3
    srv.close()
    c.close()
    srv2 = RpcServer(_Handler(), host=host, port=port).start()
    try:
        assert c.call("add", 2, 2) == 4
        assert c.reconnects == 2
    finally:
        c.close()
        srv2.close()


def test_rpc_server_close_wakes_blocked_accept():
    srv = RpcServer(_Handler())
    t = threading.Thread(target=srv.serve_forever)
    t.start()
    time.sleep(0.1)
    srv.close()
    t.join(timeout=5)
    assert not t.is_alive()


def test_rpc_shutdown_request_stops_server():
    srv = RpcServer(_Handler())
    t = threading.Thread(target=srv.serve_forever)
    t.start()
    c = RpcClient(srv.address, timeout_s=5)
    assert c.call("add", 1, 1) == 2
    c.shutdown_server()
    c.close()
    t.join(timeout=5)
    assert not t.is_alive()


def test_rpc_thread_init_runs_in_every_connection_thread():
    """The port's one addition: each connection thread runs
    `thread_init` first (a worker pins its CUDA device with it)."""
    seen = []
    srv = RpcServer(_Handler(), thread_init=lambda: seen.append(
        threading.current_thread().name)).start()
    try:
        for _ in range(2):
            c = RpcClient(srv.address, timeout_s=5)
            assert c.call("add", 1, 1) == 2
            c.close()
    finally:
        srv.close()
    assert seen == ["rpc-conn", "rpc-conn"]


# -- WAL group commit --------------------------------------------------------

def test_wal_group_commit_batches_fsync_barriers(tmp_path, rng):
    wal = WriteAheadLog(str(tmp_path / "g.wal"), fsync=True,
                        group_commit_bytes=1 << 20)
    wal.open()
    u = rng.integers(0, N, 8).astype(np.int32)
    w = rng.random(8).astype(np.float32)
    for i in range(10):
        wal.append_edges(i + 1, u, u, w)
    assert wal.pending_appends == 10 and wal.fsyncs == 0
    assert wal.sync() == 10
    assert wal.pending_appends == 0 and wal.fsyncs == 1
    assert wal.appends_per_fsync == 10.0
    assert wal.sync() == 0
    wal.close()


def test_wal_group_commit_bytes_threshold_auto_syncs(tmp_path, rng):
    wal = WriteAheadLog(str(tmp_path / "g.wal"), fsync=True,
                        group_commit_bytes=64)
    wal.open()
    u = rng.integers(0, N, 16).astype(np.int32)
    wal.append_edges(1, u, u, np.ones(16, np.float32))
    assert wal.fsyncs == 1 and wal.pending_appends == 0
    wal.close()


def test_wal_group_commit_age_threshold(tmp_path, rng):
    wal = WriteAheadLog(str(tmp_path / "g.wal"), fsync=True,
                        group_commit_ms=20.0, group_commit_bytes=1 << 30)
    wal.open()
    u = rng.integers(0, N, 4).astype(np.int32)
    wal.append_edges(1, u, u, np.ones(4, np.float32))
    assert wal.sync_if_due() == 0
    time.sleep(0.03)
    assert wal.sync_if_due() == 1
    wal.close()


def test_wal_close_never_orphans_an_open_group(tmp_path, rng):
    path = str(tmp_path / "g.wal")
    wal = WriteAheadLog(path, fsync=True, group_commit_bytes=1 << 30)
    wal.open()
    u = rng.integers(0, N, 4).astype(np.int32)
    for i in range(3):
        wal.append_edges(i + 1, u, u, np.ones(4, np.float32))
    wal.close()
    assert wal.fsyncs == 1 and wal.appends_covered == 3
    records, _ = scan_wal(path)
    assert len(records) == 3


def test_engine_group_commit_defers_tickets_until_barrier(tmp_path):
    eng = _engine(_mkstore(), data_dir=str(tmp_path / "d"), fsync=True,
                  group_commit_bytes=1 << 20)
    assert eng.wal.group_commit
    bat = MicroBatcher(eng, topk=5)
    one = np.ones(1, np.float32)
    t1 = bat.submit("insert", (np.array([1], np.int32),
                               np.array([2], np.int32), one))
    t2 = bat.submit("insert", (np.array([3], np.int32),
                               np.array([4], np.int32), one))
    tr = bat.submit("embed", np.array([0, 1]))
    bat.flush()
    assert t1.result() == 1 and t2.result() == 2
    assert (t1.version, t2.version) == (1, 2)
    assert tr.result().shape == (2, K)
    assert eng.wal.pending_appends == 0
    assert eng.wal.fsyncs == 1 and eng.wal.appends_per_fsync == 2.0
    dur = eng.stats()["durability"]
    assert dur["group_commit"] and dur["fsync"]
    assert dur["appends_per_fsync"] == 2.0 and dur["pending_appends"] == 0
    assert dur["fsync_seconds"] >= 0.0
    eng.close()


# -- replica engine (in-process: bootstrap, tail, version pinning) -----------

def test_replica_bootstraps_bit_equal_and_tails_the_wal(tmp_path, rng):
    d = str(tmp_path / "dep")
    eng = _engine(_mkstore(), num_shards=2, data_dir=d)
    rep = ReplicaEngine(d, start_tail=False, plan_cache=None, device="cpu")
    try:
        assert rep.status()["fingerprint"] == eng.fingerprint()
        assert rep.device == torch.device("cpu")
        nodes = rng.integers(0, N, 16).astype(np.int32)
        assert np.array_equal(rep.embed(nodes), eng.query_embed(nodes))
        eng.apply_edge_delta(np.array([0], np.int32),
                             np.array([1], np.int32),
                             np.ones(1, np.float32))
        with pytest.raises(ReplicaLagError):
            rep.embed(nodes, min_version=eng.version)
        assert rep.poll() == 1
        assert rep.engine.version == eng.version
        assert np.array_equal(rep.embed(nodes, min_version=eng.version),
                              eng.query_embed(nodes))
        ei, ev = eng.query_topk(nodes, k=5)
        ri, rv = rep.topk(nodes, k=5, min_version=eng.version)
        assert np.array_equal(ei, ri) and np.array_equal(ev, rv)
    finally:
        rep.close()
        eng.close()


def test_replica_ivf_read_before_index_record_is_lag(tmp_path, rng):
    d = str(tmp_path / "dep")
    eng = _engine(_mkstore(), data_dir=d)
    rep = ReplicaEngine(d, start_tail=False, plan_cache=None, device="cpu")
    try:
        nodes = rng.integers(0, N, 8).astype(np.int32)
        with pytest.raises(ReplicaLagError):
            rep.topk(nodes, k=5, mode="ivf")
    finally:
        rep.close()
        eng.close()


def test_replica_reloads_on_checkpoint_generation_flip(tmp_path, rng):
    d = str(tmp_path / "dep")
    eng = _engine(_mkstore(), data_dir=d)
    rep = ReplicaEngine(d, start_tail=False, plan_cache=None, device="cpu")
    try:
        reloads0 = rep.status()["reloads"]
        eng.apply_edge_delta(np.array([2], np.int32),
                             np.array([3], np.int32),
                             np.ones(1, np.float32))
        eng.checkpoint()
        rep.poll()
        st = rep.status()
        assert st["generation"] == eng.generation
        assert st["fingerprint"] == eng.fingerprint()
        assert st["reloads"] == reloads0 + 1
    finally:
        rep.close()
        eng.close()


# -- multi-process deployments (spawn real workers, --device cpu) -----------

@pytest.mark.slow
@pytest.mark.parametrize("backend", ["streaming", "cuda"])
def test_socket_engine_answers_equal_inprocess(one_thread, rng, backend):
    local = _engine(_mkstore(seed=11), num_shards=2, index="ivf",
                    backend=backend)
    sock = _engine(_mkstore(seed=11), num_shards=2, index="ivf",
                   backend=backend, transport="socket")
    procs = [s.proc for s in sock.shards]
    try:
        assert all(p is not None and p.alive() for p in procs)
        for s in sock.shards:
            ping = s.ping()
            assert ping["device"] == "cpu" and ping["backend"] == backend
            assert s.device == torch.device("cpu")
        nodes = rng.integers(0, N, 32).astype(np.int32)
        assert np.array_equal(local.query_embed(nodes),
                              sock.query_embed(nodes))
        for mode, nprobe in (("exact", None), ("ivf", 2)):
            li, lv = local.query_topk(nodes, k=5, mode=mode, nprobe=nprobe)
            si, sv = sock.query_topk(nodes, k=5, mode=mode, nprobe=nprobe)
            assert np.array_equal(li, si) and np.array_equal(lv, sv)
        b = 16
        du = rng.integers(0, N, b).astype(np.int32)
        dv = rng.integers(0, N, b).astype(np.int32)
        dw = rng.random(b).astype(np.float32) + 0.5
        for eng in (local, sock):
            eng.apply_edge_delta(du, dv, dw)
            eng.apply_label_delta(np.array([5, 6]), np.array([1, 2]))
        assert sock.fingerprint() == local.fingerprint()
        assert (sock.version, sock.epoch) == (local.version, local.epoch)
        assert torch.equal(local.Z, sock.Z)
        for a, b_ in zip(local.shards, sock.shards):
            assert torch.equal(a.Z_owned, b_.Z_owned)
        assert np.array_equal(local.query_predict(nodes)[0],
                              sock.query_predict(nodes)[0])
        li, lv = local.query_topk(nodes, k=5)
        si, sv = sock.query_topk(nodes, k=5)
        assert np.array_equal(li, si) and np.array_equal(lv, sv)
        st = sock.stats()
        assert st["transport"]["mode"] == "socket"
        assert st["index"]["cell_sizes"] == local.stats()["index"][
            "cell_sizes"]
    finally:
        sock.close()
        local.close()
    assert not any(p.alive() for p in procs)
    assert [p.proc.returncode for p in procs] == [0, 0]   # a clean exit


@pytest.mark.slow
def test_replica_worker_fallback_and_dead_replica_degrades(
        one_thread, tmp_path, rng):
    d = str(tmp_path / "dep")
    eng = _engine(_mkstore(), data_dir=d, replicas=1)
    try:
        nodes = rng.integers(0, N, 16).astype(np.int32)
        assert np.array_equal(eng.query_embed(nodes),
                              eng.Z.numpy()[nodes])
        eng.apply_edge_delta(np.array([0], np.int32),
                             np.array([1], np.int32),
                             np.ones(1, np.float32))
        assert np.array_equal(eng.query_embed(nodes),
                              eng.Z.numpy()[nodes])
        deadline = time.time() + 30
        while time.time() < deadline:
            rows = eng.health()["replicas"]
            if rows and rows[0].get("lag") == 0:
                break
            time.sleep(0.1)
        else:
            pytest.fail(f"replica never converged: {eng.health()}")
        ping = eng._replicas[0].ping()
        assert ping["role"] == "replica" and ping["device"] == "cpu"
        # a converged replica serves the pinned read, equal to the owner's
        ri, rv = eng._replicas[0].topk(nodes, k=5, min_version=eng.version)
        replicas, eng._replicas = eng._replicas, []   # the owner alone
        oi, ov = eng.query_topk(nodes, k=5)
        eng._replicas = replicas
        assert np.array_equal(ri, oi) and np.array_equal(rv, ov)
        eng._replica_procs[0].kill()
        assert np.array_equal(eng.query_embed(nodes),
                              eng.Z.numpy()[nodes])
        h = eng.health()
        assert h["state"] == "degraded"
        assert "unreachable" in h["reason"]
    finally:
        eng.close()


@pytest.mark.slow
def test_kill_shard_worker_mid_batch_then_reopen_exact(
        one_thread, tmp_path, rng, assert_topk_equivalent):
    """Kill a shard worker mid-workload: the write in flight errors
    loudly, but append-before-apply put it in the WAL, so reopening with
    fresh workers recovers the oracle's state (every batch, the torn one
    included) with an exact triple."""
    b = 12
    batches = [(rng.integers(0, N, b).astype(np.int32),
                rng.integers(0, N, b).astype(np.int32),
                rng.random(b).astype(np.float32) + 0.5)
               for _ in range(4)]
    oracle = _engine(_mkstore(seed=13), num_shards=2,
                     data_dir=str(tmp_path / "oracle"))
    d = str(tmp_path / "dep")
    eng = _engine(_mkstore(seed=13), num_shards=2, data_dir=d,
                  transport="socket")
    try:
        for batch in batches[:3]:
            eng.apply_edge_delta(*batch)
            oracle.apply_edge_delta(*batch)
        eng.shards[0].proc.kill()
        with pytest.raises(TransportError):
            eng.apply_edge_delta(*batches[3])
    finally:
        eng.close()
    oracle.apply_edge_delta(*batches[3])
    rec = ServingEngine.open(d, transport="socket", plan_cache=None,
                             device="cpu")
    try:
        assert (rec.version, rec.epoch, rec.fingerprint()) == \
            (oracle.version, oracle.epoch, oracle.fingerprint())
        nodes = rng.integers(0, N, 16).astype(np.int32)
        oi, ov = oracle.query_topk(nodes, k=5)
        ri, rv = rec.query_topk(nodes, k=5)
        assert_topk_equivalent(oi, ov, ri, rv, atol=1e-4)
    finally:
        rec.close()
        oracle.close()


def test_worker_without_a_card_fails_its_handshake(one_thread):
    """A worker asked for the card where there is none exits before its
    handshake, and the error names its stderr (it never serves on the
    CPU).  Skipped on a machine with a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda worker would start")
    with pytest.raises(TransportError,
                       match=r"(?s)before listening.*is_available"):
        spawn_shard_worker(0, 0, N, K=K, n=N, device="cuda",
                           plan_cache=None, timeout_s=HANDSHAKE_S)


def test_a_failed_boot_leaves_no_worker_behind(one_thread, tmp_path,
                                              monkeypatch):
    """Workers spawned before the boot fails (here: the data directory
    already holds a deployment) are shut down and reaped."""
    from repro_torch.transport import procs as P
    spawned = []
    real = P._spawn

    def spy(*a, **kw):
        spawned.append(real(*a, **kw))
        return spawned[-1]

    monkeypatch.setattr(P, "_spawn", spy)
    d = str(tmp_path / "dep")
    _engine(_mkstore(), data_dir=d).close()
    with pytest.raises(FileExistsError):
        _engine(_mkstore(), num_shards=2, data_dir=d, transport="socket")
    assert len(spawned) == 2
    assert not any(w.alive() for w in spawned)


def test_worker_env_pins_the_router_config(monkeypatch):
    from repro_torch import obs
    from repro_torch.transport import worker_env
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    env = worker_env()
    assert env["CUDA_VISIBLE_DEVICES"] == "3"
    assert env["REPRO_OBS"] == ("on" if obs.enabled() else "off")
    src = env["PYTHONPATH"].split(os.pathsep)
    assert src[0] == str(ROOT / "src") and src[1] == "/elsewhere"


# -- across the packages -----------------------------------------------------

def _corpus():
    """The RPC's payloads: requests of every wire method, ok and error
    responses, pings, nested containers and scalar edge cases."""
    r = np.random.default_rng(5)
    u = r.integers(0, 100, 7).astype(np.int32)
    w = r.random(7).astype(np.float32)
    q = r.random((3, 4)).astype(np.float32)
    return {
        "build": {"id": 0, "method": "build", "kwargs": {},
                  "args": [u, u[::-1].copy(), w, 100, "ab" * 16,
                           np.arange(100, dtype=np.int32) % 5 - 1]},
        "apply_delta": {"id": 1, "method": "apply_delta", "kwargs": {},
                        "args": [u, u, -w, 100]},
        "topk": {"id": 2, "method": "topk_candidates", "kwargs": {},
                 "args": [q, u[:3], 5, 1 << 14]},
        "replica_topk": {"id": 3, "method": "topk", "kwargs": {},
                         "args": [u.astype(np.int64), 5, 16384, "ivf",
                                  None, 12]},
        "ok": {"id": 4, "ok": True,
               "value": [np.arange(6, dtype=np.int32).reshape(2, 3),
                         q.astype(np.float64), 7]},
        "error": {"id": 5, "ok": False, "etype": "ReplicaLagError",
                  "error": "replica at version 3 < pinned 4"},
        "ping": {"id": 6, "ok": True, "value": {
            "role": "shard", "pid": 123, "lo": 0, "hi": 30,
            "device": "cuda:0", "obs": True,
            "launches": {"gee_scatter": 1, "topk_fused": 0}}},
        "scalars": [None, True, False, -1, 2 ** 62, 0.1, -0.0,
                    float("inf"), "", "ünïcode", b"", b"\x00",
                    np.int64(-3), np.float32(0.5), (), [], {}],
        "arrays": [np.zeros((0, 3), np.float32), np.array(7.5),
                   np.arange(4, dtype=np.uint8), np.ones(2, bool),
                   np.asfortranarray(q), q[:, ::2]],
    }


@pytest.mark.parametrize("name", list(_corpus()))
def test_codec_bytes_equal_the_reference(name):
    obj = _corpus()[name]
    port, ref = pack_obj(obj), RT.pack_obj(obj)
    assert port == ref
    # and each side decodes the other's bytes to the same structure
    assert pack_obj(RT.unpack_obj(port)) == ref
    assert RT.pack_obj(unpack_obj(ref)) == port


@pytest.mark.parametrize("direction", ["port-client", "reference-client"])
def test_rpc_crosses_the_packages(direction):
    Server, Client = ((RT.RpcServer, RpcClient)
                      if direction == "port-client"
                      else (RpcServer, RT.RpcClient))
    srv = Server(_Handler()).start()
    c = Client(srv.address, timeout_s=5)
    try:
        assert c.call("add", 2, 3) == 5
        out = c.call("rows", np.arange(5, dtype=np.int32), idempotent=True)
        assert out.dtype == np.int32 and np.array_equal(out,
                                                        np.arange(5) * 2)
        with pytest.raises(IndexError, match="outside"):
            c.call("bad_index")
        with pytest.raises(Exception) as e:
            c.call("lagging")
        assert type(e.value).__name__ == "ReplicaLagError"
        with pytest.raises(Exception, match="AttributeError"):
            c.call("_private")
    finally:
        c.close()
        srv.close()


def test_remote_shard_drives_the_reference_shard_host(
        rng, assert_topk_equivalent):
    """The wire is shared: a port `RemoteShard` calls the reference's
    `ShardHost` (served in this process) with every shard method, and its
    answers agree with the reference's own `EmbeddingShard`."""
    from repro.transport.worker import ShardHost as JShardHost
    n, K_ = 300, 5
    g = erdos_renyi(n, 4000, seed=3, weighted=True)
    Y = make_labels(n, K_, 0.3, np.random.default_rng(3))
    lo, hi = 100, 220
    sub = Graph(g.u, g.v, g.w, n)
    host = JShardHost(1, lo, hi, K=K_, n=n, plan_cache=None)
    srv = RT.RpcServer(host).start()
    remote = RemoteShard(srv.address, 1, lo, hi, device="cpu")
    ref = JShard(1, lo, hi, K=K_, n=n, plan_cache=None)
    try:
        remote.build(sub, Y)
        ref.build(JGraph(g.u, g.v, g.w, n), Y)
        assert remote.ping()["backend"] == "streaming"
        np.testing.assert_allclose(remote.Z_owned.numpy(),
                                   np.asarray(ref.Z_owned), atol=1e-5)
        d = Graph(rng.integers(lo, hi, 30).astype(np.int32),
                  rng.integers(0, n, 30).astype(np.int32),
                  rng.random(30).astype(np.float32), n)
        remote.apply_delta(d)
        ref.apply_delta(JGraph(d.u, d.v, d.w, n))
        Zr = remote.Z_owned
        assert Zr.dtype == torch.float32 and Zr.device.type == "cpu"
        np.testing.assert_allclose(Zr.numpy(), np.asarray(ref.Z_owned),
                                   atol=1e-5)
        assert remote.accumulator_nbytes == ref.accumulator_nbytes
        nodes = np.array([lo, lo + 7, hi - 1])
        np.testing.assert_allclose(remote.rows(nodes).numpy(),
                                   np.asarray(ref.rows(nodes)), atol=1e-5)
        s_p, c_p = remote.class_stats(Y)
        s_r, c_r = ref.class_stats(Y)
        np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), atol=1e-5)
        np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
        qnodes = np.array([5, 150, 299], np.int32)
        q = np.asarray(ref.normalized())[[50, 60, 70]]
        pi, pv = remote.topk_candidates(torch.as_tensor(q), qnodes, k=7)
        ri, rv = ref.topk_candidates(q, qnodes, k=7, block_rows=1 << 14)
        assert_topk_equivalent(np.asarray(ri), np.asarray(rv), pi, pv)
        assert remote.index is None
        assert remote.embedder.Z_.shape == (hi - lo, K_)
        assert remote.plan_stats == ref.plan_stats
    finally:
        remote.close()
        srv.close()


@pytest.mark.parametrize("backend", ["streaming", "cuda"])
def test_socket_port_engine_agrees_with_the_reference(
        one_thread, rng, assert_topk_equivalent, backend):
    """A 2-shard socket port engine against the reference's in-process
    engine on the same graph and writes: Z within atol 1e-5, top-k under
    `topk_equivalent`, the same (version, epoch)."""
    g = erdos_renyi(N, 600, seed=21, weighted=True)
    Y = make_labels(N, K, 0.4, np.random.default_rng(21))
    ref = JEngine(JStore(JGraph(g.u, g.v, g.w, N), Y.copy(), K),
                  num_shards=2, plan_cache=None)
    sock = _engine(GraphStore(g, Y.copy(), K), num_shards=2,
                   backend=backend, transport="socket")
    try:
        for _ in range(3):
            u = rng.integers(0, N, 20).astype(np.int32)
            v = rng.integers(0, N, 20).astype(np.int32)
            w = rng.random(20).astype(np.float32) + 0.5
            ref.apply_edge_delta(u, v, w)
            sock.apply_edge_delta(u, v, w)
        ref.apply_label_delta(np.array([1, 2, 3]), np.array([0, 1, 2]))
        sock.apply_label_delta(np.array([1, 2, 3]), np.array([0, 1, 2]))
        assert (sock.version, sock.epoch) == (ref.version, ref.epoch)
        np.testing.assert_allclose(sock.Z.numpy(), np.asarray(ref.Z),
                                   atol=1e-5)
        nodes = rng.integers(0, N, 24).astype(np.int32)
        ri, rv = ref.query_topk(nodes, k=6)
        si, sv = sock.query_topk(nodes, k=6)
        assert_topk_equivalent(np.asarray(ri), np.asarray(rv), si, sv)
        np.testing.assert_allclose(sock.query_embed(nodes),
                                   np.asarray(ref.query_embed(nodes)),
                                   atol=1e-5)
    finally:
        sock.close()
        ref.close()
