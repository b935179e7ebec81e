"""repro_torch.serving.ServingEngine against repro.serving.ServingEngine.

The port's engine runs the cuda backend on the CPU (each kernel's plain
version), the reference its default streaming backend, on the same
store through the same operations, for 1, 2 and 4 shards and K in
{8, 160}.  They must agree on (version, epoch, fingerprint) after every
operation, on Z within atol 1e-5, on top-k by `conftest.topk_equivalent`
and on predictions wherever the best class wins by more than 1e-5.  A
data directory written by either package opens in the other.

Inside the port the reference's own contracts are held exactly: top-k
answers are bit-equal for every shard count (the reference fails that
at 4 shards, `test_index.py::TestTieBreaking`), and recovery restores
the exact state."""
import warnings

import numpy as np
import pytest
import torch

from conftest import topk_equivalent
from repro.graph.edges import Graph as JGraph
from repro.serving import GraphStore as JStore
from repro.serving import ServingEngine as JEngine
from repro_torch.core.gee import gee
from repro_torch.graph import make_labels, sbm
from repro_torch.serving import (EmbeddingService, GraphStore, MicroBatcher,
                                 ServingEngine)

N, S = 2000, 40_000


def _data(K, seed=0):
    g, truth = sbm(N, K, S, p_in=0.85, seed=seed)
    Y = make_labels(N, K, 0.1, np.random.default_rng(seed),
                    true_labels=truth)
    return g, Y, truth


def _port(g, Y, K, **kw):
    return ServingEngine(GraphStore(g, Y, K), device="cpu", backend="cuda",
                         **kw)


def _ref(g, Y, K, **kw):
    return JEngine(JStore(JGraph(g.u, g.v, g.w, g.n), Y, K),
                   plan_cache=None, **kw)


def _ops(rng, truth, K):
    """A mixed write sequence: inserts, a deletion of an earlier insert,
    label reveals (one large enough to pass the churn threshold), a
    compaction and a forced rebuild."""
    ops, inserted = [], []
    for step in range(8):
        u = rng.integers(0, N, 200).astype(np.int32)
        v = rng.integers(0, N, 200).astype(np.int32)
        w = rng.random(200).astype(np.float32) + 0.5
        ops.append(("insert", (u, v, w)))
        inserted.append((u, v, w))
        if step == 2:
            ops.append(("delete", inserted.pop(0)))
        if step in (3, 6):
            nodes = rng.choice(N, 21 if step == 3 else 150, replace=False)
            ops.append(("labels", (nodes, truth[nodes])))
        if step == 4:
            ops.append(("compact", None))
        if step == 5:
            ops.append(("refresh", None))
    return ops


def _apply(eng, op, arg):
    if op in ("insert", "delete"):
        eng.apply_edge_delta(*arg, delete=op == "delete")
    elif op == "labels":
        eng.apply_label_delta(*arg)
    else:
        getattr(eng, op)()


def _key_weights(g):
    """{(u, v): summed weight} of an edge multiset, near-zero sums
    dropped (what a compaction keeps)."""
    out = {}
    for a, b, c in zip(g.u.tolist(), g.v.tolist(), g.w.tolist()):
        out[(a, b)] = out.get((a, b), 0.0) + c
    return {key: w for key, w in out.items() if abs(w) > 1e-6}


def _triple(eng):
    return eng.version, eng.epoch, eng.fingerprint()


def _Z(eng):
    Z = eng.Z
    return Z.cpu().numpy() if isinstance(Z, torch.Tensor) else np.asarray(Z)


def _agree(port, ref, nodes, k):
    assert _triple(port) == _triple(ref)
    np.testing.assert_allclose(_Z(port), _Z(ref), atol=1e-5)
    topk_equivalent(*port.query_topk(nodes, k=k), *ref.query_topk(nodes,
                                                                  k=k))
    (pp, ps), (rp, rs) = port.query_predict(nodes), ref.query_predict(nodes)
    np.testing.assert_allclose(ps, np.asarray(rs), atol=1e-5)
    C = port.centroids()
    sims = torch.nn.functional.normalize(port.Z[torch.as_tensor(
        nodes).long()], dim=1) @ torch.nn.functional.normalize(C, dim=1).T
    top2 = sims.topk(2, dim=1).values
    decided = ((top2[:, 0] - top2[:, 1]) > 1e-5).numpy()
    assert np.array_equal(pp[decided], np.asarray(rp)[decided])
    np.testing.assert_allclose(port.query_embed(nodes),
                               np.asarray(ref.query_embed(nodes)),
                               atol=1e-5)


@pytest.mark.parametrize("K", [8, 160])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_engine_agrees_with_reference(tmp_path, rng, shards, K):
    g, Y, truth = _data(K)
    pd, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    port = _port(g, Y, K, num_shards=shards, data_dir=pd)
    ref = _ref(g, Y, K, num_shards=shards, data_dir=rd)
    nodes = rng.integers(0, N, 64).astype(np.int32)
    _agree(port, ref, nodes, 10)
    for op, arg in _ops(rng, truth, K):
        _apply(port, op, arg)
        _apply(ref, op, arg)
        assert _triple(port) == _triple(ref), op
    assert port.epoch >= 4            # compact, refresh, the churned reveal
    _agree(port, ref, nodes, 10)
    topk_equivalent(*port.query_topk(nodes, k=100),
                    *ref.query_topk(nodes, k=100))
    live = {"port": (_triple(port), _Z(port)), "ref": (_triple(ref),
                                                      _Z(ref))}
    port.close()
    ref.close()
    # each package's data directory opens in the other
    in_ref = JEngine.open(pd, plan_cache=None)
    in_port = ServingEngine.open(rd, device="cpu", backend="cuda")
    for eng, (triple, Z) in ((in_ref, live["port"]), (in_port,
                                                       live["ref"])):
        assert _triple(eng) == triple
        np.testing.assert_allclose(_Z(eng), Z, atol=1e-5)
    in_port.apply_edge_delta([1, 2], [3, 4], [1.0, 1.0])   # log appends
    in_port.close()
    in_ref.close()


def test_topk_is_bit_equal_across_shard_counts(rng):
    """The reference's cross-shard bitwise contract, held inside the
    port (k beyond n included)."""
    g, Y, _ = _data(8, seed=1)
    d = (rng.integers(0, N, 300).astype(np.int32),
         rng.integers(0, N, 300).astype(np.int32),
         rng.random(300).astype(np.float32))
    nodes = rng.integers(0, N, 100).astype(np.int32)
    answers = []
    for p in (1, 2, 4):
        eng = _port(g, Y, 8, num_shards=p)
        eng.apply_edge_delta(*d)
        answers.append([eng.query_topk(nodes, k=k) for k in (1, 10, 64)])
        answers[-1].append(eng.query_topk(nodes[:3], k=N + 5))
    for other in answers[1:]:
        for (i0, v0), (i1, v1) in zip(answers[0], other):
            assert np.array_equal(i0, i1) and np.array_equal(v0, v1)
    idx, val = answers[0][-1]
    assert (idx[:, N - 1:] == -1).all() and np.isneginf(val[:, N - 1:]).all()


def test_recovery_over_a_torn_wal_tail(tmp_path, rng):
    g, Y, truth = _data(8, seed=2)
    d = str(tmp_path / "dep")
    eng = _port(g, Y, 8, num_shards=2, data_dir=d)
    states = []
    for op, arg in _ops(rng, truth, 8):
        _apply(eng, op, arg)
        states.append((_triple(eng), _Z(eng)))
    eng.close()
    wal = tmp_path / "dep" / f"wal-{eng.generation}.log"
    blob = wal.read_bytes()
    wal.write_bytes(blob[:-7])                # a crash mid-append
    rec = ServingEngine.open(d, device="cpu", backend="cuda")
    assert _triple(rec) == states[-2][0]
    np.testing.assert_allclose(_Z(rec), states[-2][1], atol=1e-5)
    assert wal.stat().st_size < len(blob) - 7     # torn record dropped
    rec.close()
    wal.write_bytes(blob)                     # the whole log: last state
    rec = ServingEngine.open(d, device="cpu", backend="cuda")
    assert _triple(rec) == states[-1][0]
    rec.close()


def test_checkpoint_rotates_the_generation(tmp_path, rng):
    g, Y, truth = _data(8, seed=3)
    d = tmp_path / "dep"
    eng = _port(g, Y, 8, num_shards=2, data_dir=str(d))
    for op, arg in _ops(rng, truth, 8)[:4]:
        _apply(eng, op, arg)
    info = eng.checkpoint()
    assert info["generation"] == 1 and eng.checkpoints == 1
    assert sorted(p.name for p in d.iterdir()) == [
        "MANIFEST", "snap-1.edges.npz", "snap-1.engine.json",
        "snap-1.meta.npz", "wal-1.log"]
    nodes = rng.integers(0, N, 64).astype(np.int32)
    held = eng.query_topk(nodes, k=10)
    triple, Z = _triple(eng), _Z(eng)
    eng.close()
    rec = ServingEngine.open(str(d), device="cpu", backend="cuda")
    assert _triple(rec) == triple and rec.checkpoints == 1
    assert np.array_equal(_Z(rec), Z)
    got = rec.query_topk(nodes, k=10)
    assert np.array_equal(got[0], held[0]) and np.array_equal(got[1],
                                                              held[1])
    with pytest.raises(FileExistsError):
        _port(g, Y, 8, data_dir=str(d))
    rec.close()


def test_start_loop_serves_concurrent_tickets(tmp_path, rng):
    """The flush loop on its own thread: writes apply in submission
    order, reads see them, nothing is lost, and loop_error stays None."""
    g, Y, truth = _data(8, seed=4)
    eng = _port(g, Y, 8, num_shards=2, data_dir=str(tmp_path / "dep"))
    twin = _port(g, Y, 8, num_shards=2)
    batcher = eng.start(MicroBatcher(eng, topk=5), interval=1e-4,
                        checkpoint_bytes=20_000)
    ops = _ops(rng, truth, 8)
    tickets = []
    for op, arg in ops:
        if op in ("insert", "delete", "labels"):
            tickets.append(batcher.submit(op, arg))
            _apply(twin, op, arg)
        for kind in ("embed", "predict", "topk"):
            tickets.append(batcher.submit(kind, rng.integers(0, N, 16)))
    for t in tickets:
        t.result(timeout=60)
    bad = batcher.submit("topk", np.array([N + 3]))
    with pytest.raises(IndexError):
        bad.result(timeout=60)
    eng.stop()
    assert eng.loop_error is None
    assert eng.health()["state"] == "serving"
    assert eng.version == twin.version
    assert np.array_equal(eng.store.Y, twin.store.Y)
    # the loop's checkpoint compacted (and rehashed) the multiset: the
    # same content as the twin's, and Z is a fit of it
    assert eng.checkpoints >= 1          # the WAL outgrew 20 kB
    assert eng.store.log_edges < twin.store.log_edges
    assert _key_weights(eng.store.edges()) == pytest.approx(
        _key_weights(twin.store.edges()), abs=1e-4)
    live = eng.store.edges()
    fresh = gee(*(torch.as_tensor(np.asarray(a)) for a in (
        live.u, live.v, live.w, eng.Y_epoch)), K=8, n=N)
    np.testing.assert_allclose(_Z(eng), fresh.numpy(), atol=1e-5)
    nodes = rng.integers(0, N, 32).astype(np.int32)
    np.testing.assert_array_equal(
        eng.query_embed(nodes), eng.Z[torch.as_tensor(nodes).long()].numpy())
    st = batcher.stats()
    assert st["insert"]["requests"] == sum(o == "insert" for o, _ in ops)
    assert st["topk"]["errors"] == 1
    stats = eng.stats()
    assert stats["durability"]["checkpoints"] == eng.checkpoints
    assert stats["plan_stats"]["disk_hits"] == 0
    eng.close()
    with pytest.raises(RuntimeError, match="already running"):
        eng.start()
        eng.start()
    eng.close()


def test_loop_error_is_recorded_and_degrades_health(tmp_path):
    g, Y, _ = _data(8, seed=5)
    eng = _port(g, Y, 8, num_shards=2)

    class Broken(MicroBatcher):
        def flush(self):
            raise OSError("disk full")

    eng.start(Broken(eng), interval=1e-4)
    for _ in range(200):
        if eng.loop_error is not None:
            break
        eng._loop_stop.wait(0.01)
    eng._loop_stop.set()
    eng._loop_thread.join(timeout=30)
    assert not eng._loop_thread.is_alive()
    eng._loop_thread = None
    assert isinstance(eng.loop_error, OSError)
    h = eng.health()
    assert h["state"] == "degraded" and "disk full" in h["reason"]
    assert "loop_error" in eng.stats()


def test_embedding_service_is_the_one_shard_engine(rng):
    g, Y, _ = _data(8, seed=6)
    with pytest.warns(DeprecationWarning):
        svc = EmbeddingService(GraphStore(g, Y, 8), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = ServingEngine(GraphStore(g, Y, 8), device="cpu")
    assert svc.num_shards == 1 and svc.data_dir is None
    assert svc.embedder is svc.shards[0].embedder
    assert torch.equal(svc.Z, eng.Z) and torch.equal(svc.Wv, eng.Wv)
    nodes = rng.integers(0, N, 20)
    assert np.array_equal(svc.query_topk(nodes)[0], eng.query_topk(nodes)[0])
    with pytest.raises(AttributeError, match="per-shard embedders"):
        _port(g, Y, 8, num_shards=2).embedder


@pytest.mark.parametrize("kwargs,match", [
    (dict(transport="socket"), "A.7"),
    (dict(shard_addrs=["localhost:1"]), "A.7"), (dict(replicas=1), "A.7"),
    (dict(replica_addrs=["localhost:1"]), "A.7")])
def test_unported_options_raise(kwargs, match):
    g, Y, _ = _data(8)
    with pytest.raises(NotImplementedError, match=match):
        _port(g, Y, 8, num_shards=2, **kwargs)


def test_unported_paths_raise(tmp_path):
    g, Y, _ = _data(8)
    with pytest.raises(ValueError, match="unknown index mode"):
        _port(g, Y, 8, index="hnsw")
    with pytest.raises(ValueError, match="unknown transport"):
        _port(g, Y, 8, transport="carrier-pigeon")
    eng = _port(g, Y, 8, num_shards=2, data_dir=str(tmp_path / "p"))
    # the ivf query answers (building the index on first use)
    idx, val = eng.query_topk([1, 2], mode="ivf")
    assert idx.shape == (2, 10) and eng.index_mode == "ivf"
    with pytest.raises(ValueError, match="unknown topk mode"):
        eng.query_topk([1, 2], mode="approx")
    eng.enable_index()                        # idempotent: builds once
    assert all(s.index is not None and s.index.builds == 1
               for s in eng.shards)
    with pytest.raises(IndexError):
        eng.query_embed([N])
    with pytest.raises(ValueError):
        eng.apply_label_delta([1, 2], [0])
    assert eng.version == 0                   # rejected before the log
    eng.close()
    with pytest.raises(RuntimeError, match="durable"):
        _port(g, Y, 8).checkpoint()
    # a reference deployment that carries an IVF index opens, index on
    ref = _ref(g, Y, 8, num_shards=2, data_dir=str(tmp_path / "r"),
               index="ivf")
    cent = np.asarray(ref._index_centroids)
    ref.close()
    rec = ServingEngine.open(str(tmp_path / "r"), device="cpu")
    assert rec.index_mode == "ivf"
    assert np.array_equal(rec._index_centroids, cent)
    rec.close()


def test_concurrent_submitters_lose_no_write():
    """16 submitter threads against the flush loop with a short switch
    interval: every write gets its own version, in one sequence with no
    gap, and every read is answered."""
    import sys
    import threading
    g, Y, _ = _data(8, seed=7)
    eng = _port(g, Y, 8, num_shards=2)
    batcher = eng.start(MicroBatcher(eng, topk=3), interval=1e-5)
    versions, errors = [], []
    lock = threading.Lock()

    def submitter(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(10):
                u, v = (r.integers(0, N, 5).astype(np.int32) for _ in "uv")
                w = batcher.submit("insert", (u, v, np.ones(5, np.float32)))
                rd = batcher.submit("topk", r.integers(0, N, 4))
                ver = w.result(timeout=60)
                rd.result(timeout=60)
                with lock:
                    versions.append(ver)
        except Exception as e:         # surfaced by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert not errors and eng.loop_error is None
    assert sorted(versions) == list(range(1, 161))
    assert eng.version == 160 and eng.store.log_edges == 800
