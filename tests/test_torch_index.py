"""repro_torch.index (the IVF index) against repro.index, and the IVF
contracts inside the port.

Against the reference, on the same Zn and centroids: identical cell
assignment and cell sizes, top-k by `conftest.topk_equivalent` (the
reference's scores come from XLA's matrix product, the port's from a
fixed-order sum: they may differ in the last bit).  Inside the port the
contracts are held bit for bit: ``nprobe = K`` equals the exact scan for
1, 2 and 4 shards, through the engine and through the batcher (the
reference fails that, `test_index.py::TestEngineIVF`); delta maintenance
equals a rebuild; the churn gate and label rebuilds re-quantize; an
empty cell gives no NaN; nprobe is clamped; recovery and checkpoints
keep the index; WAL INDEX records and ``.engine.json`` cross between the
packages both ways.  Engines run the cuda backend on the CPU (each
kernel's plain version)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import topk_equivalent
from repro.graph.edges import Graph as JGraph
from repro.index import IVFIndex as JIVFIndex
from repro.serving import GraphStore as JStore
from repro.serving import ServingEngine as JEngine
from repro_torch import obs
from repro_torch.graph import erdos_renyi, make_labels, sbm
from repro_torch.index import DEFAULT_NPROBE, IVFIndex
from repro_torch.serving import GraphStore, MicroBatcher, ServingEngine
from repro_torch.serving import queries as Q
from repro_torch.serving import wal as W

K = 5
N = 240


def _graph(seed=0, n=N, s=2400, k=K, frac=0.4):
    g = erdos_renyi(n, s, seed=seed, weighted=True)
    return g, make_labels(n, k, frac, np.random.default_rng(seed))


def _engine(seed=0, **kw):
    g, Y = _graph(seed)
    return ServingEngine(GraphStore(g, Y, K), device="cpu", backend="cuda",
                         **kw)


def _zn(Z):
    return Q.normalize_rows(torch.as_tensor(np.asarray(Z, np.float32)))


def _all_cells(nq):
    return np.tile(np.arange(K, dtype=np.int32), (nq, 1))


def _eq(a, b):
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# -- the index against the reference's ---------------------------------------

@pytest.mark.parametrize("m,offset", [(300, 0), (97, 1000)])
def test_cells_and_answers_match_the_reference(rng, m, offset):
    Zn = _zn(rng.normal(size=(m, K)))
    cent = rng.normal(size=(K, K)).astype(np.float32)
    port, ref = IVFIndex(K=K, row_offset=offset), JIVFIndex(
        K=K, row_offset=offset)
    port.build(Zn, cent)
    jZn = jnp.asarray(Zn.numpy())
    ref.build(jZn, cent)
    assert np.array_equal(port.assign, ref.assign)
    assert np.array_equal(port.cell_sizes(), ref.cell_sizes())
    for a, b in zip(port._members, ref._members):
        assert a.dtype == np.int64 and np.array_equal(a, b)
    nodes = rng.integers(0, m, 16)
    q, jq = Zn[torch.as_tensor(nodes)], jZn[jnp.asarray(nodes)]
    for probe in (_all_cells(16), rng.integers(0, K, (16, 2))):
        pi, pv, ps = port.topk(Zn, q, nodes + offset, probe, k=7)
        ri, rv, rs = ref.topk(jZn, jq, nodes + offset, probe, k=7)
        assert ps == rs
        topk_equivalent(pi, pv, ri, rv)


def test_delta_maintenance_matches_the_reference(rng):
    Z = rng.normal(size=(200, K)).astype(np.float32)
    cent = rng.normal(size=(K, K)).astype(np.float32)
    port, ref = IVFIndex(K=K), JIVFIndex(K=K)
    port.build(_zn(Z), cent)
    ref.build(jnp.asarray(_zn(Z).numpy()), cent)
    for _ in range(3):
        touched = rng.choice(200, size=30, replace=False)
        Z[touched] += rng.normal(size=(30, K)).astype(np.float32)
        Zn = _zn(Z)
        assert port.update_rows(Zn, touched) == ref.update_rows(
            jnp.asarray(Zn.numpy()), touched)
    assert np.array_equal(port.assign, ref.assign)
    assert port.moved_rows == ref.moved_rows


# -- the index alone, inside the port ----------------------------------------

def test_build_partitions_all_rows_in_sorted_lists(rng):
    ix = IVFIndex(K=K)
    ix.build(_zn(rng.normal(size=(100, K))),
             rng.normal(size=(K, K)).astype(np.float32))
    assert int(ix.cell_sizes().sum()) == 100
    seen = np.concatenate(ix._members)
    assert np.array_equal(np.sort(seen), np.arange(100))
    for m in ix._members:
        assert np.array_equal(m, np.sort(m))


def test_full_probe_equals_exact_scan_bitwise(rng):
    """Duplicate rows make ties everywhere: they resolve by ascending
    id in both."""
    base = rng.normal(size=(60, K)).astype(np.float32)
    Zn = _zn(np.repeat(base, 5, axis=0))
    ix = IVFIndex(K=K)
    ix.build(Zn, rng.normal(size=(K, K)).astype(np.float32))
    nodes = rng.integers(0, 300, 20).astype(np.int32)
    q = Zn[torch.as_tensor(nodes).long()]
    ii, iv, scanned = ix.topk(Zn, q, nodes, _all_cells(20), k=10)
    assert scanned == 300 * 20
    _eq((ii, iv), Q.topk_cosine_q(Zn, q, nodes, k=10))


def test_delta_maintenance_equals_rebuild(rng):
    Z = rng.normal(size=(200, K)).astype(np.float32)
    cent = rng.normal(size=(K, K)).astype(np.float32)
    ix = IVFIndex(K=K)
    ix.build(_zn(Z), cent)
    for _ in range(3):
        touched = rng.choice(200, size=30, replace=False)
        Z[touched] += rng.normal(size=(30, K)).astype(np.float32)
        Zn = _zn(Z)
        ix.update_rows(Zn, touched)
    fresh = IVFIndex(K=K)
    fresh.build(Zn, cent)
    assert np.array_equal(ix.assign, fresh.assign)
    for a, b in zip(ix._members, fresh._members):
        assert np.array_equal(a, b)
    nodes = rng.integers(0, 200, 16).astype(np.int32)
    q = Zn[torch.as_tensor(nodes).long()]
    probe = rng.integers(0, K, (16, 2))
    _eq(ix.topk(Zn, q, nodes, probe, k=8)[:2],
        fresh.topk(Zn, q, nodes, probe, k=8)[:2])


def test_empty_cell_gives_no_nan(rng):
    Zn = _zn(rng.normal(size=(40, K)))
    cent = rng.normal(size=(K, K)).astype(np.float32)
    cent[2] = 0.0                 # an unlabelled class: a zero centroid
    ix = IVFIndex(K=K)
    ix.build(Zn, cent)
    assert not torch.isnan(ix._cn).any()
    assert int(ix.cell_sizes().sum()) == 40
    ix._members[2] = np.zeros(0, np.int64)
    nodes = np.arange(3, dtype=np.int32)
    idx, val, scanned = ix.topk(Zn, Zn[:3], nodes,
                                np.full((3, 1), 2, np.int32), k=4)
    assert scanned == 0 and (idx == -1).all()
    assert np.isneginf(val).all() and not np.isnan(val).any()


def test_k_beyond_the_probed_rows_clamps(rng):
    Zn = _zn(rng.normal(size=(30, K)))
    ix = IVFIndex(K=K)
    ix.build(Zn, rng.normal(size=(K, K)).astype(np.float32))
    nodes = np.arange(4, dtype=np.int32)
    probe = ix._assign_cells(Zn[:4])[:, None]
    idx, val, scanned = ix.topk(Zn, Zn[:4], nodes, probe, k=25)
    assert scanned < 30 * 4
    pad = idx == -1
    assert pad.any() and np.isneginf(val[pad]).all()
    assert (val[~pad] > -np.inf).all()


def test_update_rows_counts_moves_and_checks_bounds(rng):
    Zn = _zn(rng.normal(size=(50, K)))
    ix = IVFIndex(K=K)
    ix.build(Zn, rng.normal(size=(K, K)).astype(np.float32))
    assert ix.update_rows(Zn, np.arange(10)) == 0 and ix.churn == 0.0
    with pytest.raises(IndexError):
        ix.update_rows(Zn, np.array([50]))
    with pytest.raises(RuntimeError):
        IVFIndex(K=K).update_rows(Zn, np.array([0]))
    with pytest.raises(ValueError, match="centroids"):
        IVFIndex(K=K).build(Zn, np.zeros((K, K + 1), np.float32))


def test_row_offset_stamps_global_ids(rng):
    Zn = _zn(rng.normal(size=(40, K)))
    ix = IVFIndex(K=K, row_offset=1000)
    ix.build(Zn, rng.normal(size=(K, K)).astype(np.float32))
    nodes = np.array([1005, 1007], np.int32)
    idx, _, _ = ix.topk(Zn, Zn[[5, 7]], nodes, _all_cells(2), k=5)
    real = idx[idx >= 0]
    assert ((real >= 1000) & (real < 1040)).all()
    assert 1005 not in idx[0] and 1007 not in idx[1]


def test_cache_is_keyed_by_the_zn_tensor(rng):
    Zn = _zn(rng.normal(size=(60, K)))
    ix = IVFIndex(K=K)
    ix.build(Zn, rng.normal(size=(K, K)).astype(np.float32))
    ix.topk(Zn, Zn[:2], np.arange(2), _all_cells(2), k=3)
    held = dict(ix._cells_cache)
    ix.topk(Zn, Zn[:2], np.arange(2), _all_cells(2), k=3)
    assert all(ix._cells_cache[c] is held[c] for c in held)
    Zn2 = Zn.clone()
    ix.topk(Zn2, Zn2[:2], np.arange(2), _all_cells(2), k=3)
    assert ix._zn_ref is Zn2 and all(
        ix._cells_cache[c] is not held[c] for c in ix._cells_cache)


# -- through the engine -------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4])
def test_nprobe_K_equals_exact_bitwise(p, rng):
    eng = _engine(seed=4, num_shards=p, index="ivf")
    u = rng.integers(0, N, 300).astype(np.int32)
    v = rng.integers(0, N, 300).astype(np.int32)
    eng.apply_edge_delta(u, v, rng.random(300, dtype=np.float32) + 0.5)
    nodes = rng.integers(0, N, 40).astype(np.int32)
    _eq(eng.query_topk(nodes, k=10, mode="exact"),
        eng.query_topk(nodes, k=10, mode="ivf", nprobe=K))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_ivf_answers_do_not_depend_on_the_shard_count(p, rng):
    """Same centroids, same Z: the probed answer is the same bits for
    every shard count (each shard scores the same probed cells)."""
    one = _engine(seed=9, index="ivf")
    many = _engine(seed=9, num_shards=p)
    many._build_index(one._index_centroids)
    many.index_mode = "ivf"
    nodes = rng.integers(0, N, 32).astype(np.int32)
    _eq(one.query_topk(nodes, k=10, mode="ivf", nprobe=2),
        many.query_topk(nodes, k=10, mode="ivf", nprobe=2))


def test_batcher_routes_ivf_mode(rng):
    eng = _engine(num_shards=2, index="ivf")
    b = MicroBatcher(eng, topk=10, topk_mode="ivf", topk_nprobe=K)
    nodes = rng.integers(0, N, 12).astype(np.int32)
    t = b.submit("topk", nodes)
    b.flush()
    _eq(t.result(timeout=10), eng.query_topk(nodes, k=10, mode="exact"))


def test_lazy_enable_on_first_ivf_query():
    eng = _engine()
    assert eng.index_mode is None and eng.shards[0].index is None
    eng.query_topk(np.array([0, 1], np.int32), mode="ivf")
    assert eng.index_mode == "ivf" and eng.shards[0].index is not None


def test_engine_delta_maintenance_equals_rebuild(rng):
    eng = _engine(seed=6, num_shards=2, index="ivf")
    cent = eng._index_centroids.copy()
    for _ in range(2):
        u = rng.integers(0, N, 150).astype(np.int32)
        v = rng.integers(0, N, 150).astype(np.int32)
        eng.apply_edge_delta(u, v, rng.random(150, dtype=np.float32) + 0.5)
    nodes = rng.integers(0, N, 24).astype(np.int32)
    maintained = eng.query_topk(nodes, k=10, mode="ivf", nprobe=2)
    assigns = [s.index.assign.copy() for s in eng.shards]
    eng._build_index(cent, record=False)
    for a, s in zip(assigns, eng.shards):
        assert np.array_equal(a, s.index.assign)
    _eq(maintained, eng.query_topk(nodes, k=10, mode="ivf", nprobe=2))


def test_churn_gate_requantizes():
    eng = _engine(index="ivf", index_churn=0.25)
    eng._index_moved = eng.n             # saturate the drift signal
    before = eng.requantizes
    eng.apply_edge_delta(np.array([0], np.int32), np.array([1], np.int32),
                         np.ones(1, np.float32))
    assert eng.requantizes == before + 1 and eng._index_moved == 0


def test_label_churn_rebuild_requantizes(rng):
    eng = _engine(index="ivf", rebuild_churn=0.0)
    before = eng.requantizes
    eng.apply_label_delta(rng.integers(0, N, 30).astype(np.int64),
                          np.full(30, 2, np.int32))
    assert eng.rebuilds >= 1 and eng.requantizes == before + 1


def test_recall_on_a_separated_sbm(rng):
    n, k = 1200, 4
    g, truth = sbm(n, k, 18_000, p_in=0.95, seed=11)
    Y = make_labels(n, k, 0.5, rng, true_labels=truth)
    eng = ServingEngine(GraphStore(g, Y, k), device="cpu", backend="cuda",
                        index="ivf")
    nodes = rng.integers(0, n, 64).astype(np.int32)
    ei, ev = eng.query_topk(nodes, k=10, mode="exact")
    _eq((ei, ev), eng.query_topk(nodes, k=10, mode="ivf", nprobe=k))
    ii, _ = eng.query_topk(nodes, k=10, mode="ivf", nprobe=2)
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                      for a, b in zip(ei, ii)])
    assert recall >= 0.9


def test_nprobe_is_clamped(rng):
    eng = _engine(index="ivf")
    nodes = rng.integers(0, N, 8).astype(np.int32)
    _eq(eng.query_topk(nodes, k=5, mode="ivf", nprobe=999),
        eng.query_topk(nodes, k=5, mode="exact"))
    lo = eng.query_topk(nodes, k=5, mode="ivf", nprobe=0)
    assert lo[0].shape == (8, 5)
    assert eng._probe_cells(eng.shards[0].normalized()[:3], 0).shape == (
        3, 1)
    assert eng._probe_cells(eng.shards[0].normalized()[:3], 99).shape == (
        3, K)


def test_stats_index_section_and_metrics(rng):
    obs.reset()
    eng = _engine(num_shards=2, index="ivf")
    eng.query_topk(rng.integers(0, N, 16).astype(np.int32), k=10,
                   mode="ivf")
    s = eng.stats()["index"]
    assert s["mode"] == "ivf" and s["nprobe"] == DEFAULT_NPROBE
    assert s["requantizes"] == 0 and len(s["cell_sizes"]) == 2
    assert sum(sum(c) for c in s["cell_sizes"]) == eng.n
    snap = obs.snapshot(prefix="repro_index")
    names = {c.split("{")[0] for c in snap["counters"]}
    assert {"repro_index_builds_total", "repro_index_queries_total",
            "repro_index_rows_scanned_total"} <= names


# -- durability ---------------------------------------------------------------

def test_recovery_answers_identically(tmp_path, rng):
    d = str(tmp_path / "dep")
    eng = _engine(seed=13, data_dir=d, num_shards=2, index="ivf", nprobe=2)
    for _ in range(3):
        u = rng.integers(0, N, 150).astype(np.int32)
        v = rng.integers(0, N, 150).astype(np.int32)
        eng.apply_edge_delta(u, v, rng.random(150, dtype=np.float32) + 0.5)
    eng.refresh()                        # a freshly built pre-crash Z
    nodes = rng.integers(0, N, 32).astype(np.int32)
    pre = eng.query_topk(nodes, k=10, mode="ivf")
    sizes = [s.index.cell_sizes() for s in eng.shards]
    rec = ServingEngine.open(d, num_shards=2, device="cpu", backend="cuda")
    assert rec.index_mode == "ivf" and rec.nprobe == 2
    assert np.array_equal(rec._index_centroids, eng._index_centroids)
    for a, s in zip(sizes, rec.shards):
        assert np.array_equal(a, s.index.cell_sizes())
    _eq(pre, rec.query_topk(nodes, k=10, mode="ivf"))


def test_live_requantize_survives_recovery(tmp_path, rng):
    """A churn re-quantization appends an INDEX record; the replay
    restores those centroids, not the boot ones."""
    d = str(tmp_path / "dep")
    eng = _engine(seed=17, data_dir=d, index="ivf")
    boot = eng._index_centroids.copy()
    eng._index_moved = eng.n
    u = rng.integers(0, N, 100).astype(np.int32)
    v = rng.integers(0, N, 100).astype(np.int32)
    eng.apply_edge_delta(u, v, np.ones(100, np.float32))
    assert eng.requantizes == 1
    assert not np.array_equal(eng._index_centroids, boot)
    kinds = [r.kind for r in W.read_wal(f"{d}/wal-0.log")]
    assert kinds.count(W.INDEX) == 1
    rec = ServingEngine.open(d, device="cpu", backend="cuda")
    assert np.array_equal(rec._index_centroids, eng._index_centroids)
    assert rec.requantizes == 0
    nodes = rng.integers(0, N, 16).astype(np.int32)
    _eq(rec.query_topk(nodes, k=10, mode="ivf", nprobe=K),
        rec.query_topk(nodes, k=10, mode="exact"))


def test_checkpoint_persists_the_index(tmp_path, rng):
    d = tmp_path / "dep"
    eng = _engine(seed=19, data_dir=str(d), index="ivf", nprobe=3,
                  index_churn=0.5)
    eng.apply_edge_delta(rng.integers(0, N, 50).astype(np.int32),
                         rng.integers(0, N, 50).astype(np.int32),
                         np.ones(50, np.float32))
    eng.checkpoint()
    nodes = rng.integers(0, N, 16).astype(np.int32)
    pre = eng.query_topk(nodes, k=10, mode="ivf")
    meta = json.loads((d / "snap-1.engine.json").read_text())["index"]
    assert meta["mode"] == "ivf" and meta["nprobe"] == 3
    assert meta["requantizes"] == eng.requantizes == 1
    rec = ServingEngine.open(str(d), device="cpu", backend="cuda")
    assert rec.index_mode == "ivf" and rec.nprobe == 3
    assert rec.index_churn == 0.5 and rec.requantizes == 1
    assert np.array_equal(rec._index_centroids, eng._index_centroids)
    _eq(pre, rec.query_topk(nodes, k=10, mode="ivf"))


def _jref(seed, **kw):
    g, Y = _graph(seed)
    return JEngine(JStore(JGraph(g.u, g.v, g.w, g.n), Y, K),
                   plan_cache=None, **kw)


def test_reference_deployment_with_an_index_opens_in_the_port(tmp_path,
                                                               rng):
    d = str(tmp_path / "ref")
    ref = _jref(21, data_dir=d, num_shards=2, index="ivf", nprobe=2)
    ref._index_moved = ref.n                 # a live INDEX record
    u = rng.integers(0, N, 80).astype(np.int32)
    v = rng.integers(0, N, 80).astype(np.int32)
    ref.apply_edge_delta(u, v, np.ones(80, np.float32))
    assert ref.requantizes == 1
    nodes = rng.integers(0, N, 16).astype(np.int32)
    want = ref.query_topk(nodes, k=10, mode="exact")
    cent = np.asarray(ref._index_centroids)
    ref.close()
    rec = ServingEngine.open(d, device="cpu", backend="cuda")
    assert rec.index_mode == "ivf" and rec.nprobe == 2
    assert np.array_equal(rec._index_centroids, cent)
    got = rec.query_topk(nodes, k=10, mode="ivf", nprobe=K)
    _eq(got, rec.query_topk(nodes, k=10, mode="exact"))
    topk_equivalent(got[0], got[1], want[0], want[1])


def test_port_deployment_with_an_index_opens_in_the_reference(tmp_path,
                                                               rng):
    """Both carriers of the quantizer: a WAL INDEX record (a live
    re-quantization, replayed by the reference), then `.engine.json`
    (a checkpoint)."""
    d = str(tmp_path / "port")
    eng = _engine(seed=23, data_dir=d, num_shards=2, index="ivf",
                  nprobe=3)
    eng._index_moved = eng.n                 # a live INDEX record
    eng.apply_edge_delta(rng.integers(0, N, 80).astype(np.int32),
                         rng.integers(0, N, 80).astype(np.int32),
                         np.ones(80, np.float32))
    assert eng.requantizes == 1
    nodes = rng.integers(0, N, 16).astype(np.int32)
    want = eng.query_topk(nodes, k=10, mode="exact")
    cent = eng._index_centroids.copy()
    eng.close()
    ref = JEngine.open(d, plan_cache=None)   # replays the WAL record
    assert ref.index_mode == "ivf" and ref.nprobe == 3
    assert np.array_equal(np.asarray(ref._index_centroids), cent)
    got = ref.query_topk(nodes, k=10, mode="exact")
    topk_equivalent(got[0], got[1], want[0], want[1], atol=1e-4)
    ref.close()
    eng = ServingEngine.open(d, device="cpu", backend="cuda")
    eng.checkpoint()                         # .engine.json carries it
    cent = eng._index_centroids.copy()
    eng.close()
    ref = JEngine.open(d, plan_cache=None)
    assert ref.index_mode == "ivf" and ref.nprobe == 3
    assert ref.requantizes == 1              # the checkpoint's, stored
    assert np.array_equal(np.asarray(ref._index_centroids), cent)
    ref.close()


def test_wal_index_record_roundtrip(tmp_path):
    path = str(tmp_path / "wal.log")
    cent = np.arange(K * K, dtype=np.float32).reshape(K, K)
    w = W.WriteAheadLog(path)
    w.open()
    w.append_index(7, cent)
    w.close()
    [rec] = list(W.read_wal(path))
    assert rec.kind == W.INDEX and rec.version == 7
    assert np.array_equal(np.asarray(rec.a).reshape(K, K), cent)
