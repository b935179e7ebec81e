"""repro_torch.graph: fingerprints, graph files and sources against the
JAX package's numpy-only modules.

Digests are compared inside one process, so both packages hash with the
same function (xxh3-128 where `xxhash` imports, blake2b otherwise).
Files cross between the packages in both directions."""
import numpy as np
import pytest

import repro.graph.edges as JE
import repro.graph.io as JIO
import repro.graph.sources as JS
from repro.serving.store import GraphStore as JStore
from repro_torch.graph import edges as E
from repro_torch.graph import generators as G
from repro_torch.graph import io as IO
from repro_torch.graph import sources as S
from repro_torch.serving.store import GraphStore

N, SE = 2000, 40_000


def _graph(seed=0, weighted=True):
    return G.erdos_renyi(N, SE, seed=seed, weighted=weighted)


def _jgraph(g):
    return JE.Graph(g.u, g.v, g.w, g.n)


def _same_graph(a, b):
    assert a.n == b.n
    for x, y in ((a.u, b.u), (a.v, b.v), (a.w, b.w)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(x, y)


class TestFingerprints:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_edge_fingerprint_equals_reference(self, seed):
        g = _graph(seed)
        fp = E.edge_fingerprint(g.n, g.u, g.v, g.w)
        assert fp == JE.edge_fingerprint(g.n, g.u, g.v, g.w)
        assert g.fingerprint() == fp == _jgraph(g).fingerprint()
        assert len(fp) == 32

    def test_dtype_and_layout_do_not_matter(self):
        g = _graph()
        fp = E.edge_fingerprint(g.n, g.u.astype(np.int64),
                                g.v.astype(np.int64),
                                g.w.astype(np.float64))
        assert fp == g.fingerprint()
        assert fp != E.edge_fingerprint(g.n + 1, g.u, g.v, g.w)

    @pytest.mark.parametrize("chunk", [1, 777, 40_000])
    def test_accumulator_is_chunking_invariant(self, chunk):
        g = _graph()
        acc, jacc = E.FingerprintAccumulator(N), JE.FingerprintAccumulator(N)
        for off in range(0, SE, chunk):
            sl = slice(off, off + chunk)
            acc.update(g.u[sl], g.v[sl], g.w[sl])
            jacc.update(g.u[sl], g.v[sl], g.w[sl])
        assert acc.digest() == jacc.digest() == g.fingerprint()

    def test_chained_fingerprints_equal_reference(self, rng):
        g = _graph()
        fp = jfp = g.fingerprint()
        for _ in range(5):
            b = int(rng.integers(0, 300))
            u, v = (rng.integers(0, N, b).astype(np.int32) for _ in "uv")
            w = rng.random(b, dtype=np.float32) - np.float32(0.5)
            fp = E.extend_fingerprint(fp, u, v, w)
            jfp = JE.extend_fingerprint(jfp, u, v, w)
            assert fp == jfp
        assert fp != g.fingerprint()

    def test_stamped_fingerprint_is_not_recomputed(self):
        g = _graph()
        g._fp = "ab" * 16
        assert g.fingerprint() == "ab" * 16


class TestGraphFiles:
    @pytest.mark.parametrize("compressed", [True, False])
    def test_port_file_loads_in_reference(self, tmp_path, compressed):
        g = _graph()
        path = str(tmp_path / "g.npz")
        IO.save_graph(path, g, compressed=compressed)
        _same_graph(JIO.load_graph(path), g)
        assert JIO.is_mmapable(path) == (not compressed)

    @pytest.mark.parametrize("compressed", [True, False])
    def test_reference_file_loads_in_port(self, tmp_path, compressed):
        g = _graph(3)
        path = str(tmp_path / "g.npz")
        JIO.save_graph(path, _jgraph(g), compressed=compressed)
        _same_graph(IO.load_graph(path), g)
        assert IO.is_mmapable(path) == (not compressed)

    @pytest.mark.parametrize("compressed", [True, False])
    @pytest.mark.parametrize("hosts,chunk", [(1, 1 << 22), (3, 4096),
                                             (4, 999)])
    def test_sharded_reader_chunks_equal_reference(self, tmp_path,
                                                   compressed, hosts,
                                                   chunk):
        g = _graph(5)
        path = str(tmp_path / "g.npz")
        IO.save_graph(path, g, compressed=compressed)
        seen = []
        for h in range(hosts):
            mine = list(IO.ShardedEdgeReader(path, h, hosts,
                                             chunk_size=chunk))
            ref = list(JIO.ShardedEdgeReader(path, h, hosts,
                                             chunk_size=chunk))
            assert len(mine) == len(ref)
            for a, b in zip(mine, ref):
                _same_graph(a, b)
                assert a.s <= chunk
            seen += mine
        whole = E.Graph(*(np.concatenate([getattr(c, k) for c in seen])
                          for k in "uvw"), N)
        _same_graph(whole, g)

    def test_mmap_refuses_a_compressed_file(self, tmp_path):
        path = str(tmp_path / "g.npz")
        IO.save_graph(path, _graph())
        reader = IO.ShardedEdgeReader(path, 0, 1, mmap=True)
        with pytest.raises(ValueError, match="compressed"):
            list(reader)


class TestSources:
    def test_registry_equals_reference(self):
        assert S.list_sources() == JS.list_sources()
        with pytest.raises(KeyError, match="unknown graph source"):
            S.get_source("nope")

    @pytest.mark.parametrize("kind,params", [
        ("erdos_renyi", dict(n=N, s=SE, seed=1, weighted=True)),
        ("sbm", dict(n=N, K=8, s=SE, seed=2)),
        ("powerlaw", dict(n=N, s=SE, alpha=1.2, seed=3))])
    def test_synthetic_source_equals_reference(self, kind, params):
        src = S.get_source("synthetic", kind=kind, **params)
        ref = JS.get_source("synthetic", kind=kind, **params)
        assert src.fingerprint() == ref.fingerprint()
        assert src.fingerprint().startswith("syn-")
        _same_graph(src.graph(), ref.graph())
        assert src.graph().fingerprint() == src.fingerprint()
        if kind == "sbm":
            assert np.array_equal(src.labels, ref.labels)

    def test_unknown_generator_raises(self):
        with pytest.raises(KeyError, match="unknown generator"):
            S.SyntheticSource("nope", n=3)

    def test_snapshot_and_sharded_sources_equal_reference(self, tmp_path):
        g = _graph(7)
        path = str(tmp_path / "g.npz")
        IO.save_graph(path, g)
        snap = S.get_source("snapshot", path=path)
        assert snap.fingerprint() == JS.SnapshotSource(path).fingerprint()
        assert snap.fingerprint() == g.fingerprint()
        shard = S.get_source("sharded", path=path, chunk_size=5000)
        jshard = JS.ShardedSource(path, chunk_size=5000)
        assert shard.fingerprint() == jshard.fingerprint() == \
            g.fingerprint()
        _same_graph(shard.graph(), g)
        part = S.ShardedSource(path, host_id=1, num_hosts=3)
        jpart = JS.ShardedSource(path, host_id=1, num_hosts=3)
        assert part.fingerprint() == jpart.fingerprint()
        _same_graph(part.graph(), jpart.graph())
        assert sum(c.s for c in part.chunks()) == part.graph().s

    def test_store_source_and_as_graph(self, rng):
        g = _graph(8)
        Y = E.make_labels(N, 8, 0.2, np.random.default_rng(0))
        store, jstore = GraphStore(g, Y, 8), JStore(_jgraph(g), Y, 8)
        for _ in range(3):
            u, v = (rng.integers(0, N, 50).astype(np.int32) for _ in "uv")
            w = rng.random(50, dtype=np.float32)
            store.apply_edges(u, v, w)
            jstore.apply_edges(u, v, w)
        src, jsrc = S.StoreSource(store), JS.StoreSource(jstore)
        assert src.fingerprint() == jsrc.fingerprint()
        assert src.graph().fingerprint() == src.fingerprint()
        _same_graph(S.as_graph(src), jsrc.graph())
        assert S.as_graph(g) is g
        with pytest.raises(TypeError, match="GraphSource"):
            S.as_graph(object())
