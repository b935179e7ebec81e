"""repro_torch.encoder.Embedder against the JAX Embedder.

Each port backend is paired with its reference counterpart (numpy ->
numpy, torch -> xla, cuda -> pallas in interpret mode, streaming ->
streaming) on the same numpy inputs, unpartitioned and under a row
partition.  Z atol 1e-5, Zn atol 1e-6, Wv and labels exact."""
import numpy as np
import pytest
import torch

from repro.encoder import Embedder as JEmbedder
from repro.encoder import EncoderConfig as JConfig
from repro.graph.edges import Graph as JGraph
from repro_torch.encoder import Embedder, EncoderConfig, NotFittedError
from repro_torch.encoder import backends as TB
from repro_torch.graph import Graph, erdos_renyi, make_labels
from repro_torch.serving import queries as Q

PAIRS = [("numpy", "numpy"), ("torch", "xla"), ("cuda", "pallas"),
         ("streaming", "streaming")]
GEOM = dict(tile_n=64, edge_block=128, chunk_size=700)


def _data(n=220, s=1800, K=5, seed=3):
    g = erdos_renyi(n, s, seed=seed, weighted=True)
    Y = make_labels(n, K, 0.3, np.random.default_rng(seed))
    return g, Y


def _jg(g):
    return JGraph(g.u, g.v, g.w, g.n)


def _pair(port, ref, K=5, **cfg):
    t = Embedder(EncoderConfig(K=K, **GEOM, **cfg), backend=port,
                 device="cpu")
    j = JEmbedder(JConfig(K=K, **GEOM, **cfg), backend=ref, plan_cache=None)
    return t, j


def _delta(rng, n, s=40):
    return Graph(rng.integers(0, n, s).astype(np.int32),
                 rng.integers(0, n, s).astype(np.int32),
                 rng.random(s, dtype=np.float32) + 0.5, n)


class TestFit:
    @pytest.mark.parametrize("rp", [None, (37, 150), (150, 220)])
    @pytest.mark.parametrize("port,ref", PAIRS)
    def test_backend_matches_reference(self, port, ref, rp):
        g, Y = _data()
        t, j = _pair(port, ref, row_partition=rp)
        t.fit(g, Y)
        j.fit(_jg(g), Y)
        assert t.Z_.shape == tuple(j.Z_.shape)
        np.testing.assert_allclose(t.transform(), j.transform(), atol=1e-5)
        assert np.array_equal(t.Wv_.numpy(), np.asarray(j.Wv_))
        assert np.array_equal(t.labels_, j.labels_)

    @pytest.mark.parametrize("port,ref", [("torch", "xla"),
                                          ("cuda", "pallas")])
    def test_laplacian(self, port, ref):
        g, Y = _data(seed=5)
        t, j = _pair(port, ref, laplacian=True)
        np.testing.assert_allclose(t.fit(g, Y).transform(),
                                   j.fit(_jg(g), Y).transform(), atol=1e-5)

    def test_refit_reuses_plan_and_predict(self):
        g, Y = _data()
        t, j = _pair("cuda", "pallas")
        t.fit(g, Y)
        Y2 = make_labels(g.n, 5, 0.5, np.random.default_rng(9))
        t.refit(Y2)
        j.fit(_jg(g), Y2)
        assert t.plan_stats == {"built": 1, "hits": 1, "disk_hits": 0,
                            "disk_stores": 0}
        np.testing.assert_allclose(t.transform(), j.transform(), atol=1e-5)
        nodes = np.arange(0, g.n, 3)
        assert np.array_equal(t.predict(nodes), j.predict(nodes))
        np.testing.assert_allclose(t.transform(nodes), j.transform(nodes),
                                   atol=1e-5)

    def test_cuda_bit_identical_across_runs(self):
        g, Y = _data()
        cfg = EncoderConfig(K=5, row_partition=(40, 173), **GEOM)
        a = Embedder(cfg, backend="cuda", device="cpu").fit(g, Y).Z_
        b = Embedder(cfg, backend="cuda", device="cpu").fit(g, Y).Z_
        assert torch.equal(a, b)

    def test_empty_partition_slice(self):
        rng = np.random.default_rng(5)
        g = Graph(rng.integers(0, 10, 80).astype(np.int32),
                  rng.integers(0, 10, 80).astype(np.int32),
                  np.ones(80, np.float32), 100)
        Y = make_labels(100, 4, 0.5, rng)
        for b in ("numpy", "torch", "cuda", "streaming"):
            e = Embedder(EncoderConfig(K=4, row_partition=(50, 60), **GEOM),
                         backend=b, device="cpu").fit(g, Y)
            assert e.Z_.shape == (10, 4) and not e.Z_.any()


class TestDeltas:
    @pytest.mark.parametrize("rp", [None, (40, 173)])
    @pytest.mark.parametrize("port,ref", [("torch", "xla"),
                                          ("cuda", "pallas")])
    def test_partial_fit(self, port, ref, rp, rng):
        g, Y = _data()
        t, j = _pair(port, ref, row_partition=rp)
        t.fit(g, Y)
        j.fit(_jg(g), Y)
        for sign in (1.0, -1.0):
            d = _delta(rng, g.n)
            t.partial_fit(d, sign=sign)
            j.partial_fit(_jg(d), sign=sign)
        np.testing.assert_allclose(t.transform(), j.transform(), atol=1e-5)

    @pytest.mark.parametrize("rp", [None, (40, 173)])
    def test_partial_fit_norm(self, rp, rng):
        g, Y = _data()
        t, j = _pair("cuda", "pallas", row_partition=rp)
        t.fit(g, Y)
        j.fit(_jg(g), Y)
        d = _delta(rng, g.n)
        Zn_t = t.partial_fit_norm(d)
        Zn_j = j.partial_fit_norm(_jg(d))
        np.testing.assert_allclose(t.transform(), j.transform(), atol=1e-5)
        np.testing.assert_allclose(Zn_t.numpy(), np.asarray(Zn_j),
                                   atol=1e-6)
        assert torch.equal(Zn_t, Q.normalize_rows(t.Z_))
        Z1 = t.Z_.clone()
        t.partial_fit_norm(d, sign=-1.0)
        t.partial_fit_norm(d)
        np.testing.assert_allclose(t.Z_.numpy(), Z1.numpy(), atol=1e-5)

    def test_guards(self, rng):
        g, Y = _data()
        e = Embedder(EncoderConfig(K=5, **GEOM), backend="cuda",
                     device="cpu")
        d = _delta(rng, g.n, 3)
        with pytest.raises(NotFittedError):
            e.partial_fit_norm(d)
        e.fit(g, Y)
        e.partial_fit_norm(d)
        with pytest.raises(RuntimeError, match="partial_fit"):
            e.refit(Y)
        with pytest.raises(ValueError, match="n="):
            e.partial_fit(_delta(rng, g.n + 1, 3))
        lap = Embedder(EncoderConfig(K=5, laplacian=True), backend="torch",
                       device="cpu").fit(g, Y)
        with pytest.raises(ValueError, match="laplacian"):
            lap.partial_fit(d)
        with pytest.raises(ValueError, match="label"):
            e.fit(g, np.full(g.n, 5, np.int32))
        with pytest.raises(IndexError):
            e.transform(np.array([g.n]))


class TestRefineAndState:
    @pytest.mark.parametrize("port,ref", [("torch", "xla"),
                                          ("cuda", "pallas")])
    def test_refine_fully_labeled(self, port, ref):
        """All labels supervised: refinement keeps them pinned, so no
        random stream is compared, only the math."""
        g, _ = _data()
        Y0 = np.random.default_rng(2).integers(0, 5, g.n).astype(np.int32)
        t, j = _pair(port, ref, refine_iters=2, kmeans_iters=2)
        t.fit(g, Y0).refine()
        j.fit(_jg(g), Y0).refine()
        assert np.array_equal(t.labels_, j.labels_)
        assert np.array_equal(t.labels_, Y0)
        np.testing.assert_allclose(t.transform(), j.transform(), atol=1e-5)

    def test_refine_bootstraps_unknowns(self):
        g, Y = _data()
        e = Embedder(EncoderConfig(K=5, refine_iters=2, **GEOM),
                     backend="cuda", device="cpu").fit(g, Y)
        e.refine(seed=1)
        assert (e.labels_ >= 0).all()
        assert np.array_equal(e.labels_[Y >= 0], Y[Y >= 0])

    @pytest.mark.parametrize("rp", [None, (40, 173)])
    def test_load_state_then_delta(self, rp, rng):
        """Fit in JAX, carry (Z_, labels_, Wv_) over, apply the same
        delta in both packages."""
        g, Y = _data()
        j = JEmbedder(JConfig(K=5, row_partition=rp, **GEOM),
                      backend="pallas", plan_cache=None).fit(_jg(g), Y)
        t = Embedder(EncoderConfig(K=5, row_partition=rp, **GEOM),
                     backend="cuda", device="cpu")
        t.load_state(g, Z=np.asarray(j.Z_), labels=j.labels_,
                     Wv=np.asarray(j.Wv_))
        d = _delta(rng, g.n)
        Zn_t = t.partial_fit_norm(d)
        Zn_j = j.partial_fit_norm(_jg(d))
        np.testing.assert_allclose(t.transform(), j.transform(), atol=1e-5)
        np.testing.assert_allclose(Zn_t.numpy(), np.asarray(Zn_j),
                                   atol=1e-6)
        with pytest.raises(ValueError, match="shape"):
            t.load_state(g, Z=np.zeros((3, 5)), labels=Y,
                         Wv=np.asarray(j.Wv_))


class TestBackendPolicy:
    def test_auto_resolution_order(self):
        r = TB.resolve_auto
        assert r(100, 1000, device_kind="cpu") == "torch"
        assert r(100, 1000, device_kind="cuda", device_count=1) == "cuda"
        assert r(100, TB.AUTO_STREAMING_EDGES, device_kind="cuda",
                 device_count=1) == "streaming"
        assert r(100, 1000, device_kind="cuda",
                 device_count=2) == "distributed:reduce_scatter"
        assert r(100, 1000, device_kind="cpu",
                 device_count=4) == "distributed:reduce_scatter"
        # the name the multi-rank rule gives is a backend (a 2-rank world
        # fits through it in tests/test_torch_distributed.py)
        be = TB.get_backend("distributed:reduce_scatter")
        assert be.mode == "reduce_scatter" and be.exact
        assert not be.supports_row_partition
        assert TB.list_backends() == [
            "cuda", "distributed:a2a", "distributed:reduce_scatter",
            "distributed:replicated", "distributed:ring", "numpy",
            "streaming", "torch"]
        with pytest.raises(KeyError, match="unknown backend"):
            TB.get_backend("distributed:tree")

    def test_auto_embedder_on_cpu(self):
        g, Y = _data()
        e = Embedder(EncoderConfig(K=5), device="cpu").fit(g, Y)
        assert e.backend.name == "torch"

    def test_cuda_device_without_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            Embedder(EncoderConfig(K=3))
        with pytest.raises(RuntimeError, match="is_available"):
            Embedder(EncoderConfig(K=3), device="cuda:0")

    def test_config_guards(self):
        with pytest.raises(ValueError):
            EncoderConfig(K=0)
        with pytest.raises(ValueError, match="row_partition"):
            EncoderConfig(K=2, row_partition=(5, 5))
        assert EncoderConfig(K=2, row_partition=[1, 4]).row_partition == \
            (1, 4)
