"""repro_torch.core and repro_torch.graph against the JAX package.

Inputs are drawn once with numpy and handed to both packages.  Wv is
held bit-equal (float32 math in both); Z to atol 1e-5 (the JAX suite's
tolerance: summation order is free)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gee as JG
from repro.core import ref_python as JR
from repro.graph import edges as JE
from repro.graph import generators as JGen
from repro.graph.partition import RowPartition as JRowPartition
from repro_torch.core import gee as TG
from repro_torch.core import ref_python as TR
from repro_torch.graph import edges as TE
from repro_torch.graph import generators as TGen
from repro_torch.graph.partition import RowPartition

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _graph(rng, n=120, s=900, K=5, frac=0.3):
    u = rng.integers(0, n, s).astype(np.int32)
    v = rng.integers(0, n, s).astype(np.int32)
    w = (rng.random(s, dtype=np.float32) + 0.5).astype(np.float32)
    Y = np.full(n, -1, np.int32)
    lab = rng.random(n) < frac
    Y[lab] = rng.integers(0, K, lab.sum())
    return u, v, w, Y


class TestGraphCopies:
    @pytest.mark.parametrize("gen,args", [
        ("erdos_renyi", (200, 1000, 3, True)),
        ("powerlaw", (200, 1000, 1.5, 4)),
    ])
    def test_generators_same_arrays(self, gen, args):
        a = getattr(JGen, gen)(*args)
        b = getattr(TGen, gen)(*args)
        for x, y in ((a.u, b.u), (a.v, b.v), (a.w, b.w)):
            assert np.array_equal(x, y) and x.dtype == y.dtype
        assert a.n == b.n

    def test_sbm_same_arrays(self):
        (ga, la), (gb, lb) = JGen.sbm(300, 4, 2000, seed=7), \
            TGen.sbm(300, 4, 2000, seed=7)
        assert np.array_equal(la, lb)
        assert np.array_equal(ga.u, gb.u) and np.array_equal(ga.v, gb.v)

    def test_make_labels_and_chunks(self):
        a = JE.make_labels(100, 4, 0.3, np.random.default_rng(1))
        b = TE.make_labels(100, 4, 0.3, np.random.default_rng(1))
        assert np.array_equal(a, b)
        u = np.arange(700, dtype=np.int32)
        w = np.ones(700, np.float32)
        for ca, cb in zip(JE.chunk_edges(u, u, w, 256),
                          TE.chunk_edges(u, u, w, 256)):
            for x, y in zip(ca, cb):
                assert np.array_equal(x, y)
        assert TE.bucket_size(300) == JE.bucket_size(300) == 512

    @pytest.mark.parametrize("n,p", [(10, 1), (103, 4), (64, 3)])
    def test_row_partition(self, n, p, rng):
        a, b = JRowPartition(n, p), RowPartition(n, p)
        assert a.slices() == b.slices()
        nodes = rng.integers(0, n, 50)
        assert np.array_equal(a.shard_of(nodes), b.shard_of(nodes))
        u, v = rng.integers(0, n, (2, 40)).astype(np.int32)
        w = np.ones(40, np.float32)
        ra = list(a.route_edges(u, v, w))
        rb = list(b.route_edges(u, v, w))
        assert [s for s, _ in ra] == [s for s, _ in rb]
        for (_, x), (_, y) in zip(ra, rb):
            for xa, ya in zip(x, y):
                assert np.array_equal(xa, ya)

    def test_graph_guards(self):
        g = TE.Graph(np.array([0, 5], np.int32), np.array([1, 2], np.int32),
                     np.ones(2, np.float32), 4)
        with pytest.raises(ValueError):
            g.validate()
        g6 = TE.Graph(g.u, g.v, g.w, 6)
        g6.validate()
        assert np.array_equal(g6.degrees(),
                              JE.Graph(g.u, g.v, g.w, 6).degrees())


class TestGee:
    @pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
    def test_make_w_bit_equal(self, rng, frac):
        _, _, _, Y = _graph(rng, frac=frac)
        a = np.asarray(JG.make_w(jnp.asarray(Y), 5))
        b = TG.make_w(_t(Y), 5).numpy()
        assert np.array_equal(a, b)
        assert np.allclose(b, TR.make_w(Y, 5))

    @pytest.mark.parametrize("laplacian", [False, True])
    def test_gee_matches_reference(self, rng, laplacian):
        u, v, w, Y = _graph(rng)
        a = np.asarray(JG.gee(jnp.asarray(u), jnp.asarray(v),
                              jnp.asarray(w), jnp.asarray(Y), K=5, n=120,
                              laplacian=laplacian))
        b = TG.gee(_t(u), _t(v), _t(w), _t(Y), K=5, n=120,
                   laplacian=laplacian).numpy()
        np.testing.assert_allclose(b, a, atol=ATOL)
        if not laplacian:
            np.testing.assert_allclose(b, JR.gee_numpy(u, v, w, Y, 5, 120),
                                       atol=ATOL)
            np.testing.assert_allclose(b, TR.gee_numpy(u, v, w, Y, 5, 120),
                                       atol=ATOL)

    def test_empty_graph_and_unlabeled(self, rng):
        e = np.zeros(0, np.int32)
        Y = np.full(30, -1, np.int32)
        Z = TG.gee(_t(e), _t(e), _t(np.zeros(0, np.float32)), _t(Y), K=3,
                   n=30)
        assert Z.shape == (30, 3) and not Z.any()
        u, v, w, _ = _graph(rng, n=30, s=100)
        Z = TG.gee(_t(u), _t(v), _t(w), _t(Y), K=3, n=30)
        assert not Z.any()                       # all-unlabeled: zeros
        assert np.array_equal(TR.gee_python(u, v, w, Y, 3, 30), Z.numpy())

    @pytest.mark.parametrize("sign", [1.0, -1.0])
    def test_apply_delta_and_streaming(self, rng, sign):
        u, v, w, Y = _graph(rng)
        Wj = JG.make_w(jnp.asarray(Y), 5)
        Wt = TG.make_w(_t(Y), 5)
        Z0 = rng.random((120, 5), dtype=np.float32)
        a = np.asarray(JG.gee_apply_delta(
            jnp.asarray(Z0), jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
            jnp.asarray(Y), Wj, K=5, sign=sign))
        Z0t = _t(Z0)
        b = TG.gee_apply_delta(Z0t, _t(u), _t(v), _t(w), _t(Y), Wt, K=5,
                               sign=sign)
        np.testing.assert_allclose(b.numpy(), a, atol=ATOL)
        assert np.array_equal(Z0t.numpy(), Z0)          # input untouched
        chunks = list(TE.chunk_edges(u, v, w, 256))
        zs = TG.gee_streaming(((_t(x), _t(y), _t(z)) for x, y, z in chunks),
                              _t(Y), K=5, n=120)
        zj = JG.gee_streaming(((jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(z)) for x, y, z in chunks),
                              jnp.asarray(Y), K=5, n=120)
        np.testing.assert_allclose(zs.numpy(), np.asarray(zj), atol=ATOL)

    @pytest.mark.parametrize("lo,hi", [(0, 120), (17, 80), (100, 120)])
    def test_owned_variants(self, rng, lo, hi):
        u, v, w, Y = _graph(rng)
        dst = np.concatenate([u, v])
        src = np.concatenate([v, u])
        wc = np.concatenate([w, w])
        m = (dst >= lo) & (dst < hi)
        rows, src, wc = (dst[m] - lo).astype(np.int32), src[m], wc[m]
        Wj = JG.make_w(jnp.asarray(Y), 5)
        Wt = TG.make_w(_t(Y), 5)
        a = np.asarray(JG.gee_owned(jnp.asarray(rows), jnp.asarray(src),
                                    jnp.asarray(wc), jnp.asarray(Y), Wj,
                                    K=5, n_local=hi - lo))
        b = TG.gee_owned(_t(rows), _t(src), _t(wc), _t(Y), Wt, K=5,
                         n_local=hi - lo)
        np.testing.assert_allclose(b.numpy(), a, atol=ATOL)
        np.testing.assert_allclose(
            b.numpy(), TR.gee_numpy_owned(rows, src, wc, Y, Wt.numpy(), 5,
                                          hi - lo), atol=ATOL)
        d = TG.gee_apply_delta_owned(b, _t(rows), _t(src), _t(wc), _t(Y),
                                     Wt, K=5, sign=-1.0)
        np.testing.assert_allclose(d.numpy(), 0, atol=ATOL)
        chunks = TE.chunk_edges(rows, src, wc, 64)
        s = TG.gee_streaming_owned(((_t(r), _t(x), _t(y))
                                    for r, x, y in chunks), _t(Y), K=5,
                                   n_local=hi - lo)
        np.testing.assert_allclose(s.numpy(), a, atol=ATOL)

    def test_kmeans_refine_round(self, rng):
        Z = rng.random((80, 4), dtype=np.float32)
        labels = rng.integers(0, 4, 80).astype(np.int32)
        Y0 = np.where(rng.random(80) < 0.5, labels, -1).astype(np.int32)
        a = np.asarray(JG.kmeans_refine_round(
            jnp.asarray(Z), jnp.asarray(labels), jnp.asarray(Y0), 4, 3))
        b = TG.kmeans_refine_round(_t(Z), _t(labels), _t(Y0), 4, 3)
        assert b.dtype == torch.int32
        assert np.array_equal(b.numpy(), a)
