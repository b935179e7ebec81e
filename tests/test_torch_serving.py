"""repro_torch.serving: shards and queries.

Across packages (port `backend="cuda"` shards on the CPU vs JAX
`backend="pallas"` shards in interpret mode) Z is held to atol 1e-5 and
top-k to `conftest.topk_equivalent`.  Inside the port the JAX package's
own contracts hold bit for bit: the same answer for every block size,
for p in {1, 2, 4} slices per slice and merged, and fused vs blocked."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import topk_equivalent
from repro.graph.edges import Graph as JGraph
from repro.serving import queries as JQ
from repro.serving.shard import EmbeddingShard as JShard
from repro_torch.graph import Graph, RowPartition, erdos_renyi, make_labels
from repro_torch.serving import EmbeddingShard
from repro_torch.serving import queries as Q

N, S, K = 240, 2400, 6


def _jg(g):
    return JGraph(g.u, g.v, g.w, g.n)


def _data(seed=4):
    g = erdos_renyi(N, S, seed=seed, weighted=True)
    return g, make_labels(N, K, 0.4, np.random.default_rng(seed))


def _serve(shards, part, nodes, k):
    """Gather + normalize the query rows, scatter to every shard, merge."""
    rows = torch.zeros((len(nodes), K))
    for i, idx in part.route_nodes(nodes):
        rows[torch.as_tensor(idx)] = shards[i].rows(nodes[idx])
    q = Q.normalize_rows(rows)
    parts = [s.topk_candidates(q, nodes, k=k) for s in shards]
    return Q.merge_topk([p[0] for p in parts], [p[1] for p in parts], k=k), q


class TestShardsAgainstReference:
    @pytest.mark.parametrize("p", [1, 2, 4])
    def test_after_delta(self, p, rng):
        g, Y = _data()
        part = RowPartition(N, p)
        port = [EmbeddingShard(i, lo, hi, K=K, n=N, backend="cuda",
                               device="cpu")
                for i, (lo, hi) in enumerate(part.slices())]
        ref = [JShard(i, lo, hi, K=K, n=N, backend="pallas",
                      plan_cache=None)
               for i, (lo, hi) in enumerate(part.slices())]
        for i, sub in part.route_graph(g):
            port[i].build(sub, Y)
            ref[i].build(_jg(sub), Y)
        d = Graph(rng.integers(0, N, 100).astype(np.int32),
                  rng.integers(0, N, 100).astype(np.int32),
                  rng.random(100, dtype=np.float32) + 0.5, N)
        for i, sub in part.route_graph(d):
            port[i].apply_delta(sub)
            ref[i].apply_delta(_jg(sub))
        for a, b in zip(port, ref):
            np.testing.assert_allclose(a.Z_owned.numpy(),
                                       np.asarray(b.Z_owned), atol=1e-5)
            np.testing.assert_allclose(a.normalized().numpy(),
                                       np.asarray(b.normalized()),
                                       atol=1e-6)
        nodes = rng.integers(0, N, 24).astype(np.int32)
        (ti, tv), q = _serve(port, part, nodes, 8)
        jparts = [s.topk_candidates(jnp.asarray(q.numpy()), nodes, k=8,
                                    block_rows=64) for s in ref]
        ji, jv = JQ.merge_topk([x[0] for x in jparts],
                               [x[1] for x in jparts], k=8)
        topk_equivalent(ti, tv, ji, jv)

    def test_cold_and_warm_fused_agree(self, rng):
        g, Y = _data()
        sh = EmbeddingShard(0, 60, 200, K=K, n=N, backend="cuda",
                            device="cpu")
        sh.build(g, Y)
        q = Q.normalize_rows(sh.rows(np.arange(60, 72)))
        nodes = np.arange(60, 72, dtype=np.int32)
        cold = sh.topk_candidates(q, nodes, k=7)      # normalizes in flight
        warm = sh.topk_candidates(q, nodes, k=7)      # cached Zn
        assert all(np.array_equal(a, b) for a, b in zip(cold, warm))
        blocked = Q.topk_cosine_q(Q.normalize_rows(sh.Z_owned), q, nodes,
                                  k=7, block_rows=16, row_offset=60)
        assert all(np.array_equal(a, b) for a, b in zip(cold, blocked))
        with pytest.raises(IndexError):
            sh.rows(np.array([59]))
        assert sh.accumulator_nbytes == 140 * K * 4

    def test_class_stats_and_predict(self, rng):
        g, Y = _data()
        sh = EmbeddingShard(0, 0, N, K=K, n=N, backend="torch",
                            device="cpu")
        sh.build(g, Y)
        js = JShard(0, 0, N, K=K, n=N, backend="xla", plan_cache=None)
        js.build(_jg(g), Y)
        (ts, tc), (jsum, jc) = sh.class_stats(Y), js.class_stats(Y)
        np.testing.assert_allclose(ts.numpy(), np.asarray(jsum), atol=1e-5)
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        cent = ts / torch.clamp_min(tc[:, None], 1.0)
        rows = sh.rows(np.arange(0, N, 5))
        tp, tsc = Q.predict_rows(rows, cent)
        jp, jsc = JQ.predict_rows(jnp.asarray(rows.numpy()),
                                  jnp.asarray(cent.numpy()))
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-6)


class TestPortTopkContracts:
    """The JAX package's bit-equality contracts, held inside the port."""

    M, NQ, TOPK = 160, 12, 9

    def _fixture(self, rng):
        base = rng.normal(size=(self.M // 4, K)).astype(np.float32)
        Z = torch.as_tensor(np.repeat(base, 4, axis=0))   # ties everywhere
        Zn = Q.normalize_rows(Z)
        qnodes = rng.integers(0, self.M, self.NQ).astype(np.int32)
        return Z, Zn, Zn[torch.as_tensor(qnodes)], qnodes

    @pytest.mark.parametrize("p", [1, 2, 4])
    @pytest.mark.parametrize("block_rows", [16, 64, 1 << 14])
    def test_bitwise_equal_per_slice_and_merged(self, p, block_rows, rng):
        Z, Zn, q, qnodes = self._fixture(rng)
        full = Q.topk_cosine_q(Zn, q, qnodes, k=self.TOPK, block_rows=7)
        bounds = np.linspace(0, self.M, p + 1).astype(int)
        ref_parts, fus_parts = [], []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            ref = Q.topk_cosine_q(Zn[lo:hi], q, qnodes, k=self.TOPK,
                                  block_rows=block_rows, row_offset=lo)
            fus = Q.topk_cosine_fused(Zn[lo:hi], q, qnodes, k=self.TOPK,
                                      row_offset=lo)
            fno = Q.topk_cosine_fused_norm(Z[lo:hi], q, qnodes,
                                           k=self.TOPK, row_offset=lo)
            for a, b, c in zip(ref, fus, fno):
                assert np.array_equal(a, b) and np.array_equal(a, c)
            assert torch.equal(fno[2], Zn[lo:hi])
            ref_parts.append(ref)
            fus_parts.append(fus)
        mr = Q.merge_topk([r[0] for r in ref_parts],
                          [r[1] for r in ref_parts], k=self.TOPK)
        mf = Q.merge_topk([f[0] for f in fus_parts[::-1]],
                          [f[1] for f in fus_parts[::-1]], k=self.TOPK)
        for a, b, c in zip(mr, mf, full):
            assert np.array_equal(a, b) and np.array_equal(a, c)

    def test_ties_resolve_to_ascending_id(self, rng):
        _, Zn, q, qnodes = self._fixture(rng)
        idx, val = Q.topk_cosine_q(Zn, q, qnodes, k=self.TOPK,
                                   exclude_self=False)
        tied = val[:, 1:] == val[:, :-1]
        assert tied.any()
        assert np.all(idx[:, 1:][tied] > idx[:, :-1][tied])

    def test_k_exceeds_candidates_and_exclude_self(self, rng):
        _, Zn, q, qnodes = self._fixture(rng)
        few = Q.topk_cosine_q(Zn[:3], q, qnodes, k=8, block_rows=2)
        fus = Q.topk_cosine_fused(Zn[:3], q, qnodes, k=8)
        assert all(np.array_equal(a, b) for a, b in zip(few, fus))
        assert (few[0] == -1).any() and np.isneginf(few[1]).any()
        keep = Q.topk_cosine_q(Zn, q, qnodes, k=self.TOPK,
                               exclude_self=False)
        keep_f = Q.topk_cosine_fused(Zn, q, qnodes, k=self.TOPK,
                                     exclude_self=False)
        assert all(np.array_equal(a, b) for a, b in zip(keep, keep_f))
        assert (keep[1][:, 0] > 0.999).all()     # a row scores itself 1

    def test_topk_cosine_ids_matches_contiguous(self, rng):
        _, Zn, q, qnodes = self._fixture(rng)
        ids = np.arange(self.M, dtype=np.int32)
        a = Q.topk_cosine_ids(Zn, ids, q, qnodes, k=5, block_rows=32)
        b = Q.topk_cosine_q(Zn, q, qnodes, k=5)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))

    def test_merge_matches_reference(self, rng):
        vals = [np.sort(rng.random((4, 5)).astype(np.float32), 1)[:, ::-1]
                for _ in range(3)]
        vals[1][:, 0] = vals[0][:, 0]                # cross-part ties
        vals[2][:, 3:] = -np.inf
        idxs = [rng.permutation(100)[:20].reshape(4, 5).astype(np.int32)
                for _ in range(3)]
        idxs[2][:, 3:] = -1
        a = Q.merge_topk(idxs, vals, k=12)
        b = JQ.merge_topk(idxs, vals, k=12)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        c = Q.merge_topk(idxs[::-1], vals[::-1], k=12)
        assert np.array_equal(a[0], c[0])
