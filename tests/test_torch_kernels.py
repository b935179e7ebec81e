"""repro_torch.kernels on the CPU (plain versions) against the JAX
package's Pallas kernels run in interpret mode.

Tolerances: Z atol 1e-5 (the JAX suite's), Zn atol 1e-6, top-k across
packages `conftest.topk_equivalent` (the two packages sum scores in
different orders).  Inside the port, packing invariants are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import topk_equivalent
from repro.kernels import ops as JO
from repro.kernels.gee_scatter import gee_scatter_pallas
from repro.kernels.query_fused import gee_delta_renorm as j_delta
from repro.serving import queries as JQ
from repro_torch.graph.generators import powerlaw
from repro_torch.kernels import _build
from repro_torch.kernels import ops as TO
from repro_torch.kernels import query_fused as QF
from repro_torch.kernels import ref as TRef
from repro_torch.kernels.gee_scatter import gee_scatter, gee_scatter_plain


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _contribs(rng, n, m, K, dst=None):
    if dst is None:
        dst = rng.integers(0, n, m)
    dst = np.asarray(dst, np.int32)
    cls = rng.integers(0, K, dst.shape[0]).astype(np.int32)
    # GEE-sized values (Wv * w <= 1): row sums stay where atol 1e-5 means
    # float32 rounding, not a loose bound
    val = (rng.random(dst.shape[0], dtype=np.float32) + 0.5) / 64
    return dst, cls, val


PACK_CASES = {
    "empty": lambda rng: (np.zeros(0, np.int32), 200),
    "one_tile": lambda rng: (rng.integers(0, 40, 500), 40),
    "ragged_n": lambda rng: (rng.integers(0, 301, 2000), 301),
    "powerlaw": lambda rng: (powerlaw(300, 3000, seed=5).u, 300),
}


def _tile_triples(row_ptr, cls, val, t, tile_n):
    """Sorted (tile-local row, class, value) of tile t of a flat pack."""
    rp = row_ptr.numpy()[t * tile_n:(t + 1) * tile_n + 1]
    rows = np.repeat(np.arange(tile_n), np.diff(rp))
    lo, hi = rp[0], rp[-1]
    return sorted(zip(rows.tolist(), cls.numpy()[lo:hi].tolist(),
                      val.numpy()[lo:hi].tolist()))


class TestPackEdges:
    @pytest.mark.parametrize("case", sorted(PACK_CASES))
    def test_tiles_hold_reference_multisets(self, rng, case):
        dst, n = PACK_CASES[case](rng)
        dst, cls, val = _contribs(rng, n, 0, 6, dst=dst)
        tile_n, eb = 64, 128
        jr, jc, jv, jT = JO.pack_edges(dst, cls, val, n, tile_n, eb)
        row_ptr, tc, tv, tT = TO.pack_edges(_t(dst), _t(cls), _t(val), n,
                                            tile_n)
        S = dst.shape[0]
        assert tT == jT
        assert row_ptr.dtype == torch.int64 and tc.dtype == torch.int32
        assert tv.dtype == torch.float32
        assert row_ptr.shape == (tT * tile_n + 1,)
        assert tc.shape == tv.shape == (S,)
        assert int(row_ptr[0]) == 0 and int(row_ptr[-1]) == S
        assert bool((row_ptr.diff() >= 0).all())
        jr, jc, jv = (x.reshape(jT, -1) for x in (jr, jc, jv))
        for t in range(tT):
            real = jv[t] != 0            # test values are never 0
            ref = sorted(zip(jr[t][real].tolist(), jc[t][real].tolist(),
                             jv[t][real].tolist()))
            assert _tile_triples(row_ptr, tc, tv, t, tile_n) == ref

    def test_stable_within_row(self, rng):
        """Contributions of one row keep their input order."""
        dst = np.array([3, 1, 3, 3, 1], np.int32)
        val = np.arange(1, 6, dtype=np.float32)
        row_ptr, _, tv, _ = TO.pack_edges(_t(dst), _t(np.zeros(5, np.int32)),
                                          _t(val), 8, 8)
        assert tv.tolist() == [2.0, 5.0, 1.0, 3.0, 4.0]
        assert row_ptr.tolist() == [0, 0, 2, 2, 5, 5, 5, 5, 5]

    def test_buffers_hold_s_slots(self, rng):
        """One row with 10,000 contributions among 1,000 tiles: the
        buffers hold S slots, where the reference's packing pads every
        tile to the largest one."""
        tile_n, T = 4, 1000
        n = tile_n * T
        dst = np.concatenate([np.full(10_000, 7),
                              rng.integers(0, n, 3000)]).astype(np.int32)
        dst, cls, val = _contribs(rng, n, 0, 6, dst=dst)
        row_ptr, tc, tv, tT = TO.pack_edges(_t(dst), _t(cls), _t(val), n,
                                            tile_n)
        S = dst.shape[0]
        assert tT == T and tc.numel() == tv.numel() == S
        assert row_ptr.numel() == T * tile_n + 1
        assert int(row_ptr[8] - row_ptr[7]) >= 10_000
        jr, jc, jv, _ = JO.pack_edges(dst, cls, val, n, tile_n, 128)
        assert jr.size >= T * 10_000          # the padded layout's size
        jr, jc, jv = (x.reshape(T, -1) for x in (jr, jc, jv))
        for t in (0, 1, 500, T - 1):
            real = jv[t] != 0
            ref = sorted(zip(jr[t][real].tolist(), jc[t][real].tolist(),
                             jv[t][real].tolist()))
            assert _tile_triples(row_ptr, tc, tv, t, tile_n) == ref


class TestGeeScatter:
    @pytest.mark.parametrize("case", sorted(PACK_CASES))
    @pytest.mark.parametrize("K", [3, 8, 256])
    def test_plain_matches_pallas(self, rng, case, K):
        dst, n = PACK_CASES[case](rng)
        dst, cls, val = _contribs(rng, n, 0, K, dst=dst)
        # K = 256: a narrow tile keeps the interpreted one-hot product quick
        tile_n, eb = (64, 128) if K < 256 else (16, 128)
        jr, jc, jv, jT = JO.pack_edges(dst, cls, val, n, tile_n, eb)
        kdim = JO._round_up(K, 8)
        zj = np.asarray(gee_scatter_pallas(
            jnp.asarray(jr), jnp.asarray(jc), jnp.asarray(jv), num_tiles=jT,
            tile_n=tile_n, kdim=kdim, interpret=True))[:n, :K]
        row_ptr, tc, tv, T = TO.pack_edges(_t(dst), _t(cls), _t(val), n,
                                           tile_n)
        before = dict(_build.launches)
        zt = gee_scatter(row_ptr, tc, tv, num_tiles=T, tile_n=tile_n,
                         kdim=K)[:n]
        assert _build.launches == before     # plain versions never count
        np.testing.assert_allclose(zt.numpy(), zj, atol=1e-5)
        np.testing.assert_allclose(
            zt.numpy(), TRef.gee_scatter_ref(_t(dst), _t(cls), _t(val), n,
                                             K).numpy(), atol=1e-5)

    def test_gee_cuda_matches_gee_pallas(self, rng):
        n, s, K = 200, 1500, 5
        u = rng.integers(0, n, s).astype(np.int32)
        v = rng.integers(0, n, s).astype(np.int32)
        w = rng.random(s, dtype=np.float32) + 0.5
        Y = np.where(rng.random(n) < 0.4, rng.integers(0, K, n), -1).astype(
            np.int32)
        zj = np.asarray(JO.gee_pallas(u, v, w, Y, K=K, n=n, tile_n=64,
                                      edge_block=128, interpret=True))
        zt = TO.gee_cuda(_t(u), _t(v), _t(w), _t(Y), K=K, n=n, tile_n=64)
        np.testing.assert_allclose(zt.numpy(), zj, atol=1e-5)
        np.testing.assert_allclose(
            zt.numpy(), TRef.gee_ref(_t(u), _t(v), _t(w), _t(Y), n,
                                     K).numpy(), atol=1e-5)

    def test_guards(self):
        row_ptr = torch.zeros(9, dtype=torch.int64)
        e = torch.zeros(0, dtype=torch.int32)
        with pytest.raises(ValueError, match="tiles"):
            gee_scatter(row_ptr, e, e.float(), num_tiles=3, tile_n=4, kdim=2)
        with pytest.raises(ValueError, match="cpu or cuda"):
            gee_scatter(row_ptr.to("meta"), e, e.float(), num_tiles=2,
                        tile_n=4, kdim=2)
        with pytest.raises(ValueError, match=">= 1"):
            gee_scatter(row_ptr, e, e.float(), num_tiles=2, tile_n=4, kdim=0)
        z = gee_scatter_plain(row_ptr, e, e.float(), num_tiles=2, tile_n=4,
                              kdim=2)
        assert z.shape == (8, 2) and not z.any()


class TestTopkFused:
    K, M, NQ, TOPK = 6, 160, 12, 9

    def _fixture(self, rng, duplicates=True):
        base = rng.normal(size=(self.M // 4, self.K)).astype(np.float32)
        Z = np.repeat(base, 4, axis=0) if duplicates else \
            rng.normal(size=(self.M, self.K)).astype(np.float32)
        Zn = QF.normalize_rows(_t(Z)).numpy()
        qnodes = rng.integers(0, self.M, self.NQ).astype(np.int32)
        return Z, Zn, Zn[qnodes], qnodes

    def test_normalize_rows_matches_reference(self, rng):
        Z = rng.normal(size=(50, 7)).astype(np.float32)
        Z[3] = 0                                 # the eps clamp
        np.testing.assert_allclose(
            QF.normalize_rows(_t(Z)).numpy(),
            np.asarray(JQ.normalize_rows(jnp.asarray(Z))), atol=1e-6)
        # the loop is the arithmetic the kernels use: bits do not depend
        # on which rows are normalized together
        a = QF.normalize_rows(_t(Z))
        b = torch.cat([QF.normalize_rows(_t(Z[:20])),
                       QF.normalize_rows(_t(Z[20:]))])
        assert torch.equal(a, b)

    @pytest.mark.parametrize("normalize", [False, True])
    @pytest.mark.parametrize("exclude_self", [True, False])
    @pytest.mark.parametrize("duplicates", [True, False])
    def test_plain_matches_pallas(self, rng, normalize, exclude_self,
                                  duplicates):
        Z, Zn, q, qnodes = self._fixture(rng, duplicates)
        rows = Z if normalize else Zn
        lo = 40
        if normalize:
            ji, jv, jzn = JQ.topk_cosine_fused_norm(
                jnp.asarray(rows[lo:]), jnp.asarray(q), qnodes, k=self.TOPK,
                block_rows=32, exclude_self=exclude_self, row_offset=lo)
        else:
            ji, jv = JQ.topk_cosine_fused(
                jnp.asarray(rows[lo:]), jnp.asarray(q), qnodes, k=self.TOPK,
                block_rows=32, exclude_self=exclude_self, row_offset=lo)
        out = QF.topk_fused(_t(rows[lo:]), _t(q), _t(qnodes), k=self.TOPK,
                            row_offset=lo, exclude_self=exclude_self,
                            normalize=normalize)
        topk_equivalent(out[1].numpy(), out[0].numpy(), ji, jv)
        if normalize:
            np.testing.assert_allclose(out[2].numpy(), np.asarray(jzn),
                                       atol=1e-6)
            assert torch.equal(out[2], QF.normalize_rows(_t(rows[lo:])))

    def test_k_exceeds_candidates(self, rng):
        _, Zn, q, qnodes = self._fixture(rng)
        ji, jv = JQ.topk_cosine_fused(jnp.asarray(Zn[:3]), jnp.asarray(q),
                                      qnodes, k=8, block_rows=16)
        vals, idxs = QF.topk_fused(_t(Zn[:3]), _t(q), _t(qnodes), k=8)
        assert np.array_equal(idxs.numpy(), ji)
        assert (idxs == -1).any() and torch.isinf(vals).any()
        topk_equivalent(idxs.numpy(), vals.numpy(), ji, jv)

    def test_block_size_invariant(self, rng):
        _, Zn, q, qnodes = self._fixture(rng)
        ref = QF.topk_fused_plain(_t(Zn), _t(q), _t(qnodes), k=self.TOPK)
        for b in (1, 7, 16, 1 << 14):
            got = QF.topk_fused_plain(_t(Zn), _t(q), _t(qnodes), k=self.TOPK,
                                      block_rows=b)
            assert all(torch.equal(x, y) for x, y in zip(ref, got))

    def test_guards(self):
        z = torch.zeros((4, 3))
        with pytest.raises(ValueError, match="cpu or cuda"):
            QF.topk_fused(z.to("meta"), z, torch.zeros(4, dtype=torch.int32),
                          k=2)


class TestDeltaRenorm:
    def _case(self, rng, n=150, K=5, m=80, tile_n=64):
        Z = rng.random((n, K), dtype=np.float32)
        rows, cls, val = _contribs(rng, n, m, K)
        return Z, rows, cls, val, tile_n

    def _port(self, Z, rows, cls, val):
        o = np.argsort(rows, kind="stable")
        return QF.gee_delta_renorm(_t(Z), _t(rows[o]), _t(cls[o]),
                                   _t(val[o]))

    def _jax(self, Z, rows, cls, val, tile_n):
        rb, cb, vb, _ = JO.pack_edges(rows, cls, val, Z.shape[0], tile_n,
                                      128)
        zj, znj = j_delta(jnp.asarray(Z), rb, cb, vb, tile_n=tile_n,
                          interpret=True)
        return np.asarray(zj), np.asarray(znj)

    def test_plain_matches_pallas(self, rng):
        Z, rows, cls, val, tile_n = self._case(rng)
        zt, znt = self._port(Z, rows, cls, val)
        zj, znj = self._jax(Z, rows, cls, val, tile_n)
        np.testing.assert_allclose(zt.numpy(), zj, atol=1e-5)
        np.testing.assert_allclose(znt.numpy(), znj, atol=1e-6)
        assert torch.equal(znt, QF.normalize_rows(zt))

    def test_sign_roundtrip(self, rng):
        Z, rows, cls, val, tile_n = self._case(rng)
        z1, _ = self._port(Z, rows, cls, val)
        z2, zn2 = self._port(z1.numpy(), rows, cls, -val)
        zj, znj = self._jax(*self._jax(Z, rows, cls, val, tile_n)[:1], rows,
                            cls, -val, tile_n)
        np.testing.assert_allclose(z2.numpy(), Z, atol=1e-5)
        np.testing.assert_allclose(z2.numpy(), zj, atol=1e-5)
        np.testing.assert_allclose(zn2.numpy(), znj, atol=1e-6)

    def test_empty_delta(self, rng):
        Z = rng.random((20, 3), dtype=np.float32)
        e = np.zeros(0, np.int32)
        zt, znt = QF.gee_delta_renorm(_t(Z), _t(e), _t(e),
                                      _t(np.zeros(0, np.float32)))
        assert np.array_equal(zt.numpy(), Z)
        assert torch.equal(znt, QF.normalize_rows(_t(Z)))
