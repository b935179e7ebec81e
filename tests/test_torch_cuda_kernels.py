"""The CUDA kernels on the card: each against its plain version, and
bit-equal from run to run.

Run on a machine with a card:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
Without one every test here skips (the check runs inside the fixture, so
every pytest worker collects the same tests)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gee_scatter as GS
from repro_torch.kernels import query_fused as QF
from repro_torch.kernels.ops import pack_edges
from repro_torch.models import model as TM

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # plain versions with matrix products stay in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _same(a, b):
    return a.shape == b.shape and bool((a == b).all())


def _serial_sum(row_ptr, cls, val, kdim):
    """float32 sum of each (row, class) in packed order, on the host: the
    kernel's order of additions, so its exact bits."""
    rp = row_ptr.cpu().numpy()
    rows = np.repeat(np.arange(rp.shape[0] - 1), np.diff(rp))
    Z = np.zeros((rp.shape[0] - 1, kdim), np.float32)
    np.add.at(Z, (rows, cls.cpu().numpy()), val.cpu().numpy())
    return Z


# (n, m, K, tile_n, giant): skewed rows; one tile; K = 256 (row
# sub-ranges); one row holding `giant` contributions
@pytest.mark.parametrize("n,m,K,tile_n,giant", [
    (300, 6000, 5, 64, 0), (50, 900, 8, 64, 0), (5000, 100000, 16, 256, 0),
    (3000, 40000, 256, 256, 0), (2000, 10000, 16, 256, 50_000)])
def test_gee_scatter(dev, rng, n, m, K, tile_n, giant):
    dst = np.concatenate([rng.zipf(1.5, m) % n, np.full(giant, n // 3)])
    dst = torch.as_tensor(rng.permutation(dst).astype(np.int64), device=dev)
    cls = torch.as_tensor(rng.integers(0, K, m + giant), device=dev)
    val = rng.random(m + giant, dtype=np.float32) / 64
    val[rng.random(m + giant) < 0.5] = 0
    val = torch.as_tensor(val, device=dev)
    row_ptr, clsb, valb, T = pack_edges(dst, cls, val, n, tile_n)
    before = _build.launches["gee_scatter"]
    a = GS.gee_scatter(row_ptr, clsb, valb, num_tiles=T, tile_n=tile_n,
                       kdim=K)
    b = GS.gee_scatter(row_ptr, clsb, valb, num_tiles=T, tile_n=tile_n,
                       kdim=K)
    p = GS.gee_scatter_plain(row_ptr, clsb, valb, num_tiles=T,
                             tile_n=tile_n, kdim=K)
    assert _build.launches["gee_scatter"] == before + 2
    assert _same(a, b)
    torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-6)
    assert np.array_equal(a.cpu().numpy(),
                          _serial_sum(row_ptr, clsb, valb, K))


def test_gee_scatter_large_groups(dev, rng):
    """Every donor labelled and 90 % of a row's donors in one class (a
    refine round on an SBM): dense batches with large groups take the
    fold from registers; the same bits as the serial sum."""
    n, m, K, tile_n = 3000, 200_000, 16, 256
    dst = rng.integers(0, n, m)
    cls = np.where(rng.random(m) < 0.9, dst % K, rng.integers(0, K, m))
    val = rng.random(m, dtype=np.float32) / 64 + np.float32(1e-3)
    row_ptr, clsb, valb, T = pack_edges(
        *(torch.as_tensor(a, device=dev) for a in (dst, cls, val)), n,
        tile_n)
    kw = dict(num_tiles=T, tile_n=tile_n, kdim=K)
    a = GS.gee_scatter(row_ptr, clsb, valb, **kw)
    assert _same(a, GS.gee_scatter(row_ptr, clsb, valb, **kw))
    torch.testing.assert_close(
        a, GS.gee_scatter_plain(row_ptr, clsb, valb, **kw), rtol=1e-5,
        atol=1e-6)
    assert np.array_equal(a.cpu().numpy(),
                          _serial_sum(row_ptr, clsb, valb, K))


@pytest.mark.parametrize("z_floats", [1024, 100])
def test_gee_scatter_sub_tiles(dev, rng, monkeypatch, z_floats):
    """A smaller shared-memory budget forces row sub-ranges (1024: 4 rows
    a pass at K = 256) and column ranges (100: three passes over each
    row's contributions): the same bits as the whole tile."""
    n, m, K, tile_n = 700, 30000, 256, 64
    dst = torch.as_tensor(rng.integers(0, n, m), device=dev)
    cls = torch.as_tensor(rng.integers(0, K, m), device=dev)
    val = torch.as_tensor(rng.random(m, dtype=np.float32), device=dev)
    row_ptr, clsb, valb, T = pack_edges(dst, cls, val, n, tile_n)
    kw = dict(num_tiles=T, tile_n=tile_n, kdim=K)
    whole = GS.gee_scatter(row_ptr, clsb, valb, **kw)
    monkeypatch.setattr(GS, "Z_FLOATS", z_floats)
    assert GS.subtile(tile_n, K)[0] < tile_n
    assert _same(GS.gee_scatter(row_ptr, clsb, valb, **kw), whole)
    assert np.array_equal(whole.cpu().numpy(),
                          _serial_sum(row_ptr, clsb, valb, K))


def _check_topk(rows, q, qn, **kw):
    """Two kernel runs and the plain version: the same bits."""
    before = _build.launches["topk_fused"]
    a = QF.topk_fused(rows, q, qn, **kw)
    b = QF.topk_fused(rows, q, qn, **kw)
    p = QF.topk_fused_plain(rows, q, qn, **kw)
    assert _build.launches["topk_fused"] == before + 2
    assert len(a) == len(p)
    for x, y, z in zip(a, b, p):
        assert _same(x, y)              # run to run
        assert _same(x, z)              # same arithmetic, same tie order


# (K, m, nq, k, run): rows come in runs of `run` equal rows, so exact
# score ties straddle the select pass's tiles (1,024 rows at K = 16) and
# its blocks' tile ranges.  K in {8, 16, 32} takes the register body,
# other K the shared-memory body.
TOPK_SHAPES = [
    (6, 160, 12, 9, 4), (6, 3, 12, 8, 4), (6, 70000, 12, 10, 4),
    (16, 70001, 64, 10, 7),      # ragged last tile
    (16, 1, 1, 1, 1),            # one row
    (16, 200, 65, 64, 3),        # fewer rows than blocks; two query groups
    (16, 300000, 200, 10, 7),    # blocks walk several tiles; four groups
    (8, 70001, 64, 64, 7), (8, 50, 65, 1, 2), (32, 100003, 64, 10, 7),
    (33, 5000, 64, 10, 7), (256, 3000, 65, 64, 5), (256, 1, 1, 10, 1)]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("K,m,nq,k,run", TOPK_SHAPES)
def test_topk_fused(dev, rng, normalize, exclude_self, K, m, nq, k, run):
    base = rng.normal(size=(-(-m // run), K)).astype(np.float32)
    Z = torch.as_tensor(np.repeat(base, run, axis=0)[:m], device=dev)
    Zn = QF.normalize_rows(Z)
    qn = torch.as_tensor(rng.integers(0, m, nq).astype(np.int32), device=dev)
    q = Zn[qn.long()].contiguous()
    _check_topk(Z if normalize else Zn, q, qn + 1000, k=k, row_offset=1000,
                exclude_self=exclude_self, normalize=normalize)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_topk_fused_own_row_at_kth_place(dev, rng, normalize, exclude_self,
                                         k):
    """k - 1 copies of the query's row just below its id, across a tile
    boundary: the copies tie with it and win on id, so its own row is the
    k-th best (exclude_self off) or the first one left out (on)."""
    m, K, self_ = 5000, 16, 1024 + 5
    Z = rng.normal(size=(m, K)).astype(np.float32)
    Z[self_ - (k - 1):self_] = Z[self_]
    Z = torch.as_tensor(Z, device=dev)
    Zn = QF.normalize_rows(Z)
    qn = torch.as_tensor(np.r_[self_, rng.integers(0, m, 7)].astype(
        np.int32), device=dev)
    q = Zn[qn.long()].contiguous()
    _check_topk(Z if normalize else Zn, q, qn, k=k,
                exclude_self=exclude_self, normalize=normalize)
    idxs = QF.topk_fused(Zn, q, qn, k=k, exclude_self=exclude_self)[1]
    if not exclude_self:
        assert int(idxs[0, k - 1]) == self_


@pytest.mark.parametrize("K", [16, 6])
def test_topk_fused_unaligned_rows(dev, rng, K):
    """Rows that do not start on 16 bytes take the shared-memory body:
    the same answer."""
    m = 5000
    flat = torch.as_tensor(rng.normal(size=m * K + 1).astype(np.float32),
                           device=dev)
    Z = flat[1:].view(m, K)
    assert Z.data_ptr() % 16 != 0 and Z.is_contiguous()
    Zn = QF.normalize_rows(Z)
    qn = torch.as_tensor(rng.integers(0, m, 64).astype(np.int32), device=dev)
    q = Zn[qn.long()].contiguous()
    for normalize in (False, True):
        _check_topk(Z, q, qn, k=10, normalize=normalize)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_gee_delta_renorm(dev, rng, sign):
    n, K, m = 3000, 16, 400
    Z = torch.as_tensor(rng.random((n, K), dtype=np.float32), device=dev)
    r = torch.as_tensor(np.sort(rng.integers(0, n, m)).astype(np.int32),
                        device=dev)
    c = torch.as_tensor(rng.integers(0, K, m).astype(np.int32), device=dev)
    v = torch.as_tensor(sign * rng.random(m, dtype=np.float32), device=dev)
    a = QF.gee_delta_renorm(Z, r, c, v)
    b = QF.gee_delta_renorm(Z, r, c, v)
    p = QF.gee_delta_renorm_plain(Z, r, c, v)
    assert _same(a[0], b[0]) and _same(a[1], b[1])
    torch.testing.assert_close(a[0], p[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a[1], p[1], rtol=0, atol=1e-6)
    assert _same(a[1], QF.normalize_rows(a[0]))


@pytest.mark.parametrize("K", [16, 129, 172, 200, 256, 512, 1500, 3001, 4000])
def test_gee_delta_renorm_wide(dev, rng, K):
    """One body for every K: Z_new and Zn have the plain version's bits
    (run on the host, where the adds go in list order), repeated (row,
    class) pairs included."""
    n, m = 700, 600
    Z = torch.as_tensor(rng.random((n, K), dtype=np.float32), device=dev)
    r = np.sort(rng.integers(0, n, m)).astype(np.int32)
    c = rng.integers(0, 4, m).astype(np.int32)     # repeated (row, class)
    v = rng.random(m, dtype=np.float32) - np.float32(0.5)
    args = [torch.as_tensor(x, device=dev) for x in (r, c, v)]
    before = _build.launches["gee_delta_renorm"]
    a = QF.gee_delta_renorm(Z, *args)
    b = QF.gee_delta_renorm(Z, *args)
    assert _build.launches["gee_delta_renorm"] == before + 2
    p = QF.gee_delta_renorm_plain(Z.cpu(), *(x.cpu() for x in args))
    for x, y, z in zip(a, b, p):
        assert _same(x, y)
        assert _same(x.cpu(), z)


@pytest.mark.parametrize("K", [1, 3, 5, 16, 127, 200])
@pytest.mark.parametrize("shift", [0, 1, 3])
def test_gee_delta_renorm_any_offset(dev, rng, K, shift):
    """Z at a 4-byte offset from 16 bytes (a view), tiles that straddle
    the runs, the slice's first and last rows, a grid of more blocks than
    tiles and of fewer: the plain version's bits, Z untouched, the
    launcher's plan as `delta_info` reports it."""
    for n in (5, 3000):
        flat = torch.as_tensor(rng.normal(size=n * K + shift).astype(
            np.float32), device=dev)
        Z = flat[shift:].view(n, K)
        before = Z.clone()
        r = np.sort(np.concatenate([rng.integers(0, n, 300),
                                    [0, 0, n - 1]])).astype(np.int32)
        c = rng.integers(0, K, r.shape[0]).astype(np.int32)
        v = rng.random(r.shape[0], dtype=np.float32) - np.float32(0.5)
        args = [torch.as_tensor(x, device=dev) for x in (r, c, v)]
        a = QF.gee_delta_renorm(Z, *args)
        p = QF.gee_delta_renorm_plain(Z.cpu(), *(x.cpu() for x in args))
        assert _same(a[0].cpu(), p[0]) and _same(a[1].cpu(), p[1])
        assert _same(Z, before)
        info = QF.delta_info(Z)
        assert info["rows"] % 4 == 0 and info["stages"] >= 3
        assert info["tiles"] == -(-n // info["rows"])
        assert 1 <= info["grid"] <= info["tiles"]


@pytest.mark.parametrize("K", [15000, 20000, 40001])
def test_gee_delta_renorm_chunked_rows(dev, rng, K):
    """A row too wide for three stages of shared memory streams through
    the ring in column chunks, twice: Z_new and Zn have the plain
    version's bits, with entries on both sides of every chunk boundary,
    repeated (row, class) pairs, a row with none, and a row of zeros."""
    n = 40
    Zh = rng.normal(size=(n, K)).astype(np.float32)
    Zh[3] = 0.0
    Z = torch.as_tensor(Zh, device=dev)
    before = Z.clone()
    info = QF.delta_info(Z)
    assert info["rows"] == 1 and info["chunks"] >= 2
    assert info["tiles"] == n * 2 * info["chunks"]
    w = info["stage_bytes"] // 4 - 4            # columns a chunk
    cuts = np.arange(w, K, w)
    r = np.concatenate([rng.integers(0, n, 500), np.full(2 * cuts.size, 7),
                        np.full(50, n - 1), [0, 0]])
    c = np.concatenate([rng.integers(0, K, 500), cuts, cuts - 1,
                        rng.integers(0, 3, 50), [0, K - 1]])
    order = np.argsort(r, kind="stable")
    r, c = r[order].astype(np.int32), c[order].astype(np.int32)
    r[r == 11] = 12                              # row 11 has no entries
    v = rng.random(r.size, dtype=np.float32) - np.float32(0.5)
    args = [torch.as_tensor(x, device=dev) for x in (r, c, v)]
    a = QF.gee_delta_renorm(Z, *args)
    b = QF.gee_delta_renorm(Z, *args)
    p = QF.gee_delta_renorm_plain(Z.cpu(), *(x.cpu() for x in args))
    for x, y, z in zip(a, b, p):
        assert _same(x, y)
        assert _same(x.cpu(), z)
    assert _same(a[1], QF.normalize_rows(a[0]))
    assert _same(Z, before)


# wide rows and long lists: K > 256 takes the chunked body, k > 64 the
# long-list bodies (k <= 4096), k > 4096 the general path; k beyond the
# candidates included
TOPK_WIDE_SHAPES = [
    (257, 3000, 65, 10, 3), (300, 5000, 64, 10, 7), (512, 2000, 3, 64, 2),
    (16, 70001, 64, 65, 7), (16, 5000, 64, 100, 3), (8, 3000, 5, 256, 4),
    (300, 1500, 64, 100, 5), (16, 40, 7, 100, 2), (300, 3, 4, 70, 1),
    (300, 3, 4, 8, 1),
    (300, 20000, 64, 100, 3), (1024, 3000, 5, 1024, 3),
    (512, 2000, 130, 256, 2), (301, 2000, 9, 10, 3), (33, 5000, 64, 100, 7),
    (16, 70001, 64, 1024, 7), (257, 700, 3, 4096, 1),
    (16, 5000, 3, 4100, 3),     # past the shared-memory lists: general
    # many tiles a block: thresholds shared across blocks (gkey),
    # buffers that fill and merge
    (300, 70000, 64, 10, 3), (257, 66000, 5, 100, 2),
    (1024, 65536, 3, 1024, 4)]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("K,m,nq,k,run", TOPK_WIDE_SHAPES)
def test_topk_fused_wide(dev, rng, normalize, exclude_self, K, m, nq, k,
                         run):
    base = rng.normal(size=(-(-m // run), K)).astype(np.float32)
    Z = torch.as_tensor(np.repeat(base, run, axis=0)[:m], device=dev)
    Zn = QF.normalize_rows(Z)
    qn = torch.as_tensor(rng.integers(0, m, nq).astype(np.int32), device=dev)
    q = Zn[qn.long()].contiguous()
    _check_topk(Z if normalize else Zn, q, qn + 1000, k=k, row_offset=1000,
                exclude_self=exclude_self, normalize=normalize)
    if k > m:
        vals, idxs = QF.topk_fused(Zn, q, qn, k=k)
        assert bool((idxs[:, m:] == -1).all())
        assert bool(torch.isneginf(vals[:, m:]).all())


@pytest.mark.parametrize("K,k,nq,aligned,body", [
    (16, 10, 64, True, "registers"), (16, 100, 64, True, "registers"),
    (16, 10, 64, False, "shared"), (33, 100, 64, True, "shared"),
    (256, 1024, 3, True, "shared"), (257, 10, 64, True, "chunked"),
    (300, 100, 5, True, "chunked"), (1024, 4096, 1, True, "chunked"),
    (16, 4097, 2, True, "general"), (300, 5000, 2, True, "general")])
def test_topk_select_body_by_shape(dev, rng, K, k, nq, aligned, body):
    """The launchers pick the body from the shape: k <= 64 on the
    register and shared bodies keeps its 64-query group and 128 slots;
    longer lists and the chunked body shrink the group until the lists
    fit, with 2k slots (at least 32); only k > 4096 takes the general
    path.  The answer is the plain scan's at every one."""
    m = 3000
    Zn = QF.normalize_rows(torch.as_tensor(
        rng.normal(size=(m, K)).astype(np.float32), device=dev))
    if not aligned:             # rows that do not start on 16 bytes
        flat = torch.empty(m * K + 1, device=dev)
        flat[1:].view(m, K).copy_(Zn)
        Zn = flat[1:].view(m, K)
        assert Zn.data_ptr() % 16 != 0
    info = QF.select_info(Zn, k=k, nq=nq)
    assert info["body"] == body, info
    if body != "general":
        assert info["group"] & (info["group"] - 1) == 0
        assert info["smem"] <= 232_448
        if k <= 64 and body != "chunked":
            assert (info["group"], info["cap"]) == (64, 128)
        else:
            assert info["cap"] == max(2 * k, 32)
            assert info["group"] <= max(1, 1 << (nq - 1).bit_length())
    qn = torch.as_tensor(rng.integers(0, m, nq).astype(np.int32), device=dev)
    _check_topk(Zn, Zn[qn.long()].contiguous(), qn, k=k)


def test_wrappers_refuse_bad_inputs(dev):
    z = torch.zeros((8, 4), device=dev)
    qn = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        QF.topk_fused(z.double(), z[:2].double(), qn, k=2)
    with pytest.raises(ValueError, match="k >= 1"):
        QF.topk_fused(z, z[:2].contiguous(), qn, k=0)
    with pytest.raises(ValueError, match="contiguous"):
        QF.gee_delta_renorm(z.t(), qn, qn, qn.float())
    row_ptr = torch.tensor([0, 1, 2, 3, 4], device=dev)
    c = torch.zeros(5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        GS.gee_scatter(row_ptr, c[1:], c[1:].float(), num_tiles=1,
                       tile_n=4, kdim=2)
    with pytest.raises(TypeError):
        GS.gee_scatter(row_ptr.int(), c[:4], c[:4].float(), num_tiles=1,
                       tile_n=4, kdim=2)


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 2, 2, 64, 16), (2, 4, 2, 128, 32), (1, 8, 1, 128, 16),
    (2, 4, 2, 100, 64), (1, 4, 4, 1, 32), (1, 8, 2, 200, 128),
    # the 128-row tiles of the bfloat16 body: yi's heads one row past a
    # tile, ragged S, S = 1 with MQA, and every swizzle width
    (1, 32, 4, 2049, 128), (2, 8, 8, 127, 64), (1, 4, 1, 1, 16),
    (1, 16, 2, 384, 32),
    # head dims outside the bodies' set, zero-padded to the next one
    (1, 4, 2, 100, 48), (2, 8, 2, 130, 80), (1, 4, 4, 64, 96),
    (1, 8, 1, 257, 120),
    # head dims above 128: the D = 256 bodies (ragged S), and at 384 the
    # cluster forward (two blocks a cluster, a ragged last slice)
    (1, 4, 2, 100, 160), (2, 4, 1, 130, 256), (1, 2, 2, 33, 200),
    (1, 8, 8, 1, 384),
    # the bfloat16 body's persistent schedule: D = 64's 192-row items with
    # H = KV and with GQA, S ragged against them (a last item of 1 and of
    # 129 rows), fewer items than SMs, more items than a block's share,
    # and yi's and zamba2's full prefill shapes
    (2, 8, 8, 385, 64), (2, 16, 4, 577, 64), (1, 8, 2, 1000, 64),
    (1, 2, 2, 256, 64), (2, 16, 4, 1000, 64), (4, 32, 4, 2048, 128),
    (4, 32, 32, 2048, 64)])
def test_flash_attention(dev, rng, dtype, B, H, KV, S, D):
    """The kernel against its plain version at FLASH_TOL, two runs
    bit-equal; with lse the same output bits and lse within 1e-5 of the
    dense oracle's; on the (B, H, S, D) views of (B, S, H, D) tensors the
    same bits as on contiguous ones."""
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).to(dtype).transpose(1, 2)
        for h in (H, KV, KV))
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    before = _build.launches["flash_attention"]
    a = FA.flash_attention(qc, kc, vc)
    b = FA.flash_attention(qc, kc, vc)
    o, lse = FA.flash_attention_fwd(qc, kc, vc)
    ov = FA.flash_attention(q, k, v)
    p, plse = FA.flash_attention_plain(qc, kc, vc, return_lse=True)
    assert _build.launches["flash_attention"] == before + 4
    assert a.dtype == dtype and _same(a, b)
    assert _same(o, a) and _same(ov, a)
    if FA._forward_route(dtype, D)[0] != "padded":   # written in q's layout
        assert ov.transpose(1, 2).is_contiguous()
    if dtype == torch.bfloat16 and D <= FA.HEAD_DIMS[dtype][-1]:
        # the launcher's schedule: the wrapper's tiles, every (batch x
        # head, query tile) item, one persistent block an SM at most
        sch = FA._fwd_schedule(B, H, S, D, dev)
        rows, keys = FA.TILES[dtype][FA._pad(D)]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert (sch["rows"], sch["keys"]) == (rows, keys)
        assert sch["items"] == B * H * -(-S // rows)
        assert sch["grid"] == min(sch["items"], sms)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(a.float(), p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 2, 2, 64, 16), (1, 4, 4, 1, 32), (1, 32, 4, 130, 128),
    (2, 8, 2, 130, 256)])
def test_flash_attention_fwd_lse(dev, rng, dtype, B, H, KV, S, D):
    """The forward with lse: the same output bits as without, one launch,
    and each row's log-sum-exp within 1e-5 of the dense oracle's."""
    q, k, v = (torch.as_tensor(rng.normal(size=(B, h, S, D)).astype(
        np.float32), device=dev).to(dtype) for h in (H, KV, KV))
    before = _build.launches["flash_attention"]
    o, lse = FA.flash_attention_fwd(q, k, v)
    assert _build.launches["flash_attention"] == before + 1
    assert _same(o, FA.flash_attention(q, k, v))
    _, plse = FA.flash_attention_plain(q, k, v, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 120, 128, 160, 192, 256, 320])
@pytest.mark.parametrize("B,H,KV,S", [
    (1, 4, 4, 1), (2, 8, 2, 100), (1, 8, 1, 257), (1, 32, 4, 130),
    (2, 16, 8, 1100)])
def test_flash_attention_bwd(dev, rng, dtype, D, B, H, KV, S):
    """The backward kernel against `flash_attention_bwd_plain` given the
    same (o, lse), at FLASH_TOL; two runs give the same bits; one count
    under ``flash_attention_bwd`` a call and none under the forward's.
    At bfloat16 160, 192 and 256 run the D = 256 tensor-core body (ragged
    S, and at (2, 16, 8, 1100) more work items than SMs), 320 the cluster
    backward (two blocks a cluster); at float32 D <= 128 the f32bwd body
    (120 zero-padded to 128), up to 256 f32widebwd, 320 the cluster
    backward."""
    q, k, v = (torch.as_tensor(rng.normal(size=(B, h, S, D)).astype(
        np.float32), device=dev).to(dtype) for h in (H, KV, KV))
    do = torch.as_tensor(rng.normal(size=(B, H, S, D)).astype(np.float32),
                         device=dev).to(dtype)
    o, lse = FA.flash_attention_fwd(q, k, v)
    before = dict(_build.launches)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do)
    assert _build.launches["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 2
    assert _build.launches["flash_attention"] == before["flash_attention"]
    p = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    tol = FLASH_TOL[dtype]
    for x, y, z in zip(a, b, p):
        assert x.dtype == dtype and x.shape == z.shape and _same(x, y)
        torch.testing.assert_close(x.float(), z.float(), atol=tol, rtol=tol)


def test_flash_bwd_refuses_bad_inputs(dev):
    q = torch.zeros((1, 4, 64, 32), device=dev)
    lse = torch.zeros((1, 4, 64), device=dev)
    with pytest.raises(TypeError):
        x = q.half()
        FA.flash_attention_bwd(x, x, x, x, lse, x)
    with pytest.raises(TypeError, match="lse"):
        FA.flash_attention_bwd(q, q, q, q, lse.double(), q)
    with pytest.raises(TypeError, match="do"):
        FA.flash_attention_bwd(q, q, q, q, lse, q.bfloat16())
    # layouts the kernels cannot read in place: a last axis that is not
    # contiguous; at bfloat16 a row stride that is no multiple of 16 bytes
    with pytest.raises(ValueError, match="contiguous last axis"):
        x = torch.zeros((1, 4, 32, 64), device=dev).transpose(2, 3)
        FA.flash_attention_bwd(q, q, q, q, lse, x)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        x = torch.zeros((1, 4, 64, 36), device=dev).bfloat16()[..., :32]
        FA.flash_attention_bwd(qb, qb, qb, qb, lse, x)


def test_flash_wrapper_refuses_bad_inputs(dev):
    q = torch.zeros((1, 4, 64, 32), device=dev)
    with pytest.raises(ValueError, match="64 x 64"):
        FA.flash_attention(q, q, q, bq=32)
    qb = q.bfloat16()
    for tiles in (dict(bq=128), dict(bk=128), dict(bq=128, bk=128)):
        with pytest.raises(ValueError, match="128 x 128"):
            FA.flash_attention(qb, qb, qb, **tiles)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros((1, 4, 64, 0), device=dev)
        FA.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="contiguous last axis"):
        x = torch.zeros((1, 4, 32, 64), device=dev).transpose(2, 3)
        FA.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        x = torch.zeros((1, 4, 64, 36), device=dev).bfloat16()[..., :32]
        FA.flash_attention(x, x, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 160, 256])
@pytest.mark.parametrize("B,H,KV,S", [(2, 8, 2, 130), (1, 4, 1, 257)])
def test_flash_reads_the_model_layout_in_place(dev, rng, dtype, D, B, H,
                                               KV, S):
    """Both wrappers on the (B, H, S, D) views of (B, S, H, D) tensors:
    the same bits as on contiguous copies (the kernels do the same
    arithmetic whatever the strides), the outputs in the inputs' (B, S,
    H, D) memory, and a head slice of them read in place too."""
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).to(dtype).transpose(1, 2)
        for h in (H, KV, KV, H))
    qc, kc, vc, doc = (x.contiguous() for x in (q, k, v, do))
    o, lse = FA.flash_attention_fwd(q, k, v)
    oc, lsec = FA.flash_attention_fwd(qc, kc, vc)
    assert _same(o, oc) and _same(lse, lsec)
    assert o.transpose(1, 2).is_contiguous()
    g = FA.flash_attention_bwd(q, k, v, o, lse, do)
    gc = FA.flash_attention_bwd(qc, kc, vc, oc, lsec, doc)
    for x, y in zip(g, gc):
        assert _same(x, y) and x.transpose(1, 2).is_contiguous()
    # every other KV head and its query heads: a view with an offset
    sl = slice(KV // 2, KV) if KV > 1 else slice(0, 1)
    G = H // KV
    qs = q[:, sl.start * G:sl.stop * G]
    ks, vs = k[:, sl], v[:, sl]
    assert _same(FA.flash_attention(qs, ks, vs),
                 FA.flash_attention(*(x.contiguous() for x in (qs, ks, vs))))


@pytest.mark.parametrize("D", [40, 72, 96, 120, 160, 192])
@pytest.mark.parametrize("B,H,KV,S", [(2, 8, 2, 130), (1, 32, 8, 257)])
def test_flash_narrow_heads_read_in_place(dev, rng, D, B, H, KV, S):
    """bfloat16 head dims below the body's, multiples of 8, in the
    model's (B, S, H, D) layout: the kernel reads them in place (TMA
    zero-fills the body's columns past D), writes the output at its real
    width in `torch.empty_like(q)`'s memory, and launches no pad or copy
    around it; the answer is the plain version's (bfloat16 tolerance) and
    the zero-padded launch's bit for bit."""
    assert FA._forward_route(torch.bfloat16, D)[0] == "in place"
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).bfloat16().transpose(1, 2)
        for h in (H, KV, KV))
    before = _build.launches["flash_attention"]
    o = FA.flash_attention(q, k, v)
    assert _build.launches["flash_attention"] == before + 1
    e = torch.empty_like(q)
    assert o.stride() == e.stride() and o.shape == q.shape
    assert o.transpose(1, 2).is_contiguous()
    assert _same(o, FA.flash_attention(q, k, v))
    p = FA.flash_attention_plain(q, k, v)
    torch.testing.assert_close(o.float(), p.float(), atol=2e-2, rtol=2e-2)
    # the zero-padded launch at the same scale: the same bits
    Dp = FA._pad(D)
    qp, kp, vp = (torch.nn.functional.pad(x, (0, Dp - D)) for x in (q, k, v))
    op = torch.empty_like(qp)
    fn = _build.function("flash_attention", "flash_attention_launch",
                         [_build.P] * 6 + [_build.I] * 7
                         + [_build.F, _build.P])
    err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), op.data_ptr(),
             None, FA._strides(qp, kp, vp, op), B, H, KV, S, Dp, Dp, 1,
             D ** -0.5, _build.stream_of(dev))
    _build.check("flash_attention", err)
    assert _same(o, op[..., :D])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        FA.flash_attention(q, k, v)
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages()]
    assert not [n for n in names if "pad" in n or "copy" in n.lower()], names


@pytest.mark.parametrize("D", [160, 192, 256])
@pytest.mark.parametrize("B,H,KV,S", [
    (1, 2, 1, 1), (2, 8, 2, 385), (1, 4, 1, 1000), (1, 16, 16, 257),
    (4, 8, 2, 2048)])
def test_flash_wide_bf16_body(dev, rng, D, B, H, KV, S):
    """The D = 256 tensor-core body (bfloat16, 128 < D <= 256): on the
    views of the model's (B, S, H, D) tensors, read in place, with ragged
    S and with lse; against the plain version at the bfloat16 tolerance,
    lse within 1e-5 of the dense oracle's, two runs bit-equal and equal to
    the contiguous copies' run; one launch a call, and the launcher's
    schedule: 128-row items over key tiles of `TILES`, one persistent
    block an SM at most."""
    assert FA._forward_route(torch.bfloat16, D) == ("in place", 256)
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).bfloat16().transpose(1, 2)
        for h in (H, KV, KV))
    before = _build.launches["flash_attention"]
    o, lse = FA.flash_attention_fwd(q, k, v)
    o2, lse2 = FA.flash_attention_fwd(q, k, v)
    oc = FA.flash_attention(*(x.contiguous() for x in (q, k, v)))
    assert _build.launches["flash_attention"] == before + 3
    assert _same(o, o2) and _same(lse, lse2) and _same(o, oc)
    assert o.transpose(1, 2).is_contiguous() and o.shape == (B, H, S, D)
    p, plse = FA.flash_attention_plain(q, k, v, return_lse=True)
    torch.testing.assert_close(o.float(), p.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
    sch = FA._fwd_schedule(B, H, S, D, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (sch["rows"], sch["keys"]) == FA.TILES[torch.bfloat16][256]
    assert sch["items"] == B * H * -(-S // 128)
    assert sch["grid"] == min(sch["items"], sms)


@pytest.mark.parametrize("D", [160, 192, 256])
@pytest.mark.parametrize("B,H,KV,S", [(2, 8, 2, 130), (1, 16, 4, 1000),
                                      (4, 8, 2, 2048)])
def test_flash_wide_bwd_body(dev, rng, D, B, H, KV, S):
    """The backward's D = 256 tensor-core body (bfloat16, 128 < D <=
    256) on the views of the model's (B, S, H, D) tensors, read in place:
    the gradients of the contiguous copies bit for bit and in (B, S, H,
    D) memory, two runs bit-equal, within FLASH_TOL of the plain version;
    no pad or copy in a profile of one call; the launcher's schedule: an
    item per (batch x KV head, 64-key tile), one persistent block an SM
    at most."""
    assert FA._backward_route(torch.bfloat16, D) == ("in place", 256)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).bfloat16().transpose(1, 2)
        for h in (H, KV, KV, H))
    o, lse = FA.flash_attention_fwd(q, k, v)
    before = _build.launches["flash_attention_bwd"]
    g = FA.flash_attention_bwd(q, k, v, o, lse, do)
    g2 = FA.flash_attention_bwd(q, k, v, o, lse, do)
    gc = FA.flash_attention_bwd(*(x.contiguous() for x in (q, k, v, o)),
                                lse, do.contiguous())
    assert _build.launches["flash_attention_bwd"] == before + 3
    p = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for x, y, z, w in zip(g, g2, gc, p):
        assert _same(x, y) and _same(x, z)
        assert x.transpose(1, 2).is_contiguous() and x.shape == w.shape
        torch.testing.assert_close(x.float(), w.float(), atol=2e-2,
                                   rtol=2e-2)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        FA.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages()]
    assert not [n for n in names if "pad" in n or "copy" in n.lower()], names
    sch = FA._bwd_schedule(B, KV, S, D, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (sch["keys"], sch["queries"]) == FA.BWD_TILES[256]
    assert sch["items"] == B * KV * -(-S // 64)
    assert sch["grid"] == min(sch["items"], sms)


@pytest.mark.parametrize("D", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("B,H,KV,S", [(2, 8, 2, 130), (1, 16, 4, 1000),
                                      (1, 4, 1, 1), (2, 4, 4, 64)])
def test_flash_f32_bwd_body(dev, rng, D, B, H, KV, S):
    """The backward's float32 body (f32bwd; D = 96 zero-padded to 128) on
    the views of the model's (B, S, H, D) tensors: within FLASH_TOL of the
    plain version, two runs bit-equal, the gradients of contiguous copies
    bit for bit and in (B, S, H, D) memory; the launcher's schedule (an
    item per (batch x KV head, 64-key tile), one persistent block an SM at
    most); and the call's peak extra memory: its outputs, Delta, dq's
    accumulator (whole 64-row tiles) and counters, and at S = 1000, where
    the tiles are nearly full, below the outputs and simplebwd's scratch of
    (B H + 2 B KV) S D floats, which the route no longer allocates."""
    route = FA._backward_route(torch.float32, D)
    assert route == ("padded" if D == 96 else "in place", 128 if D == 96
                     else D)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).transpose(1, 2) for h in (H, KV, KV, H))
    o, lse = FA.flash_attention_fwd(q, k, v)
    before = _build.launches["flash_attention_bwd"]
    g = FA.flash_attention_bwd(q, k, v, o, lse, do)
    g2 = FA.flash_attention_bwd(q, k, v, o, lse, do)
    gc = FA.flash_attention_bwd(*(x.contiguous() for x in (q, k, v, o)),
                                lse, do.contiguous())
    assert _build.launches["flash_attention_bwd"] == before + 3
    p = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    tol = FLASH_TOL[torch.float32]
    for x, y, z, w in zip(g, g2, gc, p):
        assert x.dtype == torch.float32 and x.shape == w.shape
        assert _same(x, y) and _same(x, z)
        if route[0] == "in place":
            assert x.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(x, w, atol=tol, rtol=tol)
    sch = FA._bwd_schedule(B, KV, S, D, dev, torch.float32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (sch["keys"], sch["queries"]) == FA.BWD_F32_TILES
    assert sch["items"] == B * KV * -(-S // 64)
    assert sch["grid"] == min(sch["items"], sms)
    del g, g2, gc, p
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = FA.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    del out
    Dp = route[1]
    outputs = 4 * (B * H + 2 * B * KV) * S * D
    # padded: q, o, dO, k, v and the gradients at the body's width
    pads = 4 * (4 * B * H + 4 * B * KV) * S * Dp if route[0] == "padded" \
        else 0
    nq = B * H * -(-S // 64)
    ours = outputs + pads + 4 * B * H * S + 4 * nq * 64 * Dp + 4 * (nq + 1)
    old_scratch = 4 * (B * H + 2 * B * KV) * S * Dp
    assert extra <= ours + (2 << 20), (extra, ours)
    if route[0] == "in place" and S >= 1000:    # tiles nearly full
        assert extra < outputs + old_scratch, (extra, outputs, old_scratch)
    # float32 rows the body's TMA cannot read: a row stride that is no
    # multiple of 16 bytes
    x = torch.zeros((1, 4, 64, D + 1), device=dev)[..., :D]
    lse_x = torch.zeros((1, 4, 64), device=dev)
    if route[0] == "in place":
        with pytest.raises(ValueError, match="multiple of 16 bytes"):
            FA.flash_attention_bwd(x, x, x, x, lse_x, x)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [264, 320, 512, 768, 2048, 2304, 4160])
@pytest.mark.parametrize("B,H,KV,S", [(1, 4, 2, 100), (2, 8, 2, 385)])
def test_flash_cluster_bwd_body(dev, rng, dtype, D, B, H, KV, S):
    """The cluster backward (every D > 256: clusters of C blocks, each on
    256-column slices, in G walks, `cluster_walks`; 264 and 320 with a
    ragged last slice, 768 three blocks, 2048 eight, 2304 two walks of
    five, 4160 three walks of six) on the views of the model's (B,
    S, H, D) tensors, S ragged against the tiles: within FLASH_TOL of the
    plain version, two runs bit-equal and equal to the contiguous copies'
    run, the gradients in (B, S, H, D) memory, one launch count a call;
    the launcher's schedule (the D = 256 body's items and tiles, C blocks
    a cluster, a grid of C x min(items, the clusters the card holds));
    and the call's peak extra memory: its outputs, Delta, the slices'
    accumulators (a ragged last slice's only as wide as its columns) and
    counters, below the outputs and simplebwd's scratch of (B H + 2 B KV)
    S D floats, which the route no longer allocates."""
    assert FA._backward_route(dtype, D) == ("cluster", D)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).to(dtype).transpose(1, 2)
        for h in (H, KV, KV, H))
    o, lse = FA.flash_attention_fwd(q, k, v)
    before = _build.launches["flash_attention_bwd"]
    g = FA.flash_attention_bwd(q, k, v, o, lse, do)
    g2 = FA.flash_attention_bwd(q, k, v, o, lse, do)
    gc = FA.flash_attention_bwd(*(x.contiguous() for x in (q, k, v, o)),
                                lse, do.contiguous())
    assert _build.launches["flash_attention_bwd"] == before + 3
    p = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    tol = FLASH_TOL[dtype]
    for x, y, z, w in zip(g, g2, gc, p):
        assert x.dtype == dtype and x.shape == w.shape
        assert _same(x, y) and _same(x, z)
        assert x.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(x.float(), w.float(), atol=tol, rtol=tol)
    sch = FA._bwd_schedule(B, KV, S, D, dev, dtype)
    kt, qt = (FA.BWD_TILES[256] if dtype == torch.bfloat16
              else FA.BWD_F32_WIDE_TILES)
    C, G = FA.cluster_walks(D)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (sch["keys"], sch["queries"], sch["C"], sch["G"]) == (kt, qt, C, G)
    assert sch["items"] == B * KV * -(-S // kt)
    assert 1 <= sch["clusters"] <= sch["items"]
    assert sch["grid"] == C * sch["clusters"] <= sms
    del g, g2, gc, p
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = FA.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    del out
    esz = q.element_size()
    outputs = esz * (B * H + 2 * B * KV) * S * D
    nq = B * H * -(-S // qt)
    acc_cols = FA._bwd_acc_columns(dtype, D)    # each slice's dq tiles
    assert acc_cols == (-(-D // 64) * 64 if dtype == torch.bfloat16 else D)
    ours = (outputs + 4 * B * H * S + 4 * nq * qt * acc_cols
            + 4 * (C * G * nq + G))
    old_scratch = 4 * (B * H + 2 * B * KV) * S * D
    assert extra <= ours + (2 << 20), (extra, ours)
    assert extra < outputs + old_scratch, (extra, outputs, old_scratch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [264, 320, 512, 768, 2048, 2304, 4160])
@pytest.mark.parametrize("B,H,KV,S", [(1, 4, 4, 70), (1, 4, 2, 130),
                                      (2, 4, 1, 1), (2, 8, 2, 385)])
def test_flash_cluster_fwd_body(dev, rng, dtype, D, B, H, KV, S):
    """The cluster forward (every D > 256: clusters of C blocks, each its
    dtype's D = 256 body on 256-column slices, in G walks,
    `cluster_walks`; 264 and 320 with a ragged last slice, 768 three
    blocks, 2048 eight, 2304 two walks of five, 4160 three of six) on the
    views of the model's (B, S, H, D) tensors, MHA, GQA and MQA, S ragged
    against the tiles and S = 1: within FLASH_TOL of the plain version,
    lse within 1e-5 of the dense oracle's, two runs bit-equal and equal to
    the contiguous copies' run, the output in (B, S, H, D) memory, one
    launch count a call; the launcher's schedule (the D = 256 body's items
    and tiles, C blocks a cluster, a grid of C x min(items, the clusters
    the card holds)); and the stream's ticket counter left at zero: the
    output after 20 calls is the first's, and a D = 128 launch after them
    still takes every item."""
    assert FA._forward_route(dtype, D) == ("cluster", D)
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).to(dtype).transpose(1, 2)
        for h in (H, KV, KV))
    before = _build.launches["flash_attention"]
    o = FA.flash_attention(q, k, v)
    o2 = FA.flash_attention(q, k, v)
    oc = FA.flash_attention(*(x.contiguous() for x in (q, k, v)))
    o3, lse = FA.flash_attention_fwd(q, k, v)
    assert _build.launches["flash_attention"] == before + 4
    p, plse = FA.flash_attention_plain(q, k, v, return_lse=True)
    tol = FLASH_TOL[dtype]
    assert o.dtype == dtype and o.shape == (B, H, S, D)
    assert _same(o, o2) and _same(o, oc) and _same(o, o3)
    assert o.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(o.float(), p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
    sch = FA._fwd_schedule(B, H, S, D, dev, dtype)
    rows, keys = FA.TILES[dtype][256]
    C, G = FA.cluster_walks(D)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (sch["rows"], sch["keys"], sch["C"], sch["G"]) == (rows, keys, C,
                                                              G)
    assert sch["items"] == B * H * -(-S // rows)
    assert 1 <= sch["clusters"] <= sch["items"]
    assert sch["grid"] == C * sch["clusters"] <= sms
    for _ in range(20):
        last = FA.flash_attention(q, k, v)
    assert _same(last, o)
    # the counter is the stream's, shared with every persistent forward
    # (bfloat16 D = 128, float32 D = 256)
    D1 = 128 if dtype == torch.bfloat16 else 256
    q1, k1, v1 = (torch.as_tensor(rng.normal(size=(B, h, 300, D1)).astype(
        np.float32), device=dev).to(dtype) for h in (H, KV, KV))
    torch.testing.assert_close(FA.flash_attention(q1, k1, v1).float(),
                               FA.flash_attention_plain(q1, k1, v1).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [132, 160, 200, 256])
@pytest.mark.parametrize("B,H,KV,S", [(1, 2, 1, 1), (2, 8, 2, 385),
                                      (1, 4, 1, 1000), (2, 16, 4, 257)])
def test_flash_f32_wide_bodies(dev, rng, D, B, H, KV, S):
    """The float32 bodies at 128 < D <= 256 (f32wide forward, f32widebwd
    backward; D % 4 == 0 read in place, 132 too, 130 would be padded) on
    the views of the model's (B, S, H, D) tensors: within FLASH_TOL of the
    plain versions, lse within 1e-5 of the dense oracle's, two runs
    bit-equal and equal to the contiguous copies' run, outputs in (B, S,
    H, D) memory; the launchers' schedules: 64-row forward items and
    32-key backward items, one persistent block an SM at most."""
    assert FA._forward_route(torch.float32, D) == ("in place", 256)
    assert FA._backward_route(torch.float32, D) == ("in place", 256)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).transpose(1, 2) for h in (H, KV, KV, H))
    qc, kc, vc, doc = (x.contiguous() for x in (q, k, v, do))
    before = dict(_build.launches)
    o, lse = FA.flash_attention_fwd(q, k, v)
    o2, lse2 = FA.flash_attention_fwd(q, k, v)
    oc = FA.flash_attention(qc, kc, vc)
    g = FA.flash_attention_bwd(q, k, v, o, lse, do)
    g2 = FA.flash_attention_bwd(q, k, v, o, lse, do)
    gc = FA.flash_attention_bwd(qc, kc, vc, o.contiguous(), lse, doc)
    assert _build.launches["flash_attention"] == \
        before["flash_attention"] + 3
    assert _build.launches["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 3
    assert _same(o, o2) and _same(lse, lse2) and _same(o, oc)
    assert o.transpose(1, 2).is_contiguous() and o.shape == (B, H, S, D)
    tol = FLASH_TOL[torch.float32]
    p, plse = FA.flash_attention_plain(q, k, v, return_lse=True)
    torch.testing.assert_close(o, p, atol=tol, rtol=tol)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
    pg = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for x, y, z, w in zip(g, g2, gc, pg):
        assert x.dtype == torch.float32 and x.shape == w.shape
        assert _same(x, y) and _same(x, z)
        assert x.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(x, w, atol=tol, rtol=tol)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sch = FA._fwd_schedule(B, H, S, D, dev, torch.float32)
    assert (sch["rows"], sch["keys"]) == FA.TILES[torch.float32][256]
    assert sch["items"] == B * H * -(-S // 64)
    assert sch["grid"] == min(sch["items"], sms)
    sch = FA._bwd_schedule(B, KV, S, D, dev, torch.float32)
    assert (sch["keys"], sch["queries"]) == FA.BWD_F32_WIDE_TILES
    assert sch["items"] == B * KV * -(-S // 32)
    assert sch["grid"] == min(sch["items"], sms)

def test_prefill_runs_the_kernel_once_per_layer(dev):
    """Reduced yi-6b on the card: prefill's self-attention is the kernel
    in every layer, and its logits equal the dense path's (float32)."""
    cfg = get_config("yi-6b").reduced()
    params = TM.init_params(cfg, 0, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    _build.reset_launches()
    with torch.inference_mode():
        pl, _ = TM.prefill(cfg, params, {"tokens": toks})
        assert _build.launches["flash_attention"] == cfg.n_layers
        full, _ = TM.forward_logits(cfg, params, toks, impl="full")
    torch.testing.assert_close(pl, TM._mask_padded_vocab(cfg, full[:, -1]),
                               atol=1e-3, rtol=0)


def test_danube_prefill_attention_runs_the_kernel(dev, rng):
    """h2o-danube-3-4b's heads (32 / 8, D = 120, window 4096) at S =
    2048: the window masks nothing, so self-attention launches the
    kernel, and it equals the plain windowed path (bfloat16 tolerance)."""
    from repro_torch.models import attention as A
    cfg = get_config("h2o-danube-3-4b")
    S = 2048
    assert A.flash_kernel_takes(cfg, S)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, S, h, cfg.head_dim))
                               .astype(np.float32), device=dev).bfloat16()
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    pos = torch.arange(S, device=dev)
    before = _build.launches["flash_attention"]
    o = A.self_attention(cfg, q, k, v, pos, pos, impl="flash")
    assert _build.launches["flash_attention"] == before + 1
    p = A.attn_flash(q, k, v, pos, pos, causal=True, window=cfg.swa_window,
                     q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk)
    assert _build.launches["flash_attention"] == before + 1
    torch.testing.assert_close(o.float(), p.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch,launches", [
    ("qwen2-moe-a2.7b", 4), ("zamba2-1.2b", 2), ("whisper-medium", 2)])
def test_family_prefill_runs_the_kernel(dev, arch, launches):
    """Reduced MoE, zamba2 (the shared block, once per group) and whisper
    (the decoder's causal self-attention) on the card: prefill launches
    the kernel where the family has causal self-attention, and its logits
    equal the dense path's (float32)."""
    cfg = get_config(arch).reduced()
    params = TM.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev, generator=gen)
    batch = {"tokens": toks}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                      device=dev, generator=gen)
    _build.reset_launches()
    with torch.inference_mode():
        pl, _ = TM.prefill(cfg, params, batch)
        assert _build.launches["flash_attention"] == launches
        full, _ = TM.forward_logits(cfg, params, toks,
                                    frames=batch.get("frames"), impl="full")
    torch.testing.assert_close(pl, TM._mask_padded_vocab(cfg, full[:, -1]),
                               atol=1e-3, rtol=0)


def test_plain_scatter_has_the_kernels_bits(dev, rng):
    """The plain version adds in packed order on the card too
    (`core.gee._add_by_rank`): the kernel's bits exactly."""
    n, m, K = 3000, 60000, 8
    dst = torch.as_tensor(rng.zipf(1.5, m) % n, device=dev)
    cls = torch.as_tensor(rng.integers(0, K, m), device=dev)
    val = torch.as_tensor(rng.random(m, dtype=np.float32), device=dev)
    row_ptr, clsb, valb, T = pack_edges(dst, cls, val, n, 256)
    kw = dict(num_tiles=T, tile_n=256, kdim=K)
    assert _same(GS.gee_scatter(row_ptr, clsb, valb, **kw),
                 GS.gee_scatter_plain(row_ptr, clsb, valb, **kw))


@pytest.mark.parametrize("p", [1, 2])
def test_ivf_nprobe_K_equals_exact_on_the_card(dev, rng, p):
    """The engine on the card (backend cuda): ivf at nprobe = K gives the
    exact scan's bits, before and after a delta."""
    from repro_torch.graph import make_labels, sbm
    from repro_torch.serving import GraphStore, ServingEngine
    g, truth = sbm(3000, 6, 40_000, seed=1)
    Y = make_labels(3000, 6, 0.2, np.random.default_rng(0),
                    true_labels=truth)
    eng = ServingEngine(GraphStore(g, Y, 6), num_shards=p, backend="cuda",
                        plan_cache=None, index="ivf", device=dev)
    nodes = rng.integers(0, 3000, 64).astype(np.int32)
    for _ in range(2):
        ex = eng.query_topk(nodes, k=10)
        iv = eng.query_topk(nodes, k=10, mode="ivf", nprobe=6)
        assert np.array_equal(ex[0], iv[0]) and np.array_equal(ex[1], iv[1])
        eng.apply_edge_delta(rng.integers(0, 3000, 200).astype(np.int32),
                             rng.integers(0, 3000, 200).astype(np.int32),
                             np.ones(200, np.float32))


def test_plan_cache_hit_on_the_card(dev, tmp_path):
    """A cuda-backend plan stored from the card and loaded back gives
    the same Z bits."""
    from repro_torch.encoder import Embedder, EncoderConfig
    from repro_torch.graph import make_labels, sbm
    g, truth = sbm(5000, 8, 60_000, seed=2)
    Y = make_labels(5000, 8, 0.1, np.random.default_rng(0),
                    true_labels=truth)
    a = Embedder(EncoderConfig(K=8), backend="cuda", device=dev,
                 plan_cache=tmp_path).fit(g, Y)
    b = Embedder(EncoderConfig(K=8), backend="cuda", device=dev,
                 plan_cache=tmp_path).fit(g, Y)
    assert a.plan_stats["disk_stores"] == 1 and b.plan_stats["disk_hits"] == 1
    assert _same(a.Z_, b.Z_)


def test_socket_engine_workers_run_the_kernels_on_the_card(dev, rng,
                                                           monkeypatch):
    """A 2-worker socket engine on the card: each worker reports a cuda
    device and launches of the three GEE kernels in `ping`, and the
    engine's Z and answers equal the in-process cuda engine's bits."""
    from repro_torch.graph import make_labels, sbm
    from repro_torch.serving import GraphStore, ServingEngine
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    g, truth = sbm(3000, 6, 40_000, seed=4)
    Y = make_labels(3000, 6, 0.2, np.random.default_rng(0),
                    true_labels=truth)
    local = ServingEngine(GraphStore(g, Y, 6), num_shards=2,
                          backend="cuda", plan_cache=None, device=dev)
    sock = ServingEngine(GraphStore(g, Y, 6), num_shards=2, backend="cuda",
                         plan_cache=None, device=dev, transport="socket")
    try:
        nodes = rng.integers(0, 3000, 64).astype(np.int32)
        for _ in range(2):
            a, b = (e.query_topk(nodes, k=10) for e in (local, sock))
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            d = (rng.integers(0, 3000, 200).astype(np.int32),
                 rng.integers(0, 3000, 200).astype(np.int32),
                 np.ones(200, np.float32))
            for e in (local, sock):
                e.apply_edge_delta(*d)
        assert _same(local.Z, sock.Z)
        for s in sock.shards:
            ping = s.ping()
            assert ping["device"].startswith("cuda")
            for name in ("gee_scatter", "gee_delta_renorm", "topk_fused"):
                assert ping["launches"][name] > 0, (ping, name)
    finally:
        sock.close()
        local.close()


# ---------------------------------------------------------------------------
# training: the kernel's forward under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 120, 128])
def test_flash_function_gradients(dev, rng, dtype, D):
    """`FlashAttentionFunction`: one forward and one backward kernel
    launch, the output at the kernel's tolerance from the plain
    attention's, and dq, dk, dv (its backward is the backward kernel)
    within the kernel's tolerance of their largest entry from
    `flash_attention_bwd_plain` on the kernel's (o, lse), and from
    autograd of the dense oracle."""
    from repro_torch.models import attention as TA
    B, H, KV, S, chunk = 2, 8, 2, 256, 64
    arrs = [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (H, KV, KV)]
    w = torch.as_tensor(rng.normal(size=(B, S, H, D)).astype(np.float32),
                        device=dev)

    def run(fn):
        ins = [torch.as_tensor(a, device=dev).to(dtype).requires_grad_()
               for a in arrs]
        o = fn(*ins)
        (o.float() * w).sum().backward()
        return o.detach(), [t.grad for t in ins]

    before = dict(_build.launches)
    ok, gk = run(lambda q, k, v: TA.FlashAttentionFunction.apply(
        q, k, v))
    assert _build.launches["flash_attention"] == \
        before["flash_attention"] + 1
    assert _build.launches["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    op, _ = run(lambda q, k, v: TA.causal_plain(q, k, v, chunk))
    qt, kt, vt = (torch.as_tensor(a, device=dev).to(dtype).transpose(
        1, 2).contiguous() for a in arrs)
    o, lse = FA.flash_attention_fwd(qt, kt, vt)
    dot = w.to(dtype).transpose(1, 2).contiguous()
    gp = [g.transpose(1, 2) for g in FA.flash_attention_bwd_plain(
        qt, kt, vt, o, lse, dot)]
    od, gd = run(lambda q, k, v: FA.flash_attention_plain(
        *(x.transpose(1, 2) for x in (q, k, v))).transpose(1, 2))
    tol = FLASH_TOL[dtype]
    assert ok.dtype == dtype
    torch.testing.assert_close(ok.float(), op.float(), atol=tol, rtol=tol)
    for a, b, c in zip(gk, gp, gd):
        assert a.dtype == dtype
        top = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol * top
        assert (a.float() - c.float()).abs().max().item() <= tol * top


def test_training_reaches_every_attention_weight(dev):
    """Reduced yi-6b trained on the card: the kernel runs in every layer
    (no remat in the reduced config), the loss equals the dense path's,
    and every attention weight gets a gradient."""
    from repro_torch.training.trees import items
    cfg = get_config("yi-6b").reduced()
    params = TM.init_params(cfg, 0, device=dev)
    params.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    _build.reset_launches()
    loss, _ = TM.forward_train(cfg, params, {"tokens": toks})
    assert _build.launches["flash_attention"] == cfg.n_layers
    paths, leaves = zip(*items(params))
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    for name in ("wq", "wk", "wv", "wo"):
        assert grads[("stack", "attn", name)].abs().max().item() > 0, name
    with torch.no_grad():
        full, _ = TM.forward_train(cfg, params, {"tokens": toks},
                                   impl="full")
    torch.testing.assert_close(loss, full, atol=1e-4, rtol=1e-5)


def test_gee_wrappers_refuse_inputs_that_require_grad(dev):
    """The GEE kernels have no backward: a float input that requires grad
    raises instead of giving an output cut from the graph."""
    z = torch.zeros((8, 4), device=dev, requires_grad=True)
    q = torch.zeros((2, 4), device=dev)
    qn = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="no gradient"):
        QF.topk_fused(z, q, qn, k=2)
    with pytest.raises(TypeError, match="no gradient"):
        QF.gee_delta_renorm(z, qn, qn, qn.float())
    row_ptr = torch.tensor([0, 1, 2, 3, 4], device=dev)
    c = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="no gradient"):
        GS.gee_scatter(row_ptr, c, c.float().requires_grad_(), num_tiles=1,
                       tile_n=4, kdim=2)


@pytest.mark.parametrize("K,k", [(16, 10), (6, 3), (300, 10), (16, 100)])
def test_topk_select_grid_cap_keeps_the_bits(dev, rng, K, k):
    """Every cap on the select pass's grid (the tuner's knob) gives the
    uncapped answer bit for bit, on the fast bodies and the general
    path (K > 256 or k > 64)."""
    m = 40_000
    Zn = QF.normalize_rows(torch.as_tensor(
        rng.normal(size=(m, K)).astype(np.float32), device=dev))
    qn = torch.as_tensor(rng.integers(0, m, 32).astype(np.int32), device=dev)
    q = Zn[qn.long()].contiguous()
    ref = QF.topk_fused(Zn, q, qn, k=k)
    plain = QF.topk_fused_plain(Zn, q, qn, k=k)
    assert all(_same(a, b) for a, b in zip(ref, plain))
    for cap in (1, 2, 3, 7, 32, 64, 100, 1000, 1 << 20):
        got = QF.topk_fused(Zn, q, qn, k=k, max_grid=cap)
        assert all(_same(a, b) for a, b in zip(got, ref)), cap


@pytest.mark.parametrize("mode", ["replicated", "reduce_scatter", "a2a",
                                  "ring"])
def test_one_rank_nccl_gee_distributed_equals_the_cuda_fit(dev, rng, mode):
    """A one-rank NCCL group on the card: every mode's Z within 1e-5 of
    the cuda backend's (the gee_scatter kernel), nothing dropped."""
    from repro_torch.core import distributed as D
    from repro_torch.encoder import Embedder, EncoderConfig
    from repro_torch.graph import erdos_renyi, make_labels
    g = erdos_renyi(20_000, 300_000, seed=5, weighted=True)
    Y = make_labels(g.n, 16, 0.1, np.random.default_rng(5))
    ref = Embedder(EncoderConfig(K=16), backend="cuda",
                   plan_cache=None).fit(g, Y).transform()
    mesh = D.edge_mesh("cuda")
    try:
        Z, dropped = D.gee_distributed(g, Y, K=16, mode=mode, mesh=mesh)
        emb = Embedder(EncoderConfig(K=16), backend=f"distributed:{mode}",
                       mesh=mesh, plan_cache=None).fit(g, Y)
        assert emb.last_info_ == {"dropped": 0}
        np.testing.assert_allclose(emb.transform(), ref, atol=1e-5)
    finally:
        D.destroy_local_group()
    assert dropped == 0
    np.testing.assert_allclose(Z, ref, atol=1e-5)


# ---------------------------------------------------------------------------
# sharded attention: the kernel on one model rank's local heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,model", [(32, 4, 16), (12, 3, 2), (8, 8, 4),
                                        (32, 4, 4)])
def test_flash_on_local_heads(dev, rng, dtype, H, KV, model):
    """What `attention._on_local_heads` hands the kernel on each model
    rank: its query heads and the KV heads they read
    (`local_kv_heads`).  yi-6b's 32 / 4 heads on 16 ranks: 2 query heads
    and their one KV head (local group 2); 12 / 3 on 2: an index per
    head (group 1); 8 / 8 and 32 / 4 on 4: whole groups.  The kernel
    equals its plain version on the same heads, and the whole
    attention's slice, at the kernel's tolerance."""
    from repro_torch.models import attention as TA
    B, S, D, chunk = 1, 257, 128, 64
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).to(dtype) for h in (H, KV, KV))
    whole = TA.causal_plain(q, k, v, chunk)
    per = H // model
    tol = FLASH_TOL[dtype]
    before = _build.launches["flash_attention"]
    for r in range(model):
        heads = range(r * per, (r + 1) * per)
        sel = TA.local_kv_heads(heads, H, KV)
        ql, kl, vl = q[:, :, r * per:(r + 1) * per], k[:, :, sel], \
            v[:, :, sel]
        got = TA._flash_kernel(ql, kl, vl)
        torch.testing.assert_close(got.float(), TA.causal_plain(
            ql, kl, vl, chunk).float(), atol=tol, rtol=tol)
        torch.testing.assert_close(got.float(), whole[:, :, heads].float(),
                                   atol=tol, rtol=tol)
    assert _build.launches["flash_attention"] == before + model
