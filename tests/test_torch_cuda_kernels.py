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


@pytest.mark.parametrize("K", [129, 200, 512])
def test_gee_delta_renorm_wide(dev, rng, K):
    """K > 128 works on its rows in device memory: Z_new and Zn have the
    plain version's bits (run on the host, where `index_put_` adds in
    list order)."""
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


# the general select path: K > 256 or k > 64 (any other shape is the
# register or shared-memory body), k beyond the candidates included
TOPK_WIDE_SHAPES = [
    (257, 3000, 65, 10, 3), (300, 5000, 64, 10, 7), (512, 2000, 3, 64, 2),
    (16, 70001, 64, 65, 7), (16, 5000, 64, 100, 3), (8, 3000, 5, 256, 4),
    (300, 1500, 64, 100, 5), (16, 40, 7, 100, 2), (300, 3, 4, 70, 1),
    (300, 3, 4, 8, 1)]


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
    # head dims above 128: the wide body (D in chunks of 128, ragged S)
    (1, 4, 2, 100, 160), (2, 4, 1, 130, 256), (1, 2, 2, 33, 200),
    (1, 8, 8, 1, 384)])
def test_flash_attention(dev, rng, dtype, B, H, KV, S, D):
    q, k, v = (torch.as_tensor(rng.normal(size=(B, h, S, D)).astype(
        np.float32), device=dev).to(dtype) for h in (H, KV, KV))
    before = _build.launches["flash_attention"]
    a = FA.flash_attention(q, k, v)
    b = FA.flash_attention(q, k, v)
    p = FA.flash_attention_plain(q, k, v)
    assert _build.launches["flash_attention"] == before + 2
    assert a.dtype == dtype and _same(a, b)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(a.float(), p.float(), atol=tol, rtol=tol)


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
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros((1, 64, 4, 32), device=dev).transpose(1, 2)
        FA.flash_attention(x, x, x)


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
    """`FlashAttentionFunction`: one kernel launch forward, the output
    at the kernel's tolerance from the plain attention's, and dq, dk, dv
    (its backward recomputes `causal_plain` on the saved inputs) equal to
    autograd of `causal_plain` within 1e-6 of their largest entry, and
    within the kernel's tolerance of autograd of the dense oracle."""
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

    before = _build.launches["flash_attention"]
    ok, gk = run(lambda q, k, v: TA.FlashAttentionFunction.apply(
        q, k, v, chunk))
    assert _build.launches["flash_attention"] == before + 1
    op, gp = run(lambda q, k, v: TA.causal_plain(q, k, v, chunk))
    od, gd = run(lambda q, k, v: FA.flash_attention_plain(
        *(x.transpose(1, 2) for x in (q, k, v))).transpose(1, 2))
    tol = FLASH_TOL[dtype]
    assert ok.dtype == dtype
    torch.testing.assert_close(ok.float(), op.float(), atol=tol, rtol=tol)
    for a, b, c in zip(gk, gp, gd):
        assert a.dtype == dtype
        top = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 1e-6 * top
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
