"""repro_torch.encoder.plan_cache: the reference's persistent plan-cache
contracts (`tests/test_plan_cache.py`) on the port's cache, on the CPU.

  * a second process embedding the same graph gets a persistent hit
    (counters from real subprocesses);
  * writes are atomic and leave no tmp files; a stale entry is a miss; a
    corrupt entry is deleted and rebuilt; an unwritable directory never
    breaks a fit;
  * LRU eviction by count and by bytes, hits refreshing recency;
  * the CLI;
  * a port entry and a reference entry in one directory never hit each
    other (the port's metadata carries a package tag).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.encoder import Embedder as JEmbedder
from repro.encoder import EncoderConfig as JConfig
from repro.graph.edges import Graph as JGraph
from repro_torch.core.ref_python import gee_numpy
from repro_torch.encoder import Embedder, EncoderConfig, get_backend
from repro_torch.encoder.plan_cache import (PlanDiskCache, config_token,
                                            default_cache, main)
from repro_torch.graph import erdos_renyi, make_labels
from repro_torch.graph.io import save_graph

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(tile_n=64)

CHILD = r"""
import json, sys
import numpy as np
from repro_torch.encoder import Embedder, EncoderConfig
from repro_torch.graph import make_labels
from repro_torch.graph.sources import SnapshotSource

src = SnapshotSource(sys.argv[1])
g = src.graph()
Y = make_labels(g.n, 5, 0.4, np.random.default_rng(0))
emb = Embedder(EncoderConfig(K=5, tile_n=64), backend=sys.argv[2],
               device="cpu")
emb.fit(src, Y)
print(json.dumps({"stats": emb.plan_stats,
                  "z": emb.transform().tolist()}))
"""


def _run_child(snapshot: str, cache_dir: str, backend: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_PLAN_CACHE=cache_dir)
    out = subprocess.run([sys.executable, "-c", CHILD, snapshot, backend],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("backend", ["cuda", "streaming"])
def test_second_process_gets_persistent_hit(tmp_path, backend):
    g = erdos_renyi(130, 700, seed=2, weighted=True)
    snap = str(tmp_path / "g.npz")
    save_graph(snap, g)
    cache = str(tmp_path / "plans")
    first = _run_child(snap, cache, backend)
    assert first["stats"] == {"built": 1, "hits": 0, "disk_hits": 0,
                              "disk_stores": 1}
    second = _run_child(snap, cache, backend)
    assert second["stats"] == {"built": 0, "hits": 0, "disk_hits": 1,
                               "disk_stores": 0}
    assert np.array_equal(np.float32(second["z"]), np.float32(first["z"]))


def _fit(cache, g, Y, K=5, backend="cuda", **cfg):
    emb = Embedder(EncoderConfig(K=K, **CFG, **cfg), backend=backend,
                   device="cpu", plan_cache=cache)
    return emb.fit(g, Y)


def _data(n=90, s=400, K=5, seed=4):
    g = erdos_renyi(n, s, seed=seed, weighted=True)
    return g, make_labels(n, K, 0.4, np.random.default_rng(1))


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda", "streaming"])
@pytest.mark.parametrize("cfg", [{}, {"laplacian": True},
                                 {"row_partition": (20, 70)}])
def test_disk_hit_gives_the_same_z(tmp_path, backend, cfg):
    g, Y = _data()
    a = _fit(tmp_path, g, Y, backend=backend, **cfg)
    b = _fit(tmp_path, g, Y, backend=backend, **cfg)
    assert a.plan_stats["disk_stores"] == 1
    assert b.plan_stats == {"built": 0, "hits": 0, "disk_hits": 1,
                            "disk_stores": 0}
    assert torch.equal(a.Z_, b.Z_)


def test_cuda_host_half_is_the_row_offset_layout(tmp_path):
    g, Y = _data()
    emb = _fit(tmp_path, g, Y)
    [entry] = PlanDiskCache(tmp_path).entries()
    with np.load(entry) as d:
        assert sorted(d.files) == ["T", "__meta__", "row_ptr", "src",
                                   "w_packed"]
        assert d["row_ptr"].dtype == np.int64
        assert d["src"].shape == (2 * g.s,)
        assert np.array_equal(d["row_ptr"], emb._plan.data["row_ptr"])


def test_corrupt_entry_falls_back_to_rebuild(tmp_path):
    g, Y = _data()
    _fit(tmp_path, g, Y)
    [entry] = list(Path(tmp_path).glob("*.npz"))
    entry.write_bytes(b"not an npz at all")
    emb = _fit(tmp_path, g, Y)                 # must not crash
    assert emb.plan_stats == {"built": 1, "hits": 0, "disk_hits": 0,
                              "disk_stores": 1}
    np.testing.assert_allclose(emb.transform(),
                               gee_numpy(g.u, g.v, g.w, Y, 5, g.n),
                               atol=1e-5)
    assert _fit(tmp_path, g, Y).plan_stats["disk_hits"] == 1


def test_stale_entry_is_a_miss(tmp_path):
    g, Y = _data()
    _fit(tmp_path, g, Y)
    cache = PlanDiskCache(tmp_path)
    meta = cache.describe(g.fingerprint(), get_backend("cuda"),
                          EncoderConfig(K=5, **CFG))
    path = cache.path(meta)
    with np.load(path, allow_pickle=False) as d:
        host = {k: d[k] for k in d.files if k != "__meta__"}
    doctored = dict(meta, plan_version=meta["plan_version"] + 1)
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.asarray(json.dumps(doctored)), **host)
    assert cache.load(meta) is None
    emb = _fit(tmp_path, g, Y)
    assert emb.plan_stats["built"] == 1
    np.testing.assert_allclose(emb.transform(),
                               gee_numpy(g.u, g.v, g.w, Y, 5, g.n),
                               atol=1e-5)


def test_atomic_writes_leave_no_tmp_droppings(tmp_path):
    g, Y = _data(60, 200, 3, 1)
    _fit(tmp_path, g, Y, K=3)
    names = [p.name for p in Path(tmp_path).iterdir()]
    assert len(names) == 1 and not any(".tmp" in x for x in names)


def test_unwritable_cache_never_breaks_embedding(tmp_path):
    target = tmp_path / "blocked"
    target.write_text("a file where the cache dir should go")
    g, Y = _data(60, 200, 3, 1)
    emb = _fit(target, g, Y, K=3)
    assert emb.plan_stats["built"] == 1
    assert emb.plan_stats["disk_stores"] == 0


def test_clear_and_entries(tmp_path):
    g, Y = _data(60, 200, 3, 1)
    _fit(tmp_path, g, Y, K=3)
    _fit(tmp_path, g, Y, K=4)
    cache = PlanDiskCache(tmp_path)
    assert len(cache.entries()) == 2
    assert cache.clear() == 2 and cache.entries() == []


def test_default_cache_env_resolution(monkeypatch, tmp_path):
    for off in ("off", "0", "", "none", "DISABLED"):
        monkeypatch.setenv("REPRO_PLAN_CACHE", off)
        assert default_cache() is None
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "p"))
    assert default_cache().root == tmp_path / "p"
    monkeypatch.delenv("REPRO_PLAN_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert default_cache().root == (tmp_path / "xdg" / "repro-gee-torch"
                                    / "plans")


def test_port_and_reference_entries_never_hit_each_other(tmp_path):
    """Both packages pointed at one directory: the same graph, config
    and backend NAME ("streaming" is in both) give two entries, and
    each package hits only its own."""
    g, Y = _data()
    jg = JGraph(g.u, g.v, g.w, g.n)
    assert g.fingerprint() == jg.fingerprint()
    cfg = dict(K=5, tile_n=64, row_partition=(10, 80))
    port = Embedder(EncoderConfig(**cfg), backend="streaming",
                    device="cpu", plan_cache=tmp_path).fit(g, Y)
    ref = JEmbedder(JConfig(**cfg), backend="streaming",
                    plan_cache=tmp_path).fit(jg, Y)
    assert port.plan_stats["disk_stores"] == 1
    assert ref.plan_stats["disk_stores"] == 1     # a miss, not a hit
    assert len(PlanDiskCache(tmp_path).entries()) == 2
    port2 = Embedder(EncoderConfig(**cfg), backend="streaming",
                     device="cpu", plan_cache=tmp_path).fit(g, Y)
    ref2 = JEmbedder(JConfig(**cfg), backend="streaming",
                     plan_cache=tmp_path).fit(jg, Y)
    assert port2.plan_stats["disk_hits"] == 1
    assert ref2.plan_stats["disk_hits"] == 1
    np.testing.assert_allclose(port2.transform(), ref2.transform(),
                               atol=1e-5)
    with np.load(PlanDiskCache(tmp_path).entries()[0]) as d:
        packages = {json.loads(str(d["__meta__"][()])).get("package")}
    assert packages <= {"repro_torch", None}


def test_config_token_ignores_the_backend_field():
    a = EncoderConfig(K=5, backend="auto")
    b = EncoderConfig(K=5, backend="cuda")
    assert config_token(a) == config_token(b)
    assert config_token(a) != config_token(EncoderConfig(K=5,
                                                         row_partition=(0,
                                                                        3)))


def _fake_entry(cache: PlanDiskCache, i: int, mtime: float,
                nbytes: int = 64) -> Path:
    cache.root.mkdir(parents=True, exist_ok=True)
    path = cache.root / f"{i:032x}.npz"
    np.savez(path, blob=np.zeros(max(1, nbytes // 8), np.int64))
    os.utime(path, (mtime, mtime))
    return path


class TestLruEviction:
    def test_max_entries_evicts_least_recently_used(self, tmp_path):
        cache = PlanDiskCache(tmp_path, max_entries=2)
        paths = [_fake_entry(cache, i, mtime=1000.0 + i) for i in range(4)]
        assert cache.evict() == 2
        assert not paths[0].exists() and not paths[1].exists()
        assert paths[2].exists() and paths[3].exists()

    def test_max_bytes_evicts_until_under_budget(self, tmp_path):
        cache = PlanDiskCache(tmp_path, max_bytes=1)
        a = _fake_entry(cache, 0, mtime=1000.0)
        b = _fake_entry(cache, 1, mtime=2000.0)
        assert cache.evict() >= 1
        assert not a.exists()
        assert cache.evict() == (1 if b.exists() else 0)

    def test_store_triggers_eviction_and_hits_touch(self, tmp_path):
        g, Y = _data(60, 300, 3, 0)
        cache = PlanDiskCache(tmp_path, max_entries=2)
        for K in (3, 4, 5):
            _fit(cache, g, np.minimum(Y, K - 1).astype(np.int32), K=K)
            assert len(cache.entries()) <= 2
        for p in cache.entries():
            os.utime(p, (1000.0, 1000.0))
        emb = _fit(cache, g, np.minimum(Y, 4).astype(np.int32), K=5)
        assert emb.plan_stats["disk_hits"] == 1
        hit = [p for p in cache.entries() if p.stat().st_mtime > 1500.0]
        assert len(hit) == 1
        _fake_entry(cache, 99, mtime=3000.0)
        cache.evict()
        assert hit[0].exists()

    def test_unbounded_cache_never_evicts(self, tmp_path):
        cache = PlanDiskCache(tmp_path)
        for i in range(5):
            _fake_entry(cache, i, mtime=1000.0 + i)
        assert cache.evict() == 0 and len(cache.entries()) == 5

    def test_default_cache_reads_limit_env(self, monkeypatch, tmp_path):
        monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
        monkeypatch.setenv("REPRO_PLAN_CACHE_MAX_ENTRIES", "7")
        monkeypatch.setenv("REPRO_PLAN_CACHE_MAX_BYTES", "1048576")
        cache = default_cache()
        assert (cache.max_entries, cache.max_bytes) == (7, 1048576)
        monkeypatch.setenv("REPRO_PLAN_CACHE_MAX_ENTRIES", "junk")
        monkeypatch.setenv("REPRO_PLAN_CACHE_MAX_BYTES", "0")
        cache = default_cache()
        assert (cache.max_entries, cache.max_bytes) == (None, None)


class TestCli:
    def test_stats_and_clear(self, tmp_path, capsys):
        cache = PlanDiskCache(tmp_path)
        for i in range(3):
            _fake_entry(cache, i, mtime=1000.0 + i)
        assert main(["--dir", str(tmp_path), "--stats"]) == 0
        assert "entries:     3" in capsys.readouterr().out
        assert main(["--dir", str(tmp_path), "--clear"]) == 0
        assert "cleared 3" in capsys.readouterr().out
        assert cache.entries() == []

    def test_disabled_cache_reports_and_fails(self, monkeypatch, capsys):
        monkeypatch.setenv("REPRO_PLAN_CACHE", "off")
        assert main(["--stats"]) == 1
        assert "disabled" in capsys.readouterr().out

    def test_module_entrypoint_runs(self, tmp_path):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.encoder.plan_cache",
             "--dir", str(tmp_path), "--stats"],
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "entries:     0" in out.stdout
