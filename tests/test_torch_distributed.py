"""repro_torch.core.distributed against the JAX package on the CPU.

* Host helpers (`pad_rows`, `Graph.{pad_to, permuted, symmetrize}`,
  `shuffle_edges`, `owner_histogram`, `plan_capacity`,
  `exact_capacity_factor`, `prebucket_host`) bit-equal to the
  reference's on its distributed test's ER and skew graphs, p in
  {1, 2, 4, 8}; `_bucket_by_owner` bit-equal to the reference's jnp
  function, an overflowing cap included.
* One rank (a gloo group in this process): every mode within atol 1e-5
  of `gee_numpy` and of the reference's `gee_distributed` on its
  one-device mesh; the Laplacian through the ring; `gee_a2a_steady`.
* gloo worlds of 2 and 4 ranks (worker processes, a FileStore rendezvous
  in tmp_path): every mode, the row shards concatenating to the full Z,
  no drop at the exact capacity factor; under capacity_factor 0.3 on
  the skew graph the dropped count and Z equal the reference's on as
  many XLA host devices (a subprocess with
  --xla_force_host_platform_device_count); `backend="auto"` over the
  world resolves to distributed:reduce_scatter and fits.
* The Embedder on one rank: plan-cache hits with distributed:ring, the
  row-partition rejection naming the partition-aware backends.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import distributed as JD
from repro.core.gee import gee as j_gee
from repro.graph import partition as JP
from repro.graph.edges import Graph as JGraph
from repro_torch.core import distributed as D
from repro_torch.core.ref_python import gee_numpy
from repro_torch.encoder import Embedder, EncoderConfig
from repro_torch.encoder.backends import partition_backends
from repro_torch.graph import erdos_renyi, make_labels, partition
from repro_torch.graph.generators import powerlaw

ROOT = Path(__file__).resolve().parents[1]
MODES = ["replicated", "reduce_scatter", "a2a", "ring"]
GRAPHS = ["er", "skew"]
K = 7
ATOL = 1e-5


def _graph(name):
    """The reference distributed test's graphs, and labels from a seed."""
    if name == "er":
        g = erdos_renyi(1003, 20007, seed=1, weighted=True)
    else:
        g = powerlaw(512, 8192, seed=2)
    return g, make_labels(g.n, K, 0.2, np.random.default_rng(len(name)))


def _jg(g):
    return JGraph(g.u, g.v, g.w, g.n)


def _same_graph(a, b):
    assert a.n == b.n
    for x, y in ((a.u, b.u), (a.v, b.v), (a.w, b.w)):
        assert x.dtype == np.asarray(y).dtype
        assert np.array_equal(x, np.asarray(y))


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo mesh in this process, ended with the module."""
    yield D.edge_mesh("cpu")
    D.destroy_local_group()


# ---------------------------------------------------------------------------
# host helpers: bit-equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,p", [(0, 1), (1003, 1), (1003, 2), (1003, 8),
                                 (512, 4), (7, 8)])
def test_pad_rows(n, p):
    assert D.pad_rows(n, p) == JD.pad_rows(n, p)


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_helpers_match_reference(name):
    g, _ = _graph(name)
    jg = _jg(g)
    _same_graph(g.symmetrize(), jg.symmetrize())
    _same_graph(g.permuted(np.random.default_rng(5)),
                jg.permuted(np.random.default_rng(5)))
    for s_pad in (g.s, g.s + 1, g.s + 13):
        _same_graph(g.pad_to(s_pad), jg.pad_to(s_pad))
    padded = g.pad_to(g.s + 13)
    assert padded.n == g.n
    assert np.array_equal(padded.degrees(), g.degrees())
    Y = _graph(name)[1]
    np.testing.assert_array_equal(
        gee_numpy(padded.u, padded.v, padded.w, Y, K, g.n),
        gee_numpy(g.u, g.v, g.w, Y, K, g.n))
    with pytest.raises(ValueError):
        g.pad_to(g.s - 1)
    _same_graph(partition.shuffle_edges(g, seed=3),
                JP.shuffle_edges(jg, seed=3))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("name", GRAPHS)
def test_partition_helpers_match_reference(name, p):
    g, _ = _graph(name)
    jg = _jg(g)
    hist = partition.owner_histogram(g, p)
    ref = JP.owner_histogram(jg, p)
    assert hist.dtype == ref.dtype and np.array_equal(hist, ref)
    assert partition.plan_capacity(g.s, g.n, p) == JP.plan_capacity(
        g.s, g.n, p)
    assert D.exact_capacity_factor(g, p) == JD.exact_capacity_factor(jg, p)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("name", GRAPHS)
def test_prebucket_host_matches_reference(name, p):
    g, _ = _graph(name)
    out = D.prebucket_host(g, p)
    ref = JD.prebucket_host(_jg(g), p)
    assert out[3] == ref[3]
    for a, b in zip(out[:3], ref[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="overflow"):
        D.prebucket_host(g, max(p, 2), capacity_factor=0.1)


@pytest.mark.parametrize("p,cap", [(1, 4000), (3, 1500), (4, 900),
                                   (4, 200), (8, 30)])
def test_bucket_by_owner_matches_reference(p, cap, rng):
    """(4, 200) and (8, 30) overflow: the same contributions drop."""
    m, rows = 3000, 50
    dst = rng.integers(0, rows * p, m).astype(np.int32)
    cls = rng.integers(0, K, m).astype(np.int32)
    val = rng.random(m, dtype=np.float32)
    out = D._bucket_by_owner(torch.as_tensor(dst), torch.as_tensor(cls),
                             torch.as_tensor(val), rows, p, cap)
    ref = JD._bucket_by_owner(jnp.asarray(dst), jnp.asarray(cls),
                              jnp.asarray(val), rows, p, cap)
    for a, b in zip(out[:3], ref[:3]):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        assert np.array_equal(a.numpy(), b)
    assert int(out[3]) == int(ref[3])
    assert (int(out[3]) > 0) == (cap * p < m)


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", GRAPHS)
def test_one_rank_matches_reference(mesh1, name, mode):
    g, Y = _graph(name)
    Z, dropped = D.gee_distributed(g, Y, K=K, mode=mode, mesh=mesh1)
    Zj, dj = JD.gee_distributed(_jg(g), Y, K=K, mode=mode)
    assert Z.shape == (g.n, K) and dropped == 0 == dj
    np.testing.assert_allclose(Z, gee_numpy(g.u, g.v, g.w, Y, K, g.n),
                               atol=ATOL)
    np.testing.assert_allclose(Z, Zj, atol=ATOL)


def test_one_rank_laplacian_ring(mesh1):
    g = erdos_renyi(500, 6000, seed=3, weighted=True)
    Y = make_labels(g.n, 5, 0.3, np.random.default_rng(0))
    Z, dropped = D.gee_distributed(g, Y, K=5, mode="ring", mesh=mesh1,
                                   laplacian=True)
    ref = np.asarray(j_gee(jnp.asarray(g.u), jnp.asarray(g.v),
                           jnp.asarray(g.w), jnp.asarray(Y), K=5, n=g.n,
                           laplacian=True))
    assert dropped == 0
    np.testing.assert_allclose(Z, ref, atol=ATOL)


def test_one_rank_a2a_steady(mesh1):
    g, Y = _graph("skew")
    b_dst, b_src, b_w, n_pad = D.prebucket_host(g, 1)
    Y_pad = np.full(n_pad, -1, np.int32)
    Y_pad[:g.n] = Y
    Z, dropped = D.gee_a2a_steady(
        *(torch.as_tensor(a[0]) for a in (b_dst, b_src, b_w)),
        torch.as_tensor(Y_pad), K=K, n_pad=n_pad, mesh=mesh1)
    assert int(dropped) == 0
    np.testing.assert_allclose(Z.numpy()[:g.n],
                               gee_numpy(g.u, g.v, g.w, Y, K, g.n),
                               atol=ATOL)


def test_edge_mesh_group_gives_way(mesh1):
    """The one-rank group edge_mesh starts ends with
    destroy_local_group, after which init_process_group works; a later
    edge_mesh starts another."""
    assert mesh1.size() == 1 and dist.is_initialized()
    D.destroy_local_group()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = D.edge_mesh("cpu")      # the caller's group: used as is
        assert mesh.size() == 1
        D.destroy_local_group()        # not edge_mesh's: left alone
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert D.edge_mesh("cpu").size() == 1
    assert dist.is_initialized()


# ---------------------------------------------------------------------------
# the Embedder on one rank
# ---------------------------------------------------------------------------


def test_plan_cache_hits_distributed_ring(mesh1):
    g, Y = _graph("er")
    emb = Embedder(EncoderConfig(K=K), backend="distributed:ring",
                   device="cpu", mesh=mesh1)
    emb.fit(g, Y)
    emb.fit(g, Y)
    emb.refit(Y)
    assert emb.plan_stats == {"built": 1, "hits": 2,
                              "disk_hits": 0, "disk_stores": 0}
    np.testing.assert_allclose(emb.transform(),
                               gee_numpy(g.u, g.v, g.w, Y, K, g.n),
                               atol=ATOL)
    assert emb.last_info_ == {"dropped": 0}


def test_row_partition_rejected_with_alternatives(mesh1):
    g, _ = _graph("er")
    emb = Embedder(EncoderConfig(K=K, row_partition=(0, 10)),
                   backend="distributed:ring", device="cpu", mesh=mesh1)
    with pytest.raises(ValueError, match="owned-rows") as ei:
        emb.plan(g)
    msg = str(ei.value)
    assert "distributed:ring" in msg
    assert partition_backends() == ["cuda", "numpy", "streaming", "torch"]
    for name in partition_backends():
        assert name in msg
    with pytest.raises(ValueError, match="mesh"):
        Embedder(EncoderConfig(K=K), device="cpu",
                 mesh=type("M", (), {"device_type": "cuda"})())


# ---------------------------------------------------------------------------
# gloo worlds of 2 and 4 ranks
# ---------------------------------------------------------------------------

WORLDS = [2, 4]
OVERFLOW_CF = 0.3

RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.core import distributed as D
from repro_torch.encoder import Embedder, EncoderConfig
from repro_torch.encoder.backends import resolve_auto
from repro_torch.graph import Graph

mesh = D.edge_mesh("cpu")
d = np.load(data)
res = {}
for name in ("er", "skew", "lap"):
    g = Graph(d[name + "_u"], d[name + "_v"], d[name + "_w"],
              int(d[name + "_n"]))
    Y, K = d[name + "_Y"], int(d[name + "_K"])
    if name == "lap":
        res["lap"], res["lap_dropped"] = D.gee_distributed(
            g, Y, K=K, mode="ring", mesh=mesh, laplacian=True)
        continue
    cf = D.exact_capacity_factor(g, world)
    n_pad = D.pad_rows(g.n, world)
    Y_pad = np.full(n_pad, -1, np.int32)
    Y_pad[:g.n] = Y
    u, v, w = (torch.as_tensor(a) for a in D.edge_slice(g, world, rank))
    for mode in ("replicated", "reduce_scatter", "a2a", "ring"):
        key = f"{name}_{mode}"
        res[key], res[key + "_dropped"] = D.gee_distributed(
            g, Y, K=K, mode=mode, mesh=mesh)
        Zs, dropped = D.gee_sharded(u, v, w, torch.as_tensor(Y_pad), K=K,
                                    n=n_pad, mesh=mesh, mode=mode,
                                    capacity_factor=cf)
        res[key + "_shard"] = Zs.numpy()
        if mode in ("a2a", "ring"):
            res[key + "_over"], res[key + "_over_dropped"] = (
                D.gee_distributed(g, Y, K=K, mode=mode, mesh=mesh,
                                  capacity_factor=%(cf)r))
    if name == "skew":
        b = D.prebucket_host(g, world)
        Zs, _ = D.gee_a2a_steady(*(torch.as_tensor(a[rank]) for a in b[:3]),
                                 torch.as_tensor(Y_pad), K=K, n_pad=b[3],
                                 mesh=mesh)
        res["steady_shard"] = Zs.numpy()
        res["auto_name"] = np.asarray(resolve_auto(g.n, g.s, mesh=mesh))
        emb = Embedder(EncoderConfig(K=K), device="cpu", mesh=mesh,
                       plan_cache=None).fit(g, Y)
        res["auto_fit_name"] = np.asarray(emb.backend.name)
        res["auto_fit"] = emb.transform()
dist.barrier()
dist.destroy_process_group()
np.savez(out, **res)
""" % {"cf": OVERFLOW_CF}

REF_SCRIPT = r"""
import sys
import jax
import numpy as np
from repro.core.distributed import edge_mesh, gee_distributed
from repro.graph.edges import Graph

d = np.load(sys.argv[1])
g = Graph(d["skew_u"], d["skew_v"], d["skew_w"], int(d["skew_n"]))
res = {}
for p in %(worlds)r:
    mesh = edge_mesh(jax.devices()[:p])
    for mode in ("a2a", "ring"):
        Z, dropped = gee_distributed(g, d["skew_Y"], K=int(d["skew_K"]),
                                     mode=mode, mesh=mesh,
                                     capacity_factor=%(cf)r)
        res[f"{p}_{mode}"], res[f"{p}_{mode}_dropped"] = Z, dropped
np.savez(sys.argv[2], **res)
""" % {"worlds": WORLDS, "cf": OVERFLOW_CF}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both gloo worlds and the reference's XLA run, side by side:
    {world: [rank 0's results, ...], "ref": the reference's}."""
    tmp = tmp_path_factory.mktemp("worlds")
    data = tmp / "data.npz"
    arrays = {}
    lap = erdos_renyi(500, 6000, seed=3, weighted=True)
    cases = [(name, *_graph(name), K) for name in GRAPHS]
    cases.append(("lap", lap, make_labels(lap.n, 5, 0.3,
                                          np.random.default_rng(0)), 5))
    for name, g, Y, k in cases:
        arrays.update({f"{name}_u": g.u, f"{name}_v": g.v,
                       f"{name}_w": g.w, f"{name}_n": g.n,
                       f"{name}_Y": Y, f"{name}_K": k})
    np.savez(data, **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs = []
    for p in WORLDS:
        store = tmp / f"store{p}"
        for r in range(p):
            procs.append((p, r, subprocess.Popen(
                [sys.executable, "-c", RANK_SCRIPT, str(r), str(p),
                 str(store), str(data), str(tmp / f"w{p}_r{r}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count="
                          f"{max(WORLDS)}")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(data),
                            str(tmp / "ref.npz")], env=jenv,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    errors = []
    try:
        for p, r, proc in procs + [("ref", 0, ref)]:
            _, err = proc.communicate(timeout=300)
            if proc.returncode:
                errors.append(f"world {p} rank {r}: rc {proc.returncode}\n"
                              + textwrap.shorten(err[-3000:], 3000))
    finally:
        for _, _, proc in procs + [("ref", 0, ref)]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errors, "\n".join(errors)
    out = {p: [dict(np.load(tmp / f"w{p}_r{r}.npz")) for r in range(p)]
           for p in WORLDS}
    out["ref"] = dict(np.load(tmp / "ref.npz"))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("world", WORLDS)
def test_world_mode_matches_oracle(worlds, world, name, mode):
    g, Y = _graph(name)
    ref = gee_numpy(g.u, g.v, g.w, Y, K, g.n)
    key = f"{name}_{mode}"
    ranks = worlds[world]
    for res in ranks:
        assert int(res[key + "_dropped"]) == 0
        np.testing.assert_allclose(res[key], ref, atol=ATOL)
        np.testing.assert_array_equal(res[key], ranks[0][key])
    shards = [res[key + "_shard"] for res in ranks]
    full = shards[0] if mode == "replicated" else np.concatenate(shards)
    assert full.shape == (D.pad_rows(g.n, world), K)
    np.testing.assert_array_equal(full[:g.n], ranks[0][key])


@pytest.mark.parametrize("mode", ["a2a", "ring"])
@pytest.mark.parametrize("world", WORLDS)
def test_world_overflow_matches_reference(worlds, world, mode):
    """Buckets too small for the skew graph: the same contributions drop
    as on the reference's XLA devices, so Z agrees with it, not with the
    oracle."""
    ref = worlds["ref"]
    want = int(ref[f"{world}_{mode}_dropped"])
    assert want > 0
    g, Y = _graph("skew")
    oracle = gee_numpy(g.u, g.v, g.w, Y, K, g.n)
    for res in worlds[world]:
        assert int(res[f"skew_{mode}_over_dropped"]) == want
        Z = res[f"skew_{mode}_over"]
        np.testing.assert_allclose(Z, ref[f"{world}_{mode}"], atol=ATOL)
        assert np.abs(Z - oracle).max() > 10 * ATOL


@pytest.mark.parametrize("world", WORLDS)
def test_world_laplacian_ring(worlds, world):
    g = erdos_renyi(500, 6000, seed=3, weighted=True)
    Y = make_labels(g.n, 5, 0.3, np.random.default_rng(0))
    ref = np.asarray(j_gee(jnp.asarray(g.u), jnp.asarray(g.v),
                           jnp.asarray(g.w), jnp.asarray(Y), K=5, n=g.n,
                           laplacian=True))
    for res in worlds[world]:
        assert int(res["lap_dropped"]) == 0
        np.testing.assert_allclose(res["lap"], ref, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_world_a2a_steady(worlds, world):
    g, Y = _graph("skew")
    full = np.concatenate([res["steady_shard"] for res in worlds[world]])
    np.testing.assert_allclose(full[:g.n],
                               gee_numpy(g.u, g.v, g.w, Y, K, g.n),
                               atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_world_auto_backend_is_reduce_scatter(worlds, world):
    g, Y = _graph("skew")
    for res in worlds[world]:
        assert str(res["auto_name"]) == "distributed:reduce_scatter"
        assert str(res["auto_fit_name"]) == "distributed:reduce_scatter"
        np.testing.assert_allclose(res["auto_fit"],
                                   gee_numpy(g.u, g.v, g.w, Y, K, g.n),
                                   atol=ATOL)
