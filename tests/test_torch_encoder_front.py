"""The rest of the encoder front door against the JAX package, on the
CPU: the Embedder's telemetry (span and series names), `to_features`,
the LM bridge (`encoder.bridge`), `core.gee.gee_dense_oracle` and
`gee_refine`.

Random draws differ between the packages (`torch.Generator` is not
`jax.random`), so `to_features`, the bridge and refinement are compared
by shape, scale, structure, pinned labels and quality, never by bits;
the dense oracle is deterministic and held to atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.gee import gee_dense_oracle as j_dense
from repro.core.gee import gee_refine as j_refine
from repro.encoder import Embedder as JEmbedder
from repro.encoder import EncoderConfig as JConfig
from repro.encoder.bridge import gee_embedding_init as j_init
from repro.encoder.bridge import token_cooccurrence as j_cooc
from repro.graph.edges import Graph as JGraph
from repro_torch import obs
from repro_torch.core.gee import gee_dense_oracle, gee_refine
from repro_torch.encoder import Embedder, EncoderConfig
from repro_torch.encoder.bridge import gee_embedding_init, token_cooccurrence
from repro_torch.graph import erdos_renyi, make_labels, sbm


def _jg(g):
    return JGraph(g.u, g.v, g.w, g.n)


def _names(events, snapshot, prefix):
    spans = {e["name"] for e in events if e["name"].startswith("encoder.")}
    series = set()
    for sec in ("counters", "gauges", "histograms"):
        series |= {k.split("{")[0] for k in snapshot.get(sec, {})
                   if k.startswith(prefix)}
    return spans, series


def _drive(E, C, g, Y, d, backend, **kw):
    e = E(C(K=4, refine_iters=2, kmeans_iters=1, tile_n=64),
          backend=backend, plan_cache=None, **kw)
    e.fit(g, Y)
    e.refit(Y)
    e.transform(np.arange(5))
    e.refine()
    e.fit(g, Y)
    e.partial_fit(d)
    e.partial_fit_norm(d)
    return e


@pytest.mark.parametrize("port,ref", [("cuda", "pallas"),
                                      ("torch", "xla")])
def test_span_and_series_names_match_the_reference(port, ref):
    g = erdos_renyi(200, 1500, seed=1, weighted=True)
    Y = make_labels(200, 4, 0.3, np.random.default_rng(0))
    d = erdos_renyi(200, 40, seed=2, weighted=True)
    obs.configure(enabled=True)
    obs.reset()
    _drive(Embedder, EncoderConfig, g, Y, d, port, device="cpu")
    got = _names(obs.trace_events(), obs.snapshot(), "repro_encoder_")
    jobs.configure(enabled=True)
    jobs.reset()
    _drive(JEmbedder, JConfig, _jg(g), Y, _jg(d), ref)
    want = _names(jobs.trace_events(), jobs.snapshot(), "repro_encoder_")
    assert got == want
    assert got[0] == {"encoder.plan", "encoder.fit", "encoder.refine"}
    assert {"repro_encoder_plan_cache_total", "repro_encoder_plan_seconds",
            "repro_encoder_fit_seconds", "repro_encoder_fit_edges_per_s",
            "repro_encoder_refine_seconds",
            "repro_encoder_partial_fit_seconds",
            "repro_encoder_delta_edges_total",
            "repro_encoder_transform_seconds"} == got[1]
    tier1 = obs.registry().counter_value("repro_encoder_plan_cache_total",
                                         event="tier1_hit")
    assert tier1 == jobs.registry().counter_value(
        "repro_encoder_plan_cache_total", event="tier1_hit") > 0


def test_plan_cache_events_match_the_reference(tmp_path):
    g = erdos_renyi(150, 900, seed=3, weighted=True)
    Y = make_labels(150, 4, 0.3, np.random.default_rng(0))
    obs.configure(enabled=True)
    obs.reset()
    jobs.configure(enabled=True)
    jobs.reset()
    for _ in range(2):
        Embedder(EncoderConfig(K=4), backend="cuda", device="cpu",
                 plan_cache=tmp_path / "p").fit(g, Y)
        JEmbedder(JConfig(K=4), backend="pallas",
                  plan_cache=tmp_path / "j").fit(_jg(g), Y)
    for event in ("built", "disk_store", "disk_hit"):
        assert obs.registry().counter_value(
            "repro_encoder_plan_cache_total", event=event) == \
            jobs.registry().counter_value(
                "repro_encoder_plan_cache_total", event=event) == 1


def test_to_features_matches_the_reference_by_shape_and_structure():
    g, truth = sbm(300, 4, 6000, p_in=0.9, seed=5)
    Y = make_labels(300, 4, 0.3, np.random.default_rng(1),
                    true_labels=truth)
    t = Embedder(EncoderConfig(K=4), backend="cuda", device="cpu",
                 plan_cache=None).fit(g, Y)
    j = JEmbedder(JConfig(K=4), backend="xla", plan_cache=None).fit(
        _jg(g), Y)
    d = 2048
    for blend in (0.0, 0.5, 1.0):
        a = t.to_features(d, blend=blend)
        b = np.asarray(j.to_features(d, blend=blend))
        assert a.shape == b.shape == (300, d) and a.dtype == np.float32
        assert np.isfinite(a).all()
        # the scale of a 1/sqrt(d) init
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.05)
    # structure: at blend 1 the Gram matrix is (d / K) Zn Zn^T up to the
    # rotation's O(1 / sqrt(d)) spread, in both packages
    a = t.to_features(d, blend=1.0)
    b = np.asarray(j.to_features(d, blend=1.0))
    np.testing.assert_allclose(a @ a.T, b @ b.T, atol=0.15 * d / 4)
    same = truth[:, None] == truth[None, :]
    gram = a @ a.T
    assert gram[same].mean() > 2 * gram[~same].mean()
    # a generator fixes the draw
    g1 = t.to_features(64, generator=torch.Generator().manual_seed(3))
    g2 = t.to_features(64, generator=torch.Generator().manual_seed(3))
    assert np.array_equal(g1, g2)


def test_token_cooccurrence_equals_the_reference(rng):
    toks = rng.integers(0, 50, 3000)
    a, b = token_cooccurrence(toks, 50, 3), j_cooc(toks, 50, 3)
    for x, y in zip((a.u, a.v, a.w), (b.u, b.v, b.w)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    a = token_cooccurrence(toks, 50, 2, max_edges=100)
    b = j_cooc(toks, 50, 2, max_edges=100)
    assert a.s == b.s == 100


def test_gee_embedding_init_matches_the_reference_by_scale(rng):
    # a two-topic stream: tokens < 40 follow each other, as do >= 40
    topic = np.repeat(rng.integers(0, 2, 400), 10)
    toks = np.where(topic == 0, rng.integers(0, 40, 4000),
                    rng.integers(40, 80, 4000))
    a = gee_embedding_init(toks, 80, 128, K=8, device="cpu")
    b = np.asarray(j_init(toks, 80, 128, K=8))
    assert a.shape == b.shape == (80, 128) and np.isfinite(a).all()
    np.testing.assert_allclose(a.std(), b.std(), rtol=0.2)
    again = gee_embedding_init(toks, 80, 128, K=8, device="cpu")
    assert np.array_equal(a, again)


@pytest.mark.parametrize("n,s,K", [(30, 120, 3), (64, 500, 5)])
def test_dense_oracle_matches_the_reference(rng, n, s, K):
    g = erdos_renyi(n, s, seed=int(rng.integers(1 << 30)), weighted=True)
    Y = make_labels(n, K, 0.5, rng)
    got = gee_dense_oracle(*(torch.as_tensor(np.asarray(a)) for a in
                             (g.u, g.v, g.w, Y)), K, n)
    want = j_dense(jnp.asarray(g.u), jnp.asarray(g.v), jnp.asarray(g.w),
                   jnp.asarray(Y), K, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gee_refine_pins_labels_and_recovers_communities():
    """k-means from a random start can stop in a poor optimum in either
    package; over ten seeds the port recovers the communities about as
    often as the reference (8 of 10 seeds each at this size)."""
    n, K = 600, 4
    g, truth = sbm(n, K, 12_000, p_in=0.95, seed=7)
    Y0 = make_labels(n, K, 0.1, np.random.default_rng(2),
                     true_labels=truth)
    args = [torch.as_tensor(np.asarray(a)) for a in (g.u, g.v, g.w, Y0)]
    jargs = [jnp.asarray(np.asarray(a)) for a in (g.u, g.v, g.w, Y0)]
    good = jgood = 0
    for seed in range(10):
        Z, labels = gee_refine(*args, torch.Generator().manual_seed(seed),
                               K=K, n=n)
        labels = labels.numpy()
        assert Z.shape == (n, K) and torch.isfinite(Z).all()
        assert np.array_equal(labels[Y0 >= 0], Y0[Y0 >= 0])
        good += (labels == truth).mean() >= 0.9
        _, jl = j_refine(*jargs, jax.random.PRNGKey(seed), K=K, n=n)
        jgood += (np.asarray(jl) == truth).mean() >= 0.9
    assert good >= 6 and good >= jgood - 2
    a = gee_refine(*args, torch.Generator().manual_seed(1), K=K, n=n,
                   iters=3)
    b = gee_refine(*args, torch.Generator().manual_seed(1), K=K, n=n,
                   iters=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_embedder_refine_is_seeded():
    g, truth = sbm(400, 4, 8000, p_in=0.95, seed=8)
    Y = make_labels(400, 4, 0.1, np.random.default_rng(3),
                    true_labels=truth)
    e = Embedder(EncoderConfig(K=4, refine_iters=4), backend="cuda",
                 device="cpu", plan_cache=None).fit(g, Y)
    a = e.refine(seed=5).labels_
    b = e.refine(seed=5).labels_
    assert np.array_equal(a, b)
    assert np.array_equal(a[Y >= 0], Y[Y >= 0])
    assert (a == truth).mean() >= 0.9
