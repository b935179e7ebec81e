"""repro_torch.obs against repro.obs: the same operations give the same
snapshot, histogram summaries and Prometheus text; span trees, health
transitions and name validation agree; the port's fence synchronizes
CUDA tensors only; REPRO_OBS=off makes the layer a no-op."""
import importlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.obs.health import HealthTracker as JHealth
from repro_torch import obs
from repro_torch.obs.health import DEGRADED, SERVING, HealthTracker

# the facades' `registry()` and `tracer()` shadow the module names
R = importlib.import_module("repro_torch.obs.registry")
T = importlib.import_module("repro_torch.obs.trace")
JR = importlib.import_module("repro.obs.registry")
JT = importlib.import_module("repro.obs.trace")

ROOT = Path(__file__).resolve().parents[1]


def _drive(reg, rng_seed=0):
    """The same mixed operations on a registry of either package."""
    rng = np.random.default_rng(rng_seed)
    for i in range(200):
        reg.counter("repro_serving_wal_records_total", kind="edges")
        reg.counter("repro_serving_delta_edges_total", float(i % 7))
        reg.gauge("repro_serving_shard_accumulator_bytes", 100 * i,
                  shard=str(i % 3))
        reg.observe("repro_serving_query_seconds",
                    float(rng.lognormal(-7, 2)), kind="topk")
        reg.observe("repro_serving_batcher_batch_items",
                    float(rng.integers(1, 500)), kind="embed")
    reg.observe("repro_serving_recovery_seconds", 0.0)


class TestRegistry:
    def test_same_snapshot_and_prometheus(self):
        a, b = R.MetricsRegistry(), JR.MetricsRegistry()
        _drive(a)
        _drive(b)
        assert a.snapshot() == b.snapshot()
        assert a.snapshot("repro_serving_q") == b.snapshot("repro_serving_q")
        assert a.render_prometheus() == b.render_prometheus()
        assert R.summarize(a.snapshot()) == JR.summarize(b.snapshot())
        assert a.series_names() == b.series_names()
        for name, labels in (("repro_serving_query_seconds",
                              {"kind": "topk"}),
                             ("repro_serving_recovery_seconds", {})):
            assert a.hist_summary(name, **labels) == \
                b.hist_summary(name, **labels)
        assert a.counter_value("repro_serving_wal_records_total",
                               kind="edges") == 200.0
        assert a.gauge_value("repro_serving_shard_accumulator_bytes",
                             shard="1") == \
            b.gauge_value("repro_serving_shard_accumulator_bytes",
                          shard="1")
        a.reset()
        assert a.render_prometheus() == ""

    @pytest.mark.parametrize("value", [0.0, 1e-7, 1e-6, 3e-6, 0.5, 1e9,
                                       1e300])
    def test_buckets_equal_reference(self, value):
        assert R.bucket_index(value) == JR.bucket_index(value)
        assert R.bucket_upper(R.bucket_index(value)) == \
            JR.bucket_upper(JR.bucket_index(value))

    @pytest.mark.parametrize("name", [
        "repro_serving_x", "repro_a_b_c", "serving_x", "repro_x",
        "repro_Serving_x", "repro__x", "repro_x-y"])
    def test_name_validation_equals_reference(self, name):
        assert R.valid_metric_name(name) == JR.valid_metric_name(name)
        reg = R.MetricsRegistry()
        if not R.valid_metric_name(name):
            with pytest.raises(ValueError, match="naming scheme"):
                reg.counter(name)

    def test_concurrent_counts_are_not_lost(self):
        reg = R.MetricsRegistry()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [
                reg.counter("repro_test_hits_total") for _ in range(500)])
                for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
        assert reg.counter_value("repro_test_hits_total") == 4000.0


class TestFacade:
    def test_module_helpers_equal_reference(self):
        for mod in (obs, jobs):
            mod.configure(enabled=True)
            mod.reset()
        try:
            for mod in (obs, jobs):
                _drive(mod)          # the facade takes the same calls
            assert obs.snapshot() == jobs.snapshot()
            assert obs.render_prometheus() == jobs.render_prometheus()
            assert obs.snapshot()["enabled"] is True
            obs.configure(enabled=False)
            obs.counter("repro_serving_wal_records_total", kind="edges")
            assert obs.span("serving.rebuild") is T.NOOP_SPAN
            assert obs.tick() == 0.0 and obs.tock(5.0) == 0.0
            assert obs.snapshot() == {**jobs.snapshot(), "enabled": False}
        finally:
            for mod in (obs, jobs):
                mod.configure(enabled=True)
                mod.reset()


class TestTrace:
    def _spans(self, tracer_mod, registry):
        tr = tracer_mod.Tracer(ring=16)
        with tr.begin("serving.checkpoint", {"gen": 1}) as outer:
            outer.metric = "repro_serving_checkpoint_seconds"
            outer._registry = registry
            with tr.begin("serving.rebuild", {"epoch": 2}) as inner:
                inner.set(shards=2)
        with pytest.raises(RuntimeError):
            with tr.begin("serving.recovery", {}):
                raise RuntimeError("boom")
        return tr.events()

    def test_span_tree_equals_reference(self):
        reg, jreg = R.MetricsRegistry(), JR.MetricsRegistry()
        ev = self._spans(T, reg)
        jev = self._spans(JT, jreg)
        strip = [{k: e[k] for k in ("name", "id", "parent", "attrs")}
                 for e in ev]
        assert strip == [{k: e[k] for k in ("name", "id", "parent",
                                            "attrs")} for e in jev]
        assert ev[-1]["error"] == jev[-1]["error"] == "RuntimeError('boom')"
        for e in ev + jev:
            e["dur_s"], e["t0"] = 0.0, 0.0
        assert T.render_tree(ev) == JT.render_tree(jev)
        assert reg.hist_summary("repro_serving_checkpoint_seconds")[
            "count"] == 1

    def test_jsonl_sink_round_trips(self, tmp_path):
        path = str(tmp_path / "spans.jsonl")
        tr = T.Tracer(ring=4, trace_path=path)
        for i in range(6):
            with tr.begin("serving.rebuild", {"i": i}):
                pass
        tr.set_sink(None)
        with open(path, "a") as f:
            f.write("not json\n")
        events = T.load_jsonl(path)
        assert [e["attrs"]["i"] for e in events] == list(range(6))
        assert JT.load_jsonl(path) == events
        assert len(tr.events()) == 4         # the ring keeps the newest

    def test_fence_passes_cpu_values_through(self):
        sp = T.Span(T.Tracer(), "serving.rebuild", {})
        x = torch.ones(3)
        nested = {"a": [x, np.zeros(2)], "b": 3}
        assert sp.fence(x) is x
        assert sp.fence(nested) is nested
        assert sp.fence(None) is None
        assert T.NOOP_SPAN.fence(x) is x
        assert T._cuda_devices(nested) == set()


class TestHealth:
    def test_transitions_equal_reference(self):
        for mod in (obs, jobs):
            mod.configure(enabled=True)
            mod.reset()
        try:
            h, jh = HealthTracker("serving"), JHealth("serving")
            for state, reason in ((SERVING, None), (DEGRADED, "slow disk"),
                                  (DEGRADED, "slower"), (SERVING, None)):
                assert h.to(state, reason) == jh.to(state, reason)
                assert {k: v for k, v in h.as_dict().items()
                        if k != "since"} == \
                    {k: v for k, v in jh.as_dict().items() if k != "since"}
            assert obs.snapshot() == jobs.snapshot()
            with pytest.raises(ValueError, match="unknown health state"):
                h.to("on fire")
        finally:
            for mod in (obs, jobs):
                mod.reset()


def test_repro_obs_off_is_a_no_op(tmp_path):
    """REPRO_OBS=off (read at import): every helper returns before the
    registry, spans are the shared no-op, and a whole engine run records
    nothing."""
    code = """
import json, numpy as np
from repro_torch import obs
from repro_torch.graph import erdos_renyi, make_labels
from repro_torch.serving import GraphStore, ServingEngine
assert not obs.enabled()
assert obs.span("serving.rebuild", metric="repro_serving_x_seconds") \\
    is obs.trace.NOOP_SPAN
g = erdos_renyi(300, 3000, seed=0)
Y = make_labels(300, 4, 0.3, np.random.default_rng(0))
eng = ServingEngine(GraphStore(g, Y, 4), num_shards=2, device="cpu",
                    data_dir=%r)
eng.apply_edge_delta([1, 2], [3, 4], [1.0, 1.0])
eng.query_topk(np.arange(8), k=3)
eng.checkpoint()
eng.close()
print(json.dumps({"snap": obs.snapshot(),
                  "prom": obs.render_prometheus(),
                  "events": len(obs.trace_events()),
                  "stats_has_metrics": "metrics" in eng.stats()}))
""" % str(tmp_path / "dep")
    env = dict(os.environ, REPRO_OBS="off", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["snap"] == {"counters": {}, "gauges": {}, "histograms": {},
                           "enabled": False}
    assert res["prom"] == "" and res["events"] == 0
    assert not res["stats_has_metrics"]
