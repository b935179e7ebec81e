"""`python -m repro_torch.obs` on the CPU, in a subprocess: the snapshot
demo lists the series of every instrumented layer (engine, index, WAL,
batcher, plan cache, encoder), and ``--trace`` replays a span file."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, check=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.obs", *args],
                          env=env, capture_output=True, text=True,
                          timeout=300, check=check, cwd=ROOT)


def test_snapshot_json_lists_every_layer(tmp_path):
    spans = tmp_path / "spans.jsonl"
    out = _run("--snapshot", "--device", "cpu", "--json", "--trace-out",
               str(spans)).stdout
    snap = json.loads(out)
    names = set()
    for sec in ("counters", "gauges", "histograms"):
        names |= {k.split("{")[0] for k in snap[sec]}
    for series in (
            "repro_serving_rebuild_seconds", "repro_serving_query_seconds",
            "repro_serving_checkpoint_seconds",
            "repro_serving_recovery_seconds",
            "repro_serving_shard_accumulator_bytes",
            "repro_index_builds_total", "repro_index_queries_total",
            "repro_index_rows_scanned_total", "repro_index_topk_seconds",
            "repro_serving_wal_records_total",
            "repro_serving_wal_append_seconds",
            "repro_serving_batcher_batches_total",
            "repro_serving_batcher_ticket_seconds",
            "repro_encoder_plan_cache_total", "repro_encoder_fit_seconds"):
        assert series in names, series
    events = {k for k in snap["counters"]
              if k.startswith("repro_encoder_plan_cache_total")}
    assert any("disk_hit" in k for k in events)
    assert any("disk_store" in k for k in events)
    replay = _run("--trace", str(spans)).stdout
    assert replay.startswith("- obs.demo")
    for name in ("serving.rebuild", "index.build", "serving.checkpoint",
                 "serving.recovery", "encoder.plan", "encoder.fit"):
        assert name in replay, name


def test_prometheus_and_table_output():
    prom = _run("--snapshot", "--device", "cpu", "--n", "200", "--edges",
                "1500", "--steps", "1", "--prometheus").stdout
    assert "# TYPE repro_index_builds_total counter" in prom
    table = _run("--snapshot", "--device", "cpu", "--n", "200", "--edges",
                 "1500", "--steps", "1", "--shards", "1").stdout
    assert "repro_index_queries_total" in table


def test_unreadable_trace_fails(tmp_path):
    empty = tmp_path / "none.jsonl"
    empty.write_text("not json\n")
    res = _run("--trace", str(empty), check=False)
    assert res.returncode == 1 and "no parseable span" in res.stderr


def test_default_device_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    res = _run("--snapshot", check=False)
    assert res.returncode != 0 and "cuda" in res.stderr
