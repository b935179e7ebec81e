"""The port's serving CLI end to end on the CPU, in a subprocess:
`python -m repro_torch.serving.server --device cpu ...` must pass its
own self-checks (delta-maintained Z against a fresh fit, recovery of a
durable deployment) and print its per-kind statistics."""
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.server", *args],
        env=env, capture_output=True, text=True, timeout=300, check=True,
        cwd=ROOT).stdout


def test_durable_two_shard_run(tmp_path):
    out = _run("--device", "cpu", "--n", "1000", "--edges", "20000",
               "--steps", "6", "--shards", "2", "--compact-every", "3",
               "--data-dir", str(tmp_path / "dep"))
    assert "shards=2 durable=True" in out and "device=cpu" in out
    err = float(re.search(r"self-check max\|Z_delta - Z_rebuild\| = (\S+)",
                          out).group(1))
    assert err < 1e-3
    m = re.search(r"recovery: (\(.*\)) vs live (\(.*\)), max\|dZ\|=(\S+)",
                  out)
    assert m.group(1) == m.group(2) and float(m.group(3)) < 1e-3
    assert "reconnected top-k identical" in out
    for kind in ("embed", "predict", "topk", "insert"):
        assert re.search(rf"\[serve-gee\] {kind}\s+req=", out), kind
    assert out.count("compacted") == 2


def test_volatile_sync_flush_run_with_obs_dump():
    out = _run("--device", "cpu", "--n", "600", "--edges", "8000",
               "--steps", "4", "--shards", "4", "--sync-flush",
               "--obs-dump", "--compact-every", "0")
    assert "durable=False" in out
    assert "repro_serving_delta_apply_seconds_count" in out
    assert "[serve-gee] health: {'state': 'serving'" in out


def _serve_shard(i, n, shards):
    """`--serve-shard` worker i of (n, shards) on an ephemeral port;
    returns the process and the address from its handshake line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serving.server", "--device",
         "cpu", "--n", str(n), "--k", "4", "--shards", str(shards),
         "--serve-shard", "127.0.0.1:0", "--shard-id", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=ROOT)
    timer = threading.Timer(60, proc.kill)        # a bounded handshake
    timer.start()
    try:
        line = proc.stdout.readline().decode()
    finally:
        timer.cancel()
    m = re.match(r"LISTENING (\S+)", line)
    if m is None:
        proc.kill()
        raise AssertionError(f"--serve-shard {i} did not listen: {line!r}")
    return proc, m.group(1)


@pytest.mark.parametrize("mode", ["transport-socket", "serve-shard-connect"])
def test_transport_flags_work(tmp_path, monkeypatch, mode):
    """`--transport socket` (spawned shard workers plus a WAL-tail
    replica, group commit on) and `--serve-shard` workers that a router
    `--connect`s to both end with the socket deployment answering as
    its in-process twin; `--shutdown-workers` stops the workers."""
    common = ["--device", "cpu", "--n", "400", "--k", "4", "--edges",
              "3000", "--steps", "3", "--data-dir", str(tmp_path / "dep"),
              "--sync-flush", "--shutdown-workers"]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # spawned workers too
    workers = []
    try:
        if mode == "transport-socket":
            out = _run(*common, "--shards", "2", "--transport", "socket",
                       "--replicas", "1", "--fsync", "--group-commit-ms",
                       "20")
            assert "transport=socket" in out and "replicas=1" in out
        else:
            workers = [_serve_shard(i, 400, 2) for i in range(2)]
            out = _run(*common, "--connect",
                       ",".join(addr for _, addr in workers))
            assert "shards=2" in out
            for proc, _ in workers:       # --shutdown-workers stopped them
                assert proc.wait(timeout=30) == 0
        assert out.count("[serve-gee] shard worker @ ") == 2
        assert "recovery: reconnected top-k identical" in out
        assert "socket deployment == in-process ✓" in out
    finally:
        for proc, _ in workers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()


def test_default_device_needs_a_card():
    """Without --device the CLI runs on the card and refuses to start
    where there is none (skipped on a machine that has one)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.server", "--n", "300",
         "--edges", "3000"], env=env, capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert res.returncode != 0 and "is_available() is False" in res.stderr


def test_durable_ivf_run(tmp_path):
    """`--index ivf`: top-k through the IVF index, ivf at nprobe = K
    equal to the exact scan, and a recovery that restores the
    quantizer and the ivf answers."""
    out = _run("--device", "cpu", "--n", "800", "--edges", "12000",
               "--steps", "4", "--shards", "2", "--index", "ivf",
               "--nprobe", "3", "--compact-every", "2", "--obs-dump",
               "--data-dir", str(tmp_path / "dep"))
    assert "ivf@nprobe=K == exact ✓" in out
    assert "index quantizer restored ✓" in out
    assert "index occupancy shard 1:" in out
    assert "repro_index_queries_total" in out
