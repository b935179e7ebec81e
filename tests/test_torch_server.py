"""The port's serving CLI end to end on the CPU, in a subprocess:
`python -m repro_torch.serving.server --device cpu ...` must pass its
own self-checks (delta-maintained Z against a fresh fit, recovery of a
durable deployment) and print its per-kind statistics."""
import os
import re
import subprocess
import sys
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


@pytest.mark.parametrize("flag", [["--transport", "socket"],
                                  ["--serve-shard", "localhost:1"]])
def test_unported_flags_raise(flag):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.server", "--device",
         "cpu", "--n", "300", "--edges", "3000", *flag], env=env,
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert "NotImplementedError" in res.stderr


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
