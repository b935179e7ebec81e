"""repro_torch.launch.{roofline, autotune, hillclimb} on the CPU.

`_coordinate_descent` gives the reference's trace on a synthetic
measure; `shape_bytes` and `model_flops` equal the reference's (every
arch, every shape); `Roofline`'s terms divide by the H100 figures; the
scatter's byte model is the kernel table's at LiveJournal scale and at a
real plan's arrays; both tuners and the hillclimb command run on the CPU,
timing the plain versions."""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.launch import autotune as JA
from repro.launch import roofline as JR
from repro_torch.configs import SHAPES, get_config
from repro_torch.encoder import Embedder, EncoderConfig
from repro_torch.graph import erdos_renyi, make_labels
from repro_torch.kernels import query_fused as QF
from repro_torch.launch import autotune as A
from repro_torch.launch import roofline as R

ROOT = Path(__file__).resolve().parents[1]


def _synthetic(cfg):
    """A bowl with its floor at (tile_n 256, edge_block 512), ties
    broken by a small tilt: both descents must walk the same points."""
    return (abs(math.log2(cfg["tile_n"] / 256))
            + 0.5 * abs(math.log2(cfg["edge_block"] / 512))
            + 1e-3 * cfg["tile_n"] / 64)


@pytest.mark.parametrize("start", [{"tile_n": 64, "edge_block": 128},
                                   {"tile_n": 512, "edge_block": 1024},
                                   {"tile_n": 256, "edge_block": 512}])
def test_coordinate_descent_trace_matches_reference(start):
    space = dict(JA.SCATTER_SPACE)
    logs, jlogs = [], []
    out = A._coordinate_descent(space, _synthetic, start, log=logs.append)
    ref = JA._coordinate_descent(space, _synthetic, start, log=jlogs.append)
    assert out == ref
    assert logs == jlogs
    assert out["best"] == {"tile_n": 256, "edge_block": 512}


@pytest.mark.parametrize("s", ["f32[16,128]{1,0}", "(f32[2], bf16[4,4])",
                               "s32[]", "pred[7,3]", "f8e4m3fn[10]",
                               "token[] f32[3]", "(u8[5], c128[2,2])"])
def test_shape_bytes_matches_reference(s):
    assert R.shape_bytes(s) == JR.shape_bytes(s)


@pytest.mark.parametrize("arch", j_list_archs())
def test_model_flops_matches_reference(arch):
    for name, shape in J_SHAPES.items():
        assert R.model_flops(get_config(arch), SHAPES[name]) == \
            JR.model_flops(j_get_config(arch), shape), name


def test_roofline_terms_use_h100_figures():
    assert (R.PEAK_FLOPS, R.FP32_FLOPS, R.HBM_BW, R.ICI_BW, R.HBM_BYTES) \
        == (989e12, 67e12, 3.35e12, 900e9, 80e9)
    kw = dict(arch="yi-6b", shape="train_4k", mesh="1", chips=2,
              flops_per_device=4e14, bytes_per_device=2e12,
              collective_bytes=5e11, collectives={},
              model_flops_global=6e14, arg_bytes=60e9, temp_bytes=15e9)
    r, j = R.Roofline(**kw), JR.Roofline(**kw)
    assert r.compute_s == 4e14 / 989e12
    assert r.memory_s == 2e12 / 3.35e12
    assert r.collective_s == 5e11 / 900e9
    assert r.dominant == "memory" and j.dominant == "collective"
    assert r.step_s == r.memory_s
    assert r.useful_flops_ratio == j.useful_flops_ratio == 0.75
    assert r.mfu == 6e14 / (r.step_s * 2 * 989e12)
    assert r.hbm_fit and not j.hbm_fit          # 75 GB: 80 GB, not 16
    assert not R.Roofline(**{**kw, "temp_bytes": 21e9}).hbm_fit
    assert set(r.to_dict()) == set(j.to_dict())


def test_bound_s():
    assert R.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert R.bound_s(1.0, 67e12) == (1.0, "operations")
    assert R.bound_s(1.0, 989e12, R.PEAK_FLOPS) == (1.0, "operations")


def test_scatter_byte_model_is_the_kernel_tables():
    # LiveJournal scale, K = 16, tile_n = 256: the kernel table's 1.453 GB
    n, s = 4_847_571, 68_993_773
    T = -(-n // 256)
    assert A.scatter_traffic_bytes(2 * s, T, 256, 16) == 1_452_928_728
    # a real plan: 8 bytes of class + value per slot, the row offsets,
    # and Z once
    g = erdos_renyi(700, 5000, seed=4)
    Y = make_labels(g.n, 5, 0.3, np.random.default_rng(4))
    e = Embedder(EncoderConfig(K=5, tile_n=64), backend="cuda",
                 device="cpu", plan_cache=None).fit(g, Y)
    d = e._plan.data
    cls, val = e.backend.resolve(e._plan, e._Yj, e.Wv_)
    want = (cls.numel() * cls.element_size()
            + val.numel() * val.element_size()
            + d["row_ptr"].numel() * d["row_ptr"].element_size()
            + 4 * 5 * d["T"] * 64)
    assert A.scatter_traffic_bytes(cls.numel(), d["T"], 64, 5) == want
    assert A.topk_traffic_bytes(100, 16, 8, 10) == (
        100 * 16 * 4 + 8 * 16 * 4 + 8 * 4 + 8 * 10 * 8)
    assert A.topk_ops(100, 16, 8) == 2 * 8 * 100 * 16


def test_median_time_is_the_median():
    calls = iter([0.0, 0.03, 0.01, 0.02])
    import time as _time

    def slow():
        _time.sleep(next(calls))
    t = A.median_time(slow, warmup=1, iters=3)
    assert 0.015 < t < 0.03


def test_tuners_run_on_the_cpu():
    logs = []
    sc = A.tune_scatter(n=600, s=4000, K=6, space={"tile_n": (64, 128)},
                        iters=1, log=logs.append, device="cpu")
    assert sc["mode"] == "plain (cpu)"
    assert sc["best"]["tile_n"] in (64, 128)
    assert [c["tile_n"] for c, _ in sc["trace"]][:2] == [64, 128]
    assert sc["default_point"]["cfg"] == {"tile_n": 256}
    for pt in (sc["best_point"], sc["default_point"]):
        T = -(-600 // pt["cfg"]["tile_n"])
        assert pt["moved_bytes"] == A.scatter_traffic_bytes(
            8000, T, pt["cfg"]["tile_n"], 6)
        assert pt["bound_by"] == "bytes" and pt["seconds"] > 0
    tk = A.tune_topk(m=900, K=8, nq=4, k=3, space={"max_grid": (2, 8)},
                     iters=1, log=logs.append, device="cpu")
    assert tk["mode"] == "plain (cpu)"
    assert tk["default_point"]["cfg"] == {"max_grid": None}
    assert tk["moved_bytes"] == A.topk_traffic_bytes(900, 8, 4, 3)
    assert any("plain (cpu)" in line for line in logs)


def test_topk_max_grid_checked_and_ignored_by_the_plain_version():
    rng = np.random.default_rng(0)
    Zn = QF.normalize_rows(torch.as_tensor(
        rng.normal(size=(300, 8)).astype(np.float32)))
    qn = torch.as_tensor([3, 50, 299], dtype=torch.int32)
    q = Zn[qn.long()].contiguous()
    a = QF.topk_fused(Zn, q, qn, k=5)
    b = QF.topk_fused(Zn, q, qn, k=5, max_grid=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="max_grid"):
        QF.topk_fused(Zn, q, qn, k=5, max_grid=0)


def test_hillclimb_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb",
         "gee-scatter-tune", "gee-topk-tune", "--quick", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "best[scatter]" in r.stdout and "best[topk]" in r.stdout
    assert r.stdout.count("[plain (cpu)]") >= 2
    assert "XLA_FLAGS" not in Path(
        ROOT / "src/repro_torch/launch/hillclimb.py").read_text()
    lst = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", "--list"],
        env=env, capture_output=True, text=True, timeout=120)
    # the reference's variant names, read without importing its module
    # (importing it sets XLA_FLAGS for this process)
    import ast
    tree = ast.parse((ROOT / "src/repro/launch/hillclimb.py").read_text())
    table = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                 and n.targets[0].id == "VARIANTS")
    assert lst.stdout.split() == [k.value for k in table.keys]
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", "gee-nope"],
        env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "unknown variant" in bad.stderr
