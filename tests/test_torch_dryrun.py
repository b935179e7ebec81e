"""The port's dry run against the JAX package's, on the CPU.

Pure functions (`all_cells`, `probe_unit`, `extrapolate`,
`slstm_correction_flops`, `model_flops`) and the abstract shapes
(`input_specs`, `abstract_params`, `abstract_cache`, `logical_axes`)
equal the reference's for every arch and shape, exactly.
`parse_collectives` turns the reference's HLO fixture
(tests/test_dryrun.py:53-67), given as a recorded trace, into the same
dict.  A subprocess traces a reduced arch on a fake 4x4 mesh and on one
rank (this process rank 0 of a `fake` process group, every tensor a
FakeTensor) and GEE's modes on a fake 256-rank mesh; the record has the
reference's keys, its argument bytes equal the reference's arithmetic
exactly, its full-depth flops equal the depth-probe extrapolation
exactly (a uniform stack: every layer costs the same), and 16 ranks'
flops equal one rank's within 1 % (every product of that config is
sharded, none replicated).  The reference's own
`test_one_cell_lowers_and_compiles_256_chips` fails on this tree, so
nothing here uses it as an oracle."""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_cells as j_all_cells
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.launch import analytic as JA
from repro.launch import report as JREP
from repro.launch.roofline import model_flops as j_model_flops
from repro.launch.roofline import parse_collectives as j_parse
from repro.models import model as JM
from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.launch import analytic as TA
from repro_torch.launch import report as TREP
from repro_torch.launch.roofline import model_flops, parse_collectives
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
ARCHS = j_list_archs()
CELLS = [(a, s) for a in ARCHS for s in sorted(J_SHAPES)]


def _j_leaves(tree):
    """{key path: leaf} of a reference pytree (None holds no leaf)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(getattr(k, "key", getattr(k, "name", k))
                  for k in path)] = leaf
    return out


def _t_leaves(tree, prefix=()):
    """{key path: leaf} of a nest of dicts / ParamTrees / NamedTuples."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor) or not hasattr(tree, "keys"):
        if hasattr(tree, "_fields"):
            out = {}
            for f in tree._fields:
                out.update(_t_leaves(getattr(tree, f), prefix + (f,)))
            return out
        return {prefix: tree}
    out = {}
    for k in tree.keys():
        out.update(_t_leaves(tree[k], prefix + (k,)))
    return out


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def test_all_cells_equal_reference():
    assert all_cells() == j_all_cells()


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_unit_equals_reference(arch):
    ju, j2u, jn, jt = JA.probe_unit(j_get_config(arch))
    tu, t2u, tn, tt = TA.probe_unit(get_config(arch))
    assert (tn, tt) == (jn, jt)
    for a, b in ((ju, tu), (j2u, t2u)):
        assert (a.n_layers, a.enc_layers, a.dec_layers) == \
            (b.n_layers, b.enc_layers, b.dec_layers)


@pytest.mark.parametrize("case", range(4))
def test_extrapolate_equals_reference(case):
    rng = np.random.default_rng(case)
    u = {k: float(rng.uniform(1, 1e6)) for k in ("flops", "bytes", "x")}
    u2 = {k: v + float(rng.uniform(-1e5, 1e6)) for k, v in u.items()}
    n, tail = float(rng.integers(1, 80)), float(rng.uniform(0, 1))
    assert TA.extrapolate(u, u2, n, tail) == JA.extrapolate(u, u2, n, tail)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_arithmetic_equals_reference(arch, shape):
    jc, tc = j_get_config(arch), get_config(arch)
    assert TA.slstm_correction_flops(tc, SHAPES[shape]) == \
        JA.slstm_correction_flops(jc, J_SHAPES[shape])
    assert model_flops(tc, SHAPES[shape]) == \
        j_model_flops(jc, J_SHAPES[shape])


@pytest.mark.parametrize("arch,shape", [c for c in CELLS
                                        if c in set(j_all_cells())])
def test_input_specs_equal_reference(arch, shape):
    ref = _j_leaves(JM.input_specs(j_get_config(arch), J_SHAPES[shape]))
    port = _t_leaves(TM.input_specs(get_config(arch), SHAPES[shape]))
    assert set(port) == set(ref)
    for k, r in ref.items():
        assert tuple(port[k].shape) == tuple(r.shape), k
        assert _dt(port[k]) == str(r.dtype), k
        assert port[k].device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_cache_equal_reference(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    for ref, port in ((JM.abstract_params(jc), TM.abstract_params(tc)),
                      (JM.abstract_cache(jc, 2, 64),
                       TM.abstract_cache(tc, 2, 64))):
        ref, port = _j_leaves(ref), _t_leaves(port)
        assert set(port) == set(ref)
        for k, r in ref.items():
            assert tuple(port[k].shape) == tuple(r.shape), k
            assert _dt(port[k]) == str(r.dtype), k
    # logical axis names, param by param
    assert _axes(TM.logical_axes(tc)) == _axes(JM.logical_axes(jc))


def _axes(tree, prefix=()):
    """{key path: logical names} of a nested dict of tuples."""
    if isinstance(tree, tuple):
        return {prefix: tree}
    out = {}
    for k in tree:
        out.update(_axes(tree[k], prefix + (k,)))
    return out


HLO = """
  %all-reduce.5 = f32[16,128]{1,0} all-reduce(%x), replica_groups=[2,4]<=[8]
  %ag = bf16[32,64]{1,0} all-gather(%y), dimensions={0}
  %cp.2 = f32[8]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %rs = f32[4,128]{1,0} reduce-scatter(%w), replica_groups=[2,4]<=[8]
  %a2a = s32[64]{0} all-to-all(%v), replica_groups={{0,1,2,3}}
  %other = f32[4]{0} add(%a, %b)
"""
#: the same collectives as the dry run's recorder writes them
TRACE = [
    {"kind": "all-reduce", "op": "c10d.allreduce_.default",
     "bytes": 16 * 128 * 4, "group": 4},
    {"kind": "all-gather",
     "op": "_c10d_functional.all_gather_into_tensor.default",
     "bytes": 32 * 64 * 2, "group": 2},
    {"kind": "collective-permute", "op": "c10d.recv_.default",
     "bytes": 8 * 4, "group": 8},
    {"kind": "reduce-scatter",
     "op": "_c10d_functional.reduce_scatter_tensor.default",
     "bytes": 4 * 128 * 4, "group": 4},
    {"kind": "all-to-all", "op": "_dtensor.shard_dim_alltoall.default",
     "bytes": 64 * 4, "group": 4},
]


def test_parse_collectives_equals_reference():
    assert parse_collectives(TRACE) == j_parse(HLO)


def test_report_rows_equal_reference(tmp_path, monkeypatch):
    rec = {"arch": "yi-6b", "shape": "train_4k", "mesh": "pod16x16",
           "chips": 256, "compile_s": 12.5, "tag": "",
           "memory_analysis": {"argument_size_in_bytes": 3e9,
                               "temp_size_in_bytes": 14e9},
           "collectives": {k: {"count": i + 1, "bytes": 10, "wire_bytes": 1}
                           for i, k in enumerate(
                               ("all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"))},
           "compute_s": 0.25, "memory_s": 1.5, "collective_s": 0.125,
           "dominant": "memory", "model_flops_global": 3.7e16,
           "useful_flops_ratio": 0.5, "mfu": 0.0625}
    tagged = dict(rec, tag="tri")
    for mod, sub in ((JREP, "j"), (TREP, "t")):
        d = tmp_path / sub / "pod16x16"
        d.mkdir(parents=True)
        (d / "yi-6b__train_4k.json").write_text(json.dumps(rec))
        (d / "yi-6b__train_4k__tri.json").write_text(json.dumps(tagged))
        monkeypatch.setattr(mod, "ART", str(tmp_path / sub))
    for fn in ("dryrun_table", "roofline_table"):
        j = getattr(JREP, fn)("pod16x16").splitlines()
        t = getattr(TREP, fn)("pod16x16").splitlines()
        # one row: the tagged variant is left out of both tables
        assert len(j) == len(t) == (5 if fn == "dryrun_table" else 3)
        if fn == "dryrun_table":
            # the budget column: 16 GB on the reference's TPU, 80 GB here
            assert "fits 16GB" in j[2] and "fits 80GB" in t[2]
            j = [line.rsplit("|", 2)[0] for line in j]
            t = [line.rsplit("|", 2)[0] for line in t]
        assert t == j


DRY_SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as DR
from repro_torch.launch.costs import Recorder
from repro_torch.launch.mesh import make_production_mesh

out = {}
# the recorder counts local ops only: one matmul on a fake 16x16 mesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
mesh = make_production_mesh()
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(4, 2048, 4096), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(4096, 688), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    rec = Recorder()
    with rec:
        y = x @ w
    out["matmul"] = [rec.flops, dict(rec.ops), list(y.to_local().shape)]

cfg = dataclasses.replace(get_config("yi-6b").reduced(), n_layers=2,
                          n_heads=4, n_kv_heads=4, head_dim=16,
                          remat=True)
shape = dataclasses.replace(get_shape("train_4k"), global_batch=8,
                            seq_len=64)
rec = DR.run_cell("yi-6b", "train_4k", cfg_override=cfg,
                  shape_override=shape, mesh_shape=(4, 4), save=False)
out["cell"] = rec
one, _, _, _ = DR.lower_cell("yi-6b", "train_4k", cfg_override=cfg,
                             shape_override=shape, mesh_shape=(1, 1))
out["one_rank"] = one
for mode in DR.GEE_MODES + ["a2a_steady"]:
    out["gee_" + mode] = DR.run_gee(mode=mode, n=256 * 64, s=256 * 512,
                                    K=8, save=False)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    path = tmp_path_factory.mktemp("dry") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", DRY_SCRIPT, str(path)],
                       env=env, capture_output=True, text=True, timeout=600,
                       cwd=str(tmp_path_factory.mktemp("cwd")))
    assert r.returncode == 0, textwrap.shorten(r.stderr[-4000:], 4000)
    return json.loads(path.read_text())


def test_recorder_counts_one_ranks_local_ops(traced):
    """x (64, 2048, 4096) batch-sharded 16 ways times w (4096, 11008)
    column-sharded 16 ways: the local (8192 x 4096) @ (4096 x 688)
    product, once; the global product is never counted."""
    flops, ops, shape = traced["matmul"]
    assert shape == [4, 2048, 688]
    assert flops == 2 * 4 * 2048 * 4096 * 688
    assert ops.get("aten.mm.default") == 1


def _ref_arg_bytes(shape, mesh):
    """Params + m + v (float32) and int32 tokens per rank by the
    reference's rules: its arithmetic of tests/test_sharding.py."""
    from repro.sharding import make_rules as j_make_rules

    class FakeMesh:
        def __init__(self, s):
            self.shape, self.axis_names = s, tuple(s)

    jc = dataclasses.replace(j_get_config("yi-6b").reduced(), n_layers=2,
                             n_heads=4, n_kv_heads=4, head_dim=16,
                             remat=True)
    r = j_make_rules(FakeMesh(mesh))
    total = 0
    leaves = jax.tree_util.tree_leaves(JM.param_specs(jc),
                                       is_leaf=lambda s: hasattr(s,
                                                                 "logical"))
    for s in leaves:
        shards = 1
        for part in r.weight_spec(s.shape, s.logical):
            for a in (() if part is None else
                      part if isinstance(part, tuple) else (part,)):
                shards *= mesh[a]
        total += int(np.prod(s.shape)) // shards * (4 + 4 + 4)
    tok = r.act_spec(shape, ("batch", "seq"))
    shards = math.prod(mesh[a] for a in tok if a is not None)
    return total + int(np.prod(shape)) // shards * 4


def test_cell_record_matches_reference(traced):
    rec = traced["cell"]
    ref_keys = {"arch", "shape", "mesh", "chips", "flops_per_device",
                "bytes_per_device", "collective_bytes", "model_flops_global",
                "arg_bytes", "temp_bytes", "out_bytes", "collectives",
                "compute_s", "memory_s", "collective_s", "dominant",
                "step_s", "useful_flops_ratio", "mfu", "hbm_fit",
                "raw_scan_counted", "probe", "probe_s", "compile_s", "impl",
                "fsdp", "tag", "memory_analysis"}
    assert ref_keys <= set(rec)
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes"}
    assert rec["chips"] == 16 and rec["mesh"] == "mesh4x4"
    assert rec["arg_bytes"] == _ref_arg_bytes((8, 64),
                                              {"data": 4, "model": 4})
    # a uniform stack: the full-depth count is the probes' extrapolation
    assert rec["flops_per_device"] == rec["probe"]["flops"]
    assert rec["flops_per_device"] > 0 and rec["collective_bytes"] > 0
    kinds = {k for k, v in rec["collectives"].items() if v["count"]}
    assert {"all-gather", "all-reduce"} <= kinds


def test_sixteen_ranks_do_one_ranks_work(traced):
    """With every product sharded, 16 ranks' flops are one rank's:
    within 1 % (the per-rank count holds no replicated matmul)."""
    one = traced["one_rank"]["flops"]
    sixteen = traced["cell"]["flops_per_device"] * 16
    assert abs(sixteen - one) <= 0.01 * one, (sixteen, one)
    assert traced["one_rank"]["collectives"] == [] or all(
        c["group"] == 1 for c in traced["one_rank"]["collectives"])


@pytest.mark.parametrize("mode", ["ring", "a2a", "reduce_scatter",
                                  "replicated", "a2a_steady"])
def test_gee_modes_trace_their_collective(traced, mode):
    rec = traced["gee_" + mode]
    c = rec["collectives"]
    assert rec["chips"] == 256 and rec["bytes_bound"] is True
    want = {"ring": "collective-permute", "a2a": "all-to-all",
            "a2a_steady": "all-to-all", "reduce_scatter": "reduce-scatter",
            "replicated": "all-reduce"}[mode]
    assert c[want]["count"] > 0
    if mode == "ring":
        # the ring's p - 1 steps, each traced
        assert c["collective-permute"]["count"] == 255
        rows = 256 * 64 // 256
        assert c["collective-permute"]["bytes"] == 255 * rows * 8 * 4
    if mode == "replicated":
        # the full (n, K) Z all-reduced (and the dropped count)
        assert c["all-reduce"]["bytes"] >= 256 * 64 * 8 * 4
