"""The port's sharding rules against the JAX package's, on the CPU.

Specs are pure functions of the mesh's shape and the logical axes, so
both packages get the same shape-only mesh.  Every param of every arch,
on 16x16 and 2x16x16, with FSDP on and off and sequence-sharded
activations off and on, gets the reference's `PartitionSpec` entry for
entry; the activation specs of the reference's `tests/test_sharding.py`
too; per-rank param + optimizer bytes equal the reference's arithmetic
exactly.  A subprocess over a fake 256- and 512-rank process group
checks that the placements made from each spec cut real tensors into
the pieces the spec says (exact: shapes are integers)."""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import model as JM
from repro.models.layers import tree_map_specs as j_tree_map_specs
from repro.sharding import make_rules as j_make_rules
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models.layers import spec_leaves
from repro_torch.sharding import (make_rules, spec_tree_pspecs,
                                  spec_tree_shardings)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = j_list_archs()


class FakeMesh:
    """Shape-only stand-in (rules never touch devices)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ref_leaves(tree):
    """(key path, ParamSpec) of the reference's spec tree, sorted keys."""
    out = []

    def walk(t, prefix):
        if hasattr(t, "logical"):
            out.append((prefix, t))
            return
        for k in sorted(t):
            walk(t[k], prefix + (k,))

    walk(tree, ())
    return out


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_weight_specs_equal_reference(arch, mesh, fsdp, seq_shard):
    jr = j_make_rules(FakeMesh(MESHES[mesh]), fsdp=fsdp,
                      seq_shard_acts=seq_shard)
    tr = make_rules(FakeMesh(MESHES[mesh]), fsdp=fsdp,
                    seq_shard_acts=seq_shard)
    ref = _ref_leaves(JM.param_specs(j_get_config(arch)))
    port = list(spec_leaves(TM.param_specs(get_config(arch))))
    assert [p for p, _ in ref] == [p for p, _ in port]
    # the tree helper answers leaf by leaf as weight_spec does
    tree = spec_tree_pspecs(tr, TM.param_specs(get_config(arch)))
    for (path, js), (_, ts) in zip(ref, port):
        assert (tuple(js.shape), tuple(js.logical)) == (ts.shape, ts.logical)
        want = tuple(jr.weight_spec(js.shape, js.logical))
        got = tr.weight_spec(ts.shape, ts.logical)
        node = tree
        for k in path:
            node = node[k]
        assert got == want == node, (path, got, want, node)


ACT_CASES = [
    # the reference's tests/test_sharding.py activation cases
    ("16x16", {}, (256, 4096, 4096), ("batch", "seq", "embed")),
    ("16x16", {}, (256, 4096, 32, 128), ("batch", "seq", "heads", None)),
    ("16x16", {"seq_shard_acts": True}, (256, 4096, 4096),
     ("batch", "seq", "embed")),
    # and the model's ashard sites at yi-6b's and xlstm's widths
    ("16x16", {}, (256, 4096, 4, 128), ("batch", "seq", "kv_heads", None)),
    ("2x16x16", {}, (256, 4096, 32, 128), ("batch", "seq", "heads", None)),
    ("16x16", {}, (256, 4096, 11008), ("batch", "seq", "mlp")),
    ("16x16", {}, (256, 4096, 64000), ("batch", "seq", "vocab")),
    ("16x16", {"seq_shard_acts": True}, (256, 4096, 32, 128),
     ("batch", "seq", "heads", None)),
    ("2x16x16", {"seq_shard_acts": True}, (8, 32768, 4096),
     ("batch", "seq", "embed")),
    ("16x16", {}, (128,), ("batch",)),
]


@pytest.mark.parametrize("case", range(len(ACT_CASES)))
def test_act_specs_equal_reference(case):
    mesh, kw, shape, logical = ACT_CASES[case]
    jr = j_make_rules(FakeMesh(MESHES[mesh]), **kw)
    tr = make_rules(FakeMesh(MESHES[mesh]), **kw)
    assert tr.act_spec(shape, logical) == tuple(jr.act_spec(shape, logical))


def test_reference_unit_cases():
    """The reference's spec unit tests, on the port."""
    r = make_rules(FakeMesh(MESHES["16x16"]))
    assert r.weight_spec((4096, 11008), ("embed", "mlp")) == ("data", "model")
    assert r.weight_spec((48, 4096, 11008), ("layers", "embed", "mlp")) == \
        (None, "data", "model")
    assert r.weight_spec((2048, 4, 512), ("embed", "heads", None)) == \
        ("data",)
    assert r.weight_spec((51865, 1024), ("vocab", "embed")) == (None, "data")
    assert r.weight_spec((4096, 4096), ("mlp", "vocab")) == ("model",)
    r2 = make_rules(FakeMesh(MESHES["2x16x16"]))
    assert r2.weight_spec((4096, 11008), ("embed", "mlp")) == \
        (("pod", "data"), "model")
    assert make_rules(FakeMesh(MESHES["16x16"]), fsdp=False).weight_spec(
        (4096, 11008), ("embed", "mlp")) == (None, "model")


@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_bytes_equal_reference(arch):
    """Param + optimizer-state (+ f32 grad) bytes per rank under the
    weight rules at 16x16: the reference's arithmetic
    (tests/test_sharding.py:116-140) against the port's local shapes."""
    import jax.numpy as jnp
    jc, tc = j_get_config(arch), get_config(arch)
    jr = j_make_rules(FakeMesh(MESHES["16x16"]))
    tr = make_rules(FakeMesh(MESHES["16x16"]))
    pbytes = jnp.dtype(jc.param_dtype).itemsize
    sbytes = jnp.dtype(jc.state_dtype).itemsize
    ref = 0.0

    def acc(s):
        nonlocal ref
        ps = jr.weight_spec(s.shape, s.logical)
        shards = 1
        for part in ps:
            if part is None:
                continue
            for a in (part if isinstance(part, tuple) else (part,)):
                shards *= jr.mesh.shape[a]
        ref += int(np.prod(s.shape)) / shards * (pbytes + 2 * sbytes + 4)
        return s

    j_tree_map_specs(acc, JM.param_specs(jc))
    import torch
    from repro_torch.models.layers import dtype_of
    tp = torch.empty((), dtype=dtype_of(tc.param_dtype)).element_size()
    ts = torch.empty((), dtype=dtype_of(tc.state_dtype)).element_size()
    port = 0
    for _, s in spec_leaves(TM.param_specs(tc)):
        local = tr.local_shape(s.shape, tr.weight_spec(s.shape, s.logical))
        port += math.prod(local) * (tp + 2 * ts + 4)
    assert port == ref


def test_spec_tree_shardings_are_placements():
    from torch.distributed.tensor import Replicate, Shard
    tr = make_rules(FakeMesh(MESHES["2x16x16"]))
    from repro_torch.training.train_loop import spec_leaves_of
    pl = dict(spec_leaves_of(spec_tree_shardings(
        tr, TM.param_specs(get_config("yi-6b")))))
    assert pl[("stack", "mlp", "w_gate")] == (Shard(1), Shard(1), Shard(2))
    assert pl[("stack", "attn", "wk")] == (Shard(1), Shard(1), Replicate())
    assert pl[("embed", "tokens")] == (Shard(1), Shard(1), Shard(0))
    assert tr.placements((("pod", "data"), "model")) == (Shard(0), Shard(0),
                                                         Shard(1))


PLACE_SCRIPT = r"""
import json, sys
import torch
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import spec_leaves
from repro_torch.sharding import make_rules
from repro_torch.sharding.rules import distribute, local_piece
from torch.distributed.tensor import distribute_tensor

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    rules = make_rules(mesh)
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        for path, s in spec_leaves(M.param_specs(cfg)):
            spec = rules.weight_spec(s.shape, s.logical)
            pl = rules.placements(spec)
            t = torch.arange(float(torch.Size(s.shape).numel())).view(
                s.shape)
            mine = distribute(t, mesh, pl)
            theirs = distribute_tensor(t, mesh, pl)
            key = f"{int(multi)}|{arch}|{'/'.join(path)}"
            out[key] = [list(s.shape), [list(a) if isinstance(a, tuple)
                                        else a for a in spec],
                        list(mine.to_local().shape),
                        list(theirs.to_local().shape),
                        bool(torch.equal(mine.to_local(),
                                         local_piece(t, mesh, pl)))]
json.dump(out, open(sys.argv[1], "w"))
"""


def test_placements_cut_real_tensors(tmp_path):
    """On a fake 256- and 512-rank mesh (this process rank 0), every
    reduced arch's param, placed from its spec, has the local shape the
    spec implies, the same as `distribute_tensor` gives it."""
    out = tmp_path / "place.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", PLACE_SCRIPT, str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, textwrap.shorten(r.stderr[-3000:], 3000)
    got = json.loads(out.read_text())
    assert len(got) > 100
    for key, (shape, spec, mine, theirs, same) in got.items():
        multi = key.startswith("1")
        sizes = MESHES["2x16x16" if multi else "16x16"]
        want = list(shape)
        for d, entry in enumerate(spec):
            axes = [] if entry is None else (
                entry if isinstance(entry, list) else [entry])
            want[d] //= math.prod(sizes[a] for a in axes)
        assert mine == want == theirs, (key, mine, want, theirs)
        assert same, key
