"""The sharded train step, the sequence-sharded decode and the elastic
re-mesh on gloo worlds of 2 and 4 worker processes (a FileStore
rendezvous in tmp_path, OMP_NUM_THREADS=1), against the unsharded port
and the JAX package.

The model is yi-6b's reduced config at 2 layers with 4 query heads and 1
KV head: on a model axis of 2, `heads` shards (2 a rank) while `kv_heads`
falls back to replicated, the yi-6b-on-16 trap; each rank's attention
reads the KV head its query heads read (`attention._on_local_heads`).
Meshes: (data 1, model 2) on 2 ranks, (data 2, model 2) on 4.

Tolerances, float32 throughout:
  * step-1 gradients (each brought to its parameter's placements, then
    gathered) within 1e-5 of each leaf's largest unsharded gradient, and
    within the training tests' GRAD_TOL (1e-4) of the reference's
    `jax.value_and_grad` on the same tempered weights; the loss within
    1e-6 (relative) of the unsharded port's and GRAD_TOL of the
    reference's.  The sharded sums run in another order, so the bits
    differ.
  * the params after two AdamW steps within PARAM_TOL = 3e-5 of each
    leaf's largest entry (measured 1.25e-5, w_down on 4 ranks; the
    gradients agree to 1.4e-6).  AdamW divides each element's step by
    its own gradient scale, so an element whose gradient is small turns
    a float32 reordering into a larger relative move; 1e-5 is not
    reached after two steps.
  * `_decode_attn_seq_sharded` within 1e-5 of `_decode_attn_local`
    (max abs, outputs of order 1), and the cache written bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import model as JM

ROOT = Path(__file__).resolve().parents[1]
WORLDS = [2, 4]
GRAD_TOL = 1e-4
PARAM_TOL = 3e-5
LR = 3e-4
SHAPE = dict(n_layers=2, n_heads=4, n_kv_heads=1, head_dim=16)
B, S = 4, 64


def temper(tree, parent=""):
    """Each attention's wq and wk scaled from 1/sqrt(heads) to
    1/sqrt(d_model) (as tests/test_torch_training.py does)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = temper(v, k)
        else:
            v = np.asarray(v)
            if "attn" in parent and k in ("wq", "wk"):
                v = (v * np.sqrt(v.shape[-2] / v.shape[-3])).astype(v.dtype)
            out[k] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


RANK_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import ParamTree
from repro_torch.sharding import make_rules, spec_tree_shardings, use_sharding
from repro_torch.sharding.rules import distribute
from repro_torch.training.fault_tolerance import (ElasticMeshManager,
                                                   simulate_failure)
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_loop import (jit_train_step, make_train_step,
                                             place_batch, place_tree)
from repro_torch.training.trees import build, items

d = dict(np.load(data))
shape = json.loads(str(d.pop("shape")))
cfg = dataclasses.replace(get_config("yi-6b").reduced(), **shape)
tree = {}
for k, v in d.items():
    if k.startswith("p:"):
        node = tree
        parts = k[2:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
batches = [torch.as_tensor(d["tok0"]), torch.as_tensor(d["tok1"])]
res = {}

def fresh():
    p = params_from_jax(cfg, tree, device="cpu")
    p.requires_grad_(True)
    return p

mesh = DeviceMesh("cpu", torch.arange(world).view(world // 2, 2),
                  mesh_dim_names=("data", "model"))
rules = make_rules(mesh)

# step-1 gradients, unsharded and sharded
p0 = fresh()
tot, _ = M.forward_train(cfg, p0, {"tokens": batches[0]})
paths, leaves = zip(*items(p0))
g0 = torch.autograd.grad(tot, leaves)
sh = place_tree(fresh(), spec_tree_shardings(rules, M.param_specs(cfg)), mesh)
with use_sharding(mesh, rules), implicit_replication():
    tot1, _ = M.forward_train(cfg, sh, place_batch({"tokens": batches[0]},
                                                   mesh, rules))
    ls = [t for _, t in items(sh)]
    g1 = torch.autograd.grad(tot1, ls)
    g1 = [g.redistribute(p.device_mesh, p.placements).full_tensor()
          for g, p in zip(g1, ls)]
res["loss_plain"] = float(tot)
res["loss_sharded"] = float(tot1.full_tensor())
for path, a, b in zip(paths, g0, g1):
    res["g0:" + "/".join(path)] = a.numpy()
    res["g1:" + "/".join(path)] = b.numpy()

# two steps of each
opt = AdamW(lr=%(lr)r)
ref, st, step = fresh(), None, make_train_step(cfg, opt)
st = opt.init(ref)
for i, b in enumerate(batches):
    ref, st, m = step(ref, st, {"tokens": b})
    res[f"plain_loss{i}"] = float(m["loss"])
jstep = jit_train_step(cfg, opt, mesh, rules)
sp = fresh()
ss = opt.init(sp)
for i, b in enumerate(batches):
    sp, ss, m = jstep(sp, ss, {"tokens": b})
    res[f"sharded_loss{i}"] = float(m["loss"].full_tensor())
res["placed"] = np.asarray(all(isinstance(t, DTensor)
                               for _, t in items(sp)))
for (path, a), (_, b) in zip(items(ref), items(sp)):
    res["p0:" + "/".join(path)] = a.detach().numpy()
    res["p1:" + "/".join(path)] = b.full_tensor().detach().numpy()

# sequence-sharded decode on model = 2 (and 4 on 4 ranks)
rng = np.random.default_rng(5)
Bd, Sd, H, KV, Dh = 4, 32, 4, 2, 8
kc = rng.standard_normal((Bd, Sd, KV, Dh)).astype(np.float32)
vc = rng.standard_normal((Bd, Sd, KV, Dh)).astype(np.float32)
q = rng.standard_normal((Bd, H, Dh)).astype(np.float32)
nk = rng.standard_normal((Bd, KV, Dh)).astype(np.float32)
nv = rng.standard_normal((Bd, KV, Dh)).astype(np.float32)
dcfg = get_config("yi-6b")
for model in (2, 4):
    if model > world:
        continue
    dmesh = DeviceMesh("cpu", torch.arange(world).view(world // model,
                                                      model),
                       mesh_dim_names=("data", "model"))
    drules = make_rules(dmesh)
    for pos in (13, Sd - 1, 0):
        plain = {"k": torch.as_tensor(kc.copy()),
                 "v": torch.as_tensor(vc.copy())}
        want, plain = A._decode_attn_local(dcfg, plain, torch.as_tensor(q),
                                           torch.as_tensor(nk),
                                           torch.as_tensor(nv), pos)
        spec = drules.weight_spec((Bd, Sd, KV, Dh),
                                  ("batch", "kv_seq", "kv_heads", None))
        pl = drules.placements(spec)
        cache = {"k": distribute(torch.as_tensor(kc), dmesh, pl),
                 "v": distribute(torch.as_tensor(vc), dmesh, pl)}
        got, cache = A._decode_attn_seq_sharded(
            dcfg, dmesh, cache, torch.as_tensor(q), torch.as_tensor(nk),
            torch.as_tensor(nv), pos)
        key = f"dec{model}_{pos}"
        res[key + "_want"] = want.numpy()
        res[key + "_got"] = got.full_tensor().numpy()
        res[key + "_spec"] = np.asarray(str(spec))
        res[key + "_cache"] = np.asarray(all(
            torch.equal(cache[n].full_tensor(), plain[n]) for n in "kv"))
        # the dispatch takes the sharded path under a mesh
        with use_sharding(dmesh, drules):
            o2, _ = A.decode_attention(dcfg, {n: distribute(
                torch.as_tensor(x), dmesh, pl) for n, x in
                (("k", kc), ("v", vc))}, torch.as_tensor(q),
                torch.as_tensor(nk), torch.as_tensor(nv), pos, mesh=dmesh)
        res[key + "_dispatch"] = o2.full_tensor().numpy()

# elastic re-mesh after a failure (4 ranks: one lost)
if world == 4:
    built = []
    mgr = ElasticMeshManager(lambda m: built.append(tuple(m.shape)) or "s",
                             model_axis_size=2, device_type="cpu")
    healthy = simulate_failure(list(range(world)), 1)
    new, step_fn, gen = mgr.remesh(healthy)
    res["remesh"] = np.asarray([*new.shape, gen, len(built)])
    res["remesh_names"] = np.asarray(",".join(new.mesh_dim_names))
    if rank in (0, 1):
        t = torch.full((1,), float(rank + 1))
        dist.all_reduce(t, group=new.get_group("model"))
        res["remesh_sum"] = t.numpy()
dist.barrier()
dist.destroy_process_group()
np.savez(out, **res)
""" % {"lr": LR}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: [rank 0's results, ...], "ref": the reference's step-1
    loss and gradients}."""
    tmp = tmp_path_factory.mktemp("sharded")
    jc = dataclasses.replace(j_get_config("yi-6b").reduced(), **SHAPE)
    tree = temper(jax.tree_util.tree_map(
        np.asarray, JM.init_params(jc, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
            for _ in range(2)]
    import json
    np.savez(tmp / "data.npz", shape=json.dumps(SHAPE), tok0=toks[0],
             tok1=toks[1], **{"p:" + k: v for k, v in _flat(tree).items()})
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    # the reference's loss and gradients on the same weights and batch
    def loss_fn(params):
        return JM.forward_train(jc, params, {"tokens": jnp.asarray(
            toks[0])})[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    # one world at a time: at most 4 worker processes beside the other
    # test files' (the suite runs on several pytest workers)
    errors = []
    for p in WORLDS:
        procs = [(r, subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(r), str(p),
             str(tmp / f"store{p}"), str(tmp / "data.npz"),
             str(tmp / f"w{p}_r{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)) for r in range(p)]
        try:
            for r, proc in procs:
                _, err = proc.communicate(timeout=400)
                if proc.returncode:
                    errors.append(f"world {p} rank {r}: rc "
                                  f"{proc.returncode}\n"
                                  + textwrap.shorten(err[-3000:], 3000))
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    assert not errors, "\n".join(errors)
    out = {p: [dict(np.load(tmp / f"w{p}_r{r}.npz")) for r in range(p)]
           for p in WORLDS}
    out["ref"] = {"loss": float(jloss), **{
        "g:" + k: v for k, v in _flat(jax.tree_util.tree_map(
            np.asarray, jgrads)).items()}}
    return out


def _keys(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gradients_match(worlds, world):
    ref = worlds["ref"]
    for res in worlds[world]:
        names = _keys(res, "g0:")
        assert names and names == _keys(res, "g1:")
        assert names == sorted(k[2:] for k in ref if k.startswith("g:"))
        for k in names:
            a, b = res["g0:" + k], res["g1:" + k]
            scale = np.abs(a).max()
            assert np.abs(a - b).max() <= 1e-5 * scale, k
            j = ref["g:" + k]
            assert np.abs(b - j).max() <= GRAD_TOL * np.abs(j).max(), k


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_loss_matches(worlds, world):
    ref = worlds["ref"]["loss"]
    for res in worlds[world]:
        plain, sharded = float(res["loss_plain"]), float(res["loss_sharded"])
        assert abs(sharded - plain) <= 1e-6 * abs(plain)
        assert abs(sharded - ref) <= GRAD_TOL * abs(ref)
        for i in range(2):
            a, b = float(res[f"plain_loss{i}"]), float(res[f"sharded_loss{i}"])
            assert abs(a - b) <= 1e-6 * abs(a), i


@pytest.mark.parametrize("world", WORLDS)
def test_two_sharded_steps_match(worlds, world):
    for res in worlds[world]:
        assert bool(res["placed"])
        names = _keys(res, "p0:")
        assert names == _keys(res, "p1:")
        for k in names:
            a, b = res["p0:" + k], res["p1:" + k]
            assert np.abs(a - b).max() <= PARAM_TOL * np.abs(a).max(), k
        # every rank holds the same full params
        for k in names:
            np.testing.assert_array_equal(res["p1:" + k],
                                          worlds[world][0]["p1:" + k])


@pytest.mark.parametrize("world", WORLDS)
def test_seq_sharded_decode_matches_local(worlds, world):
    for res in worlds[world]:
        keys = [k[:-5] for k in res if k.startswith("dec")
                and k.endswith("_want")]
        assert len(keys) == 3 * (1 if world == 2 else 2)
        for key in keys:
            want, got = res[key + "_want"], res[key + "_got"]
            assert np.abs(want - got).max() <= 1e-5, key
            assert bool(res[key + "_cache"]), key
            np.testing.assert_array_equal(res[key + "_dispatch"], got)
            # the cache is sequence-sharded over the model axis
            assert "'model'" in str(res[key + "_spec"]), key


def test_remesh_after_failure(worlds):
    for rank, res in enumerate(worlds[4]):
        data, model, gen, built = res["remesh"]
        assert (data, model, gen, built) == (1, 2, 1, 1)
        assert str(res["remesh_names"]) == "data,model"
        if rank in (0, 1):
            assert res["remesh_sum"].tolist() == [3.0]


@pytest.mark.parametrize("H,KV,model", [(32, 4, 16), (12, 3, 2), (8, 8, 4),
                                        (4, 1, 2)])
def test_local_kv_heads_read_what_each_head_reads(H, KV, model):
    """On the CPU, the local-head selection around the plain attention:
    each rank's heads against the whole attention's slice, exactly (the
    same per-head arithmetic)."""
    import torch
    from repro_torch.models import attention as TA
    rng = np.random.default_rng(H + KV + model)
    B, S, D, chunk = 2, 48, 8, 16
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32)) for h in (H, KV, KV))
    whole = TA.causal_plain(q, k, v, chunk)
    per = H // model
    for r in range(model):
        heads = range(r * per, (r + 1) * per)
        sel = TA.local_kv_heads(heads, H, KV)
        got = TA.causal_plain(q[:, :, r * per:(r + 1) * per], k[:, :, sel],
                              v[:, :, sel], chunk)
        torch.testing.assert_close(got, whole[:, :, heads], atol=1e-6,
                                   rtol=0)
        G = H // KV
        want = [h // G for h in heads]
        got_kv = list(range(KV))[sel] if isinstance(sel, slice) else sel
        assert sorted(set(got_kv)) == sorted(set(want))
