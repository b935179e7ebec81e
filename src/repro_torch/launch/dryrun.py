"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step as one
rank of a 256- or 512-card mesh, on the host.

The port of `repro.launch.dryrun`.  The reference lowers and compiles
each cell's jitted step for 512 placeholder XLA host devices and reads
`cost_analysis()` and `memory_analysis()`.  Here the mesh is a
`DeviceMesh` over a `fake` process group of the mesh's size
(`launch.mesh`), every tensor is a `FakeTensor` (no memory, no data),
params, optimizer state, batch and caches are DTensors laid out by the
sharding rules, and the REAL step (the code the trainer and the server
run: `jit_train_step`, `prefill`, `decode_step`) runs once, eagerly,
under `costs.Recorder`, which counts this rank's local ops: flops,
bytes, collectives and live memory.  Fake tensors lie on the CPU, so
`impl="flash"` takes the plain `attn_flash` blocks, as the reference's
models lower the kernel's jnp twin.

The layer loop is Python, so the full-depth trace counts every layer,
and remat's recompute as it runs (no 4/3 correction).  `probe` keeps
the reference's depth-probe extrapolation (`analytic.extrapolate` of
depth-u and depth-2u traces) beside it as a cross-check.

Cuts, where a Python loop would trace for hours (the reference's):
  * xLSTM prefill beyond 4096 tokens traces at 4096 and scales flops,
    bytes and collective bytes by seq / 4096 (its every term is linear
    in T); memory is that of the 4096-token trace;
  * the sLSTM recurrence (a T-step loop) is not traced: the dry run
    stands in zeros for its outputs and adds its flops from
    `analytic.slstm_correction_flops`, over this rank's share of the
    batch rows (the recurrence runs batch-parallel, each rank its rows);
    its bytes and memory are not counted.
`run_cell` names the cut in the record (`cuts`).

GEE at Friendster scale (`run_gee`) traces `core/distributed.py`'s four
modes and `a2a_steady` on one rank's edge slice.  Masking by value
(`_scatter_rows`'s r[keep]) has a shape that depends on the data, so the
trace scatters every contribution unmasked and the ordered sum is
traced as `index_add_`: those bytes are an upper bound (`bytes_bound`
in the record).  The ring's p - 1 steps are traced in full, so the
reference's ring correction does not apply.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --gee [--multi-pod]

Records land in artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config, get_shape, list_archs
from repro_torch.launch import analytic
from repro_torch.launch import roofline as RL
from repro_torch.launch.costs import Recorder
from repro_torch.launch.mesh import make_gee_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import ParamTree, dtype_of, tree_map_specs
from repro_torch.sharding import make_rules, use_sharding
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_loop import jit_train_step
from repro_torch.training.trees import items

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "dryrun_torch")

#: xLSTM prefill traces at most this many tokens (then scales)
XLSTM_TRACE_SEQ = 4096


def mesh_name(mesh) -> str:
    sizes = tuple(mesh.shape)
    if tuple(mesh.mesh_dim_names) == ("edges",):
        return {256: "pod16x16", 512: "pod2x16x16"}.get(sizes[0],
                                                        f"edges{sizes[0]}")
    if sizes in ((16, 16), (2, 16, 16)):
        return "pod" + "x".join(map(str, sizes))
    return "mesh" + "x".join(map(str, sizes))


def _placed(shape, dtype, rules, spec):
    """A DTensor of global `shape` laid out by `spec`, its local piece an
    uninitialized (under FakeTensorMode: fake) tensor."""
    local = torch.empty(rules.local_shape(shape, spec), dtype=dtype)
    return DTensor.from_local(local, rules.mesh, rules.placements(spec),
                              run_check=False)


def _sharded_abstract(spec_tree, rules, default_dtype, *, params=False):
    """ParamSpec tree -> DTensors laid out by the weight rules (a
    ParamTree with `params`, else nested dicts; None stays None)."""
    out = tree_map_specs(
        lambda s: _placed(s.shape, dtype_of(s.dtype or default_dtype), rules,
                          rules.weight_spec(s.shape, s.logical)), spec_tree)
    return ParamTree(out) if params else out


def _batch_abstract(cfg, shape, rules):
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _placed((B, S), torch.int32, rules,
                             rules.act_spec((B, S), ("batch", "seq")))}
    if cfg.is_encdec:
        fshape = (B, cfg.n_frames, cfg.d_model)
        out["frames"] = _placed(fshape, dtype_of(cfg.compute_dtype), rules,
                                rules.act_spec(fshape,
                                               ("batch", "seq", "embed")))
    return out


def _local_bytes(tree) -> int:
    total = 0
    for _, t in items(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def _slstm_cut():
    """The sLSTM recurrence stood in by zeros of its outputs' shapes."""
    from repro_torch.models import xlstm as X
    orig = X.slstm_scan

    def zeros(xg_all, carry, r_h, bias):
        B, T, H, G4 = xg_all.shape
        hs = xg_all.new_zeros((B, T, H, G4 // 4))
        return (hs,) + tuple(s * 0 for s in carry)

    X.slstm_scan = zeros
    try:
        yield
    finally:
        X.slstm_scan = orig


def _data_shards(rules) -> int:
    sizes = dict(zip(rules.mesh.mesh_dim_names, rules.mesh.shape))
    return math.prod(sizes.get(a, 1) for a in ("pod", "data"))


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               impl: str = "flash", fsdp: bool = True,
               seq_shard_acts: bool = False, accum_steps: int = 1,
               compress_grads: bool = False, cfg_override=None,
               shape_override=None, mesh_shape=None):
    """Trace the cell's step as rank 0 of the mesh.  Returns (record,
    mesh, cfg, shape): the record's per-rank `flops`, `bytes`,
    `collectives` (the trace), `memory_analysis` and `cuts`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape_override if shape_override is not None \
        else get_shape(shape_name)
    if cfg_override is None and shape_name not in \
            [s.name for s in cfg.shapes()]:
        raise ValueError(f"{arch} skips {shape_name} "
                         f"(sub_quadratic={cfg.sub_quadratic})")
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    rules = make_rules(mesh, fsdp=fsdp, seq_shard_acts=seq_shard_acts)
    cuts, scale = [], 1.0
    traced = shape
    if cfg.xlstm is not None and shape.kind == "prefill" \
            and shape.seq_len > XLSTM_TRACE_SEQ:
        traced = dataclasses.replace(shape, seq_len=XLSTM_TRACE_SEQ)
        scale = shape.seq_len / XLSTM_TRACE_SEQ
        cuts.append(f"xlstm prefill traced at {XLSTM_TRACE_SEQ} tokens, "
                    f"costs x{scale:g}")
    slstm = cfg.xlstm is not None
    if slstm:
        cuts.append("sLSTM recurrence not traced: its flops from "
                    "slstm_correction_flops / data shards")
    rec = Recorder()
    t0 = time.time()
    with FakeTensorMode(), (_slstm_cut() if slstm
                            else contextlib.nullcontext()):
        params = _sharded_abstract(M.param_specs(cfg), rules,
                                   cfg.param_dtype, params=True)
        B, S = traced.global_batch, traced.seq_len
        alias = 0
        if traced.kind == "train":
            params.requires_grad_(True)
            opt = AdamW(state_dtype=cfg.state_dtype,
                        clip_norm=float(os.environ.get("DRYRUN_CLIP",
                                                       "1.0")))
            state = opt.init(params)      # m, v laid out as the params
            batch = _batch_abstract(cfg, traced, rules)
            step = jit_train_step(cfg, opt, mesh, rules, impl=impl,
                                  accum_steps=accum_steps,
                                  compress_grads=compress_grads)
            alias = _local_bytes(params) + _local_bytes(state.m) + \
                _local_bytes(state.v)
            arg_bytes = alias + _local_bytes(batch)
            with rec:
                out = step(params, state, batch)
        else:
            if traced.kind == "prefill":
                batch = _batch_abstract(cfg, traced, rules)
                arg_bytes = _local_bytes(params) + _local_bytes(batch)

                def run():
                    return M.prefill(cfg, params, batch, impl=impl)
            else:
                token = _placed((B,), torch.int32, rules,
                                rules.act_spec((B,), ("batch",)))
                cache = _sharded_abstract(M.cache_specs(cfg, B, S), rules,
                                          cfg.compute_dtype)
                alias = _local_bytes(cache)
                arg_bytes = _local_bytes(params) + _local_bytes(token) + \
                    alias + 4                       # pos: an int32

                def run():
                    return M.decode_step(cfg, params, token, S - 1, cache)
            with torch.no_grad(), use_sharding(mesh, rules), \
                    implicit_replication(), rec:
                out = run()
        out_bytes = rec.live_bytes
        del out
    record = {
        "flops": rec.flops * scale, "bytes": rec.bytes * scale,
        "collectives": [dict(c, bytes=c["bytes"] * scale)
                        for c in rec.collectives],
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": rec.peak_bytes,
            "alias_size_in_bytes": alias},
        "trace_s": time.time() - t0, "cuts": cuts,
        "local_ops": sum(rec.ops.values())}
    if slstm:
        record["flops"] += analytic.slstm_correction_flops(cfg, shape) \
            / _data_shards(rules)
    return record, mesh, cfg, shape


def _costs(record) -> dict:
    out = {"flops": float(record["flops"]), "bytes": float(record["bytes"])}
    colls = RL.parse_collectives(record["collectives"])
    for kind, v in colls.items():
        out[f"coll_{kind}"] = v["wire_bytes"]
    out["coll_total"] = sum(v["wire_bytes"] for v in colls.values())
    return out


def _probe_costs(arch, shape_name, cfg, **kw):
    """Depth-probe extrapolation (`launch.analytic`): the cell traced at
    unit and 2x-unit depth, extrapolated to full depth."""
    cfg_u, cfg_2u, n_units, tail_units = analytic.probe_unit(cfg)
    cost = [_costs(lower_cell(arch, shape_name, cfg_override=c, **kw)[0])
            for c in (cfg_u, cfg_2u)]
    return analytic.extrapolate(cost[0], cost[1], n_units, tail_units)


def run_cell(arch, shape_name, *, multi_pod=False, impl="flash",
             fsdp=True, seq_shard_acts=False, accum_steps=1,
             compress_grads=False, save=True, tag="", probe=True,
             cfg_override=None, shape_override=None, mesh_shape=None):
    kw = dict(multi_pod=multi_pod, impl=impl, fsdp=fsdp,
              seq_shard_acts=seq_shard_acts, accum_steps=accum_steps,
              compress_grads=compress_grads, shape_override=shape_override,
              mesh_shape=mesh_shape)
    t0 = time.time()
    record, mesh, cfg, shape = lower_cell(arch, shape_name,
                                          cfg_override=cfg_override, **kw)
    dt = time.time() - t0
    name = mesh_name(mesh)
    chips = mesh.size()
    rl = RL.build(arch, shape, name, chips, record, cfg)
    rec = rl.to_dict()
    # the full-depth trace counts every layer: nothing is undercounted
    rec["raw_scan_counted"] = {
        "flops": rl.flops_per_device, "bytes": rl.bytes_per_device,
        "collective_bytes": rl.collective_bytes}
    if probe:
        t1 = time.time()
        rec["probe"] = _probe_costs(arch, shape_name, cfg, **kw)
        rec["probe_s"] = time.time() - t1
    rec["compile_s"] = dt            # the trace's host seconds
    rec["impl"] = impl
    rec["fsdp"] = fsdp
    rec["tag"] = tag
    rec["memory_analysis"] = record["memory_analysis"]
    rec["cuts"] = record["cuts"]
    rec["local_ops"] = record["local_ops"]
    if save:
        d = os.path.join(ART, name)
        os.makedirs(d, exist_ok=True)
        fn = f"{arch}__{shape.name}{('__' + tag) if tag else ''}.json"
        with open(os.path.join(d, fn), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"[dryrun] {name} {arch:18s} {shape.name:12s} "
          f"trace={dt:6.1f}s flops/dev={rl.flops_per_device:.3e} "
          f"bytes/dev={rl.bytes_per_device:.3e} "
          f"coll/dev={rl.collective_bytes:.3e} dom={rl.dominant:10s} "
          f"args+tmp={(rl.arg_bytes + rl.temp_bytes)/1e9:7.2f}GB "
          f"mfu={rl.mfu:.3f}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# GEE (the paper's own workload) at Friendster scale
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _gee_tracing():
    """Data-dependent shapes out of the GEE bodies: every contribution
    scattered unmasked, the ordered sum as `index_add_` (the bytes of
    both are an upper bound)."""
    from repro_torch.core import distributed as D
    from repro_torch.core import gee as G
    orig = D._scatter_rows, G.add_in_order

    def scatter_rows(rows, K, r, c, v, device):
        Z = torch.zeros((rows, K), dtype=torch.float32, device=device)
        return G.scatter_add_ordered(Z, r, c, v)

    def add_in_order(flat, idx, val):
        return flat.index_add_(0, idx.long(), val.to(flat.dtype))

    D._scatter_rows, G.add_in_order = scatter_rows, add_in_order
    try:
        yield
    finally:
        D._scatter_rows, G.add_in_order = orig


def run_gee(*, multi_pod=False, mode="ring", n=65_000_000,
            s=1_800_000_000, K=50, save=True):
    """One rank's trace of `core.distributed.gee_sharded` (or
    `gee_a2a_steady`) at Friendster scale on the 256- or 512-rank edge
    mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import distributed as D
    mesh = make_gee_mesh(multi_pod=multi_pod)
    p = mesh.size()
    n_pad = D.pad_rows(n, p)
    s_pad = D.pad_rows(s, p)
    per = s_pad // p
    rec = Recorder()
    t0 = time.time()
    with FakeTensorMode(), _gee_tracing():
        Y = torch.empty(n_pad, dtype=torch.int32)
        if mode == "a2a_steady":
            # pre-bucketed steady state: gather -> all_to_all -> scatter
            cap = int(math.ceil(2 * per / p * 2.0)) + 8
            b_dst = torch.empty((p, cap), dtype=torch.int32)
            b_src = torch.empty((p, cap), dtype=torch.int32)
            b_w = torch.empty((p, cap), dtype=torch.float32)
            args = (b_dst, b_src, b_w, Y)
            with rec:
                out = D.gee_a2a_steady(b_dst, b_src, b_w, Y, K=K,
                                       n_pad=n_pad, mesh=mesh)
        else:
            u = torch.empty(per, dtype=torch.int32)
            v = torch.empty(per, dtype=torch.int32)
            w = torch.empty(per, dtype=torch.float32)
            args = (u, v, w, Y)
            with rec:
                out = D.gee_sharded(u, v, w, Y, K=K, n=n_pad, mesh=mesh,
                                    mode=mode)
        arg_bytes = sum(a.numel() * a.element_size() for a in args)
        out_bytes = rec.live_bytes
        del out
    dt = time.time() - t0
    colls = RL.parse_collectives(rec.collectives)
    wire = sum(c["wire_bytes"] for c in colls.values())
    name = mesh_name(mesh)
    rec_out = {
        "arch": "gee-friendster", "shape": f"gee_{mode}", "mesh": name,
        "chips": p, "compile_s": dt,
        "flops_per_device": float(rec.flops),
        "bytes_per_device": float(rec.bytes),
        "bytes_bound": True,
        "collective_bytes": wire, "collectives": colls,
        "compute_s": float(rec.flops) / RL.PEAK_FLOPS,
        "memory_s": rec.bytes / RL.HBM_BW,
        "collective_s": wire / RL.ICI_BW,
        "arg_bytes": arg_bytes,
        "temp_bytes": rec.peak_bytes,
        "out_bytes": out_bytes,
        "model_edges": s,
        "local_ops": sum(rec.ops.values()),
    }
    rec_out["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                              key=lambda k: rec_out[k]).replace("_s", "")
    if save:
        d = os.path.join(ART, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"gee__{mode}.json"), "w") as f:
            json.dump(rec_out, f, indent=1)
    print(f"[dryrun] {name} gee-friendster mode={mode:14s} "
          f"trace={dt:6.1f}s flops/dev={rec_out['flops_per_device']:.3e} "
          f"bytes/dev={rec_out['bytes_per_device']:.3e} "
          f"coll/dev={wire:.3e} dom={rec_out['dominant']} "
          f"args+tmp={(arg_bytes + rec.peak_bytes)/1e9:7.2f}GB",
          flush=True)
    return rec_out


GEE_MODES = ["ring", "a2a", "reduce_scatter", "replicated"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--gee", action="store_true")
    ap.add_argument("--gee-mode", default=None,
                    help="ring|a2a|reduce_scatter|replicated|a2a_steady "
                         "(default the four modes)")
    ap.add_argument("--impl", default="flash",
                    choices=["flash", "triangular", "full"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--seq-shard-acts", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    failures = []
    if args.gee:
        modes = [args.gee_mode] if args.gee_mode else GEE_MODES
        for mode in modes:
            try:
                run_gee(multi_pod=args.multi_pod, mode=mode)
            except Exception as e:         # report every mode's outcome
                traceback.print_exc()
                failures.append(("gee", mode, repr(e)))
    elif args.all:
        for arch in list_archs():
            cfg = get_config(arch)
            for shape in cfg.shapes():
                try:
                    # probes are a single-pod deliverable; the multi-pod
                    # pass proves the pod axis shards
                    run_cell(arch, shape.name, multi_pod=args.multi_pod,
                             impl=args.impl, fsdp=not args.no_fsdp,
                             seq_shard_acts=args.seq_shard_acts,
                             accum_steps=args.accum_steps, tag=args.tag,
                             probe=not args.multi_pod)
                except Exception as e:     # report every cell's outcome
                    traceback.print_exc()
                    failures.append((arch, shape.name, repr(e)))
            for skipped in cfg.skipped_shapes():
                print(f"[dryrun] SKIP {arch} {skipped} (full attention)")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all, or --gee)")
        run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                 impl=args.impl, fsdp=not args.no_fsdp,
                 seq_shard_acts=args.seq_shard_acts,
                 accum_steps=args.accum_steps,
                 compress_grads=args.compress_grads, tag=args.tag)

    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("   ", f)
        sys.exit(1)
    print("[dryrun] OK")


if __name__ == "__main__":
    main()
