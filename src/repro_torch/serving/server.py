"""Serving CLI: a synthetic SBM workload of mixed reads and writes.

The port of `repro.serving.server`, with the same flags plus
``--device`` ("cuda" by default; with it the engine's shards run the
cuda backend, so `gee_scatter`, `gee_delta_renorm` and `topk_fused` are
launched; ``--device cpu`` runs the streaming backend on the CPU).

Builds an SBM graph, stands up GraphStore -> ServingEngine ->
MicroBatcher, then runs `--steps` workload ticks.  Each tick enqueues a
mix of reads (embedding gathers, centroid label predictions, top-k
neighbour lookups) and writes (edge insert batches, deletions of earlier
inserts, label reveals).  With `--sync-flush` the CLI flushes after
each tick; by default the engine's background flush loop drains the
queue and the CLI joins the tickets at the end of each tick.
Periodic compaction (a checkpoint with `--data-dir`) starts a new epoch.

`--shards N` runs the row-partitioned scatter/gather path;
`--data-dir` makes the engine durable (WAL + snapshots) and finishes
with a recovery self-check: reopen the deployment from disk and verify
the exact `(version, epoch, fingerprint)` plus Z, and a held-back top-k
answer, against the live engine.

Not ported yet (they raise NotImplementedError): `--index ivf`
(ROADMAP queue A.3), and `--transport socket`, `--connect`,
`--replicas` and `--serve-shard` (A.7).

Printed at the end: per-kind throughput and latency, the version and
epoch counters, and a self-check that the delta-maintained Z matches a
from-scratch fit (max |dZ|).

    PYTHONPATH=src python -m repro_torch.serving.server --device cpu \
        --n 2000 --edges 40000 --steps 30 --shards 4
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.gee import gee
from repro_torch.device import resolve_device
from repro_torch.graph.edges import make_labels
from repro_torch.graph.generators import sbm
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.store import GraphStore


def _self_check(engine: ServingEngine) -> float:
    """Max |delta-maintained Z - from-scratch Z| under epoch labels."""
    g = engine.store.edges()
    dev = engine.device
    Z = gee(*(torch.as_tensor(np.asarray(a), device=dev)
              for a in (g.u, g.v, g.w, engine.Y_epoch)),
            K=engine.store.K, n=g.n)
    return float((Z - engine.Z).abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--k", type=int, default=8, help="communities/classes")
    ap.add_argument("--edges", type=int, default=40_000)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--shards", type=int, default=1,
                    help="row-partition Z across N shard workers")
    ap.add_argument("--data-dir", default=None,
                    help="durable deployment dir (WAL + snapshots); "
                         "adds a crash-recovery self-check at the end")
    ap.add_argument("--sync-flush", action="store_true",
                    help="flush the batcher inline instead of running "
                         "the engine's background flush loop")
    ap.add_argument("--reads-per-step", type=int, default=8)
    ap.add_argument("--read-nodes", type=int, default=64)
    ap.add_argument("--write-batch", type=int, default=200)
    ap.add_argument("--label-frac", type=float, default=0.1)
    ap.add_argument("--compact-every", type=int, default=10)
    ap.add_argument("--rebuild-churn", type=float, default=0.05)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--index", choices=["ivf"], default=None,
                    help="serve top-k through the IVF index (not ported "
                         "yet: raises)")
    ap.add_argument("--nprobe", type=int, default=None,
                    help="IVF cells probed per query")
    ap.add_argument("--index-churn", type=float, default=0.25,
                    help="re-quantize the index past this moved-rows "
                         "fraction")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-dump", action="store_true",
                    help="print the metrics registry (Prometheus text "
                         "format) and health state at the end")
    ap.add_argument("--transport", choices=["local", "socket"],
                    default="local",
                    help="'socket' runs each shard in its own worker "
                         "process (not ported yet: raises)")
    ap.add_argument("--connect", default=None, metavar="ADDR,ADDR,...",
                    help="connect to external shard workers (not ported "
                         "yet: raises)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="WAL-tail read replica workers (not ported yet: "
                         "raises)")
    ap.add_argument("--serve-shard", default=None, metavar="HOST:PORT",
                    help="be a shard worker (not ported yet: raises)")
    ap.add_argument("--shard-id", type=int, default=0,
                    help="which shard --serve-shard hosts")
    ap.add_argument("--fsync", action="store_true",
                    help="fsync WAL appends (power-loss durability)")
    ap.add_argument("--group-commit-ms", type=float, default=None,
                    help="batch WAL fsync barriers: max age of an "
                         "uncovered append")
    ap.add_argument("--group-commit-bytes", type=int, default=None,
                    help="batch WAL fsync barriers: bytes per group")
    ap.add_argument("--shutdown-workers", action="store_true",
                    help="shut down remote workers at exit (no remote "
                         "workers without the transport)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the "
                         "streaming backend's plain torch)")
    args = ap.parse_args(argv)

    if args.serve_shard is not None:
        raise NotImplementedError(
            "--serve-shard: shard worker processes (transport/) are not "
            "ported yet (ROADMAP queue A.7)")
    shard_addrs = ([a for a in args.connect.split(",") if a]
                   if args.connect else None)
    transport = ("socket" if (shard_addrs or
                              args.transport == "socket") else "local")
    device = resolve_device(args.device)
    backend = "cuda" if device.type == "cuda" else "streaming"

    rng = np.random.default_rng(args.seed)
    g, truth = sbm(args.n, args.k, args.edges, p_in=0.85, seed=args.seed)
    Y = make_labels(args.n, args.k, args.label_frac, rng, true_labels=truth)

    store = GraphStore(g, Y, args.k)
    engine = ServingEngine(store, num_shards=args.shards,
                           rebuild_churn=args.rebuild_churn,
                           data_dir=args.data_dir, backend=backend,
                           index=args.index, nprobe=args.nprobe,
                           index_churn=args.index_churn,
                           transport=transport,
                           shard_addrs=shard_addrs,
                           replicas=args.replicas,
                           fsync=args.fsync,
                           group_commit_ms=args.group_commit_ms,
                           group_commit_bytes=args.group_commit_bytes,
                           device=device)
    batcher = MicroBatcher(engine, topk=args.topk)
    if not args.sync_flush:
        engine.start(batcher)
    print(f"[serve-gee] n={args.n} K={args.k} edges={args.edges:,} "
          f"labeled={int((Y >= 0).sum())} shards={args.shards} "
          f"durable={bool(args.data_dir)} transport={transport} "
          f"device={device} backend={backend}")

    inserted: list[tuple] = []     # batches eligible for later deletion
    for step in range(args.steps):
        tickets = []
        for _ in range(args.reads_per_step):
            kind = rng.choice(["embed", "predict", "topk"])
            nodes = rng.integers(0, args.n, size=args.read_nodes)
            tickets.append(batcher.submit(str(kind), nodes))
        b = args.write_batch
        u = rng.integers(0, args.n, size=b).astype(np.int32)
        v = rng.integers(0, args.n, size=b).astype(np.int32)
        w = rng.random(b).astype(np.float32) + 0.5
        tickets.append(batcher.submit("insert", (u, v, w)))
        inserted.append((u, v, w))
        if len(inserted) > 3 and rng.random() < 0.4:
            tickets.append(batcher.submit(
                "delete", inserted.pop(rng.integers(0, len(inserted)))))
        if rng.random() < 0.3:
            nodes = rng.integers(0, args.n, size=args.n // 100 + 1)
            tickets.append(batcher.submit("labels", (nodes, truth[nodes])))
        if args.sync_flush:
            batcher.flush()
        else:                          # async loop drains; join the tick
            for t in tickets:
                t.result(timeout=60)
        if args.compact_every and (step + 1) % args.compact_every == 0:
            info = (engine.checkpoint() if args.data_dir
                    else engine.compact())
            print(f"[serve-gee] step {step + 1}: compacted "
                  f"{info['edges_before']:,} -> {info['edges_after']:,} "
                  f"edges, epoch={engine.epoch}")
    if not args.sync_flush:
        engine.stop()
    if engine.loop_error is not None:
        raise RuntimeError(f"flush loop failed: {engine.loop_error!r}")

    print(f"[serve-gee] final version={engine.version} "
          f"epoch={engine.epoch} rebuilds={engine.rebuilds} "
          f"churn={engine.churn:.3f}")
    for kind, row in batcher.stats().items():
        print(f"[serve-gee] {kind:8s} req={row['requests']:5d} "
              f"batches={row['batches']:4d} "
              f"mean_batch={row['mean_batch']:7.1f} "
              f"lat={row['mean_latency_ms']:8.2f} ms "
              f"thru={row['items_per_s']:10.0f} items/s")
    err = _self_check(engine)
    print(f"[serve-gee] self-check max|Z_delta - Z_rebuild| = {err:.2e}")
    if not err < 1e-3:
        raise AssertionError("delta-maintained Z diverged from rebuild")
    if args.obs_dump:
        print(f"[serve-gee] health: {engine.health()}")
        print(obs.render_prometheus(), end="")

    if args.data_dir:
        qnodes = rng.integers(0, args.n, size=64).astype(np.int32)
        pre = engine.query_topk(qnodes, k=args.topk)
        triple = (engine.version, engine.epoch, engine.fingerprint())
        Z_live = engine.Z.clone()
        engine.close()
        recovered = ServingEngine.open(args.data_dir, backend=backend,
                                       device=device)
        rtriple = (recovered.version, recovered.epoch,
                   recovered.fingerprint())
        dz = float((recovered.Z - Z_live).abs().max())
        print(f"[serve-gee] recovery: {rtriple} vs live {triple}, "
              f"max|dZ|={dz:.2e}")
        if rtriple != triple:
            raise AssertionError("recovered state diverged")
        if not dz < 1e-3:
            raise AssertionError("recovered Z diverged")
        # indices exact; values to the same tolerance as dZ (the
        # recovered Z is rebuilt, the live one delta-maintained)
        post = recovered.query_topk(qnodes, k=args.topk)
        if not (np.array_equal(pre[0], post[0])
                and np.allclose(pre[1], post[1], atol=1e-4)):
            raise AssertionError("recovered deployment's top-k diverged "
                                 "from pre-crash")
        print("[serve-gee] recovery: reconnected top-k identical ✓")
        recovered.close()
    else:
        engine.close()
    return err


if __name__ == "__main__":
    main()
