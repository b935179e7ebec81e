"""CLI: live observability snapshot / JSONL trace replay (the port of
`python -m repro.obs`).

    python -m repro_torch.obs --snapshot            # demo run -> registry
    python -m repro_torch.obs --snapshot --prometheus
    python -m repro_torch.obs --snapshot --json
    python -m repro_torch.obs --snapshot --trace-out /tmp/spans.jsonl
    python -m repro_torch.obs --trace /tmp/spans.jsonl   # span tree

``--snapshot`` stands up a small but complete deployment: SBM graph ->
`GraphStore` -> durable `ServingEngine` with the IVF index on (WAL and
snapshots in a temporary directory) -> `MicroBatcher` reads (exact and
ivf top-k) and writes -> checkpoint -> recovery, and a plan-cache miss
and hit of an `Embedder` in a temporary cache, with observability
forced on; then it prints the registry (a table by default,
``--prometheus`` for the text exposition format, ``--json`` for the raw
dict).  The output is a live catalog of the series the layer emits:
encoder and plan cache, shard, WAL, batcher, engine and index.  It runs
on the card ("cuda", backend "cuda": the GEE kernels) unless
``--device cpu`` asks for the CPU (backend "streaming").

``--trace FILE`` reads a span JSONL file (written through
``REPRO_OBS_TRACE=FILE`` or ``--trace-out``) and prints the
parent-linked span tree with durations.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

from repro_torch import obs


def _demo(n: int, edges: int, shards: int, steps: int, device) -> None:
    """A miniature end-to-end serving run (every instrumented path)."""
    import numpy as np

    from repro_torch.encoder import Embedder, EncoderConfig
    from repro_torch.graph.edges import make_labels
    from repro_torch.graph.generators import sbm
    from repro_torch.serving.batcher import MicroBatcher
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.store import GraphStore

    rng = np.random.default_rng(0)
    K = 4
    backend = "cuda" if device.type == "cuda" else "streaming"
    g, truth = sbm(n, K, edges, p_in=0.85, seed=0)
    Y = make_labels(n, K, 0.2, rng, true_labels=truth)
    d = tempfile.mkdtemp(prefix="repro-torch-obs-demo-")
    try:
        with obs.span("obs.demo", n=n, edges=edges, shards=shards):
            eng = ServingEngine(GraphStore(g, Y, K), num_shards=shards,
                                data_dir=f"{d}/dep", plan_cache=None,
                                index="ivf", backend=backend,
                                device=device)
            batcher = MicroBatcher(eng, topk=5)
            ivf = MicroBatcher(eng, topk=5, topk_mode="ivf")
            for _ in range(steps):
                for kind in ("embed", "predict", "topk"):
                    batcher.submit(
                        kind, rng.integers(0, n, 16).astype(np.int32))
                ivf.submit("topk", rng.integers(0, n, 16).astype(np.int32))
                b = 64
                batcher.submit("insert",
                               (rng.integers(0, n, b).astype(np.int32),
                                rng.integers(0, n, b).astype(np.int32),
                                rng.random(b).astype(np.float32) + 0.5))
                batcher.flush()
                ivf.flush()
            batcher.submit(
                "labels",
                (np.arange(n, dtype=np.int64), truth.astype(np.int32)))
            batcher.flush()
            eng.checkpoint()
            eng.close()
            rec = ServingEngine.open(f"{d}/dep", plan_cache=None,
                                     backend=backend, device=device)
            rec.query_topk(np.arange(8, dtype=np.int32), k=5, mode="ivf")
            rec.close()
            for _ in range(2):           # a plan-cache miss, then a hit
                Embedder(EncoderConfig(K=K), backend=backend, device=device,
                         plan_cache=f"{d}/plans").fit(g, Y).transform()
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs",
        description="Observability snapshot / trace replay.")
    ap.add_argument("--snapshot", action="store_true",
                    help="run the instrumented demo deployment and "
                         "print the registry snapshot (default when "
                         "no --trace is given)")
    ap.add_argument("--prometheus", action="store_true",
                    help="print Prometheus text format instead of the "
                         "table")
    ap.add_argument("--json", action="store_true",
                    help="print the raw snapshot dict as JSON")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="replay a span JSONL file as a parent-linked "
                         "tree (skips the demo)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the demo run's spans to FILE as JSONL")
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--edges", type=int, default=4000)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu")
    args = ap.parse_args(argv)

    if args.trace is not None:
        events = obs.load_jsonl(args.trace)
        if not events:
            print(f"no parseable span events in {args.trace}",
                  file=sys.stderr)
            return 1
        print(obs.render_tree(events))
        return 0

    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    if not obs.enabled():
        print("# REPRO_OBS=off in the environment; enabling for this "
              "demo run", file=sys.stderr)
    obs.configure(enabled=True)
    obs.reset()
    if args.trace_out:
        obs.configure(trace_path=args.trace_out)
    _demo(args.n, args.edges, args.shards, args.steps, device)
    if args.trace_out:
        obs.configure(trace_path="")     # flush and close the sink
        print(f"# spans written to {args.trace_out}", file=sys.stderr)

    snap = obs.snapshot()
    if args.prometheus:
        sys.stdout.write(obs.render_prometheus())
    elif args.json:
        print(json.dumps(snap, indent=2, sort_keys=True))
    else:
        print(obs.summarize(snap))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
