"""Worker process entry: host one shard (or one replica) over RPC.

The port of `repro.transport.worker`.  ``python -m
repro_torch.transport.worker`` is the multi-process deployment's unit of
execution.  Two roles:

* ``--role shard`` hosts one real `EmbeddingShard` (owned rows [lo, hi))
  behind a `ShardHost` handler whose wire methods mirror the shard
  surface 1:1, so the router's `RemoteShard` calls them with the
  arguments `ServingEngine` already produces;
* ``--role replica`` hosts a `ReplicaEngine` (transport.replica): a full
  read-only engine bootstrapped from the owner's snapshot and kept fresh
  by tailing its WAL, serving version-pinned reads.

Both live on ``--device`` ("cuda" by default, the router's pinned card
when it spawns the worker; a worker without a card exits before its
handshake).  Arrays cross the wire as numpy: a host moves what it
receives onto its device and returns ``.cpu().numpy()``.  ``ping``
reports the device, the process's kernel launch counts
(`kernels._build.launches`) and its device memory, so a router can
confirm that its workers ran on the card and launched the kernels.

Startup handshake: after binding, the worker writes one line,
``LISTENING <addr>``, to stdout and then serves until a
``__shutdown__`` RPC (or SIGTERM).  Everything else the process writes
to stdout goes to stderr (file descriptor 1 is pointed at 2 first):
after the handshake nobody reads the stdout pipe, and a full pipe would
block the worker.  Heavy imports (torch, the engine) stay inside
:func:`main` and the host constructors, after the environment is final.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.transport.rpc import RpcServer, parse_addr


def _np(x, dtype=None, *, copy: bool = False):
    """Wire array -> numpy.  The codec's zero-copy decode yields
    read-only views; write-path inputs (anything the embedder folds)
    are copied so downstream in-place ops can never trip on them."""
    a = np.asarray(x) if dtype is None else np.asarray(x, dtype)
    return np.array(a) if copy else a


def _host(t):
    """A tensor (or None) as a numpy array for the wire."""
    return None if t is None else t.detach().cpu().numpy()


def _launches() -> dict:
    from repro_torch.kernels import _build
    return dict(_build.launches)


def _device_memory(device) -> Optional[dict]:
    """This process's peak allocated and reserved bytes on its card (None
    on the CPU)."""
    if device.type != "cuda":
        return None
    import torch
    return {"max_allocated": int(torch.cuda.max_memory_allocated(device)),
            "reserved": int(torch.cuda.memory_reserved(device))}


class ShardHost:
    """Wire-facing wrapper around one `EmbeddingShard` on `device`."""

    role = "shard"

    def __init__(self, shard_id: int, lo: int, hi: int, *, K: int,
                 n: int, chunk_size: int = 1 << 20,
                 backend: str = "streaming", plan_cache="auto",
                 device="cuda"):
        from repro_torch.serving.shard import EmbeddingShard
        self.backend = backend
        self.shard = EmbeddingShard(shard_id, lo, hi, K=K, n=n,
                                    chunk_size=chunk_size,
                                    backend=backend,
                                    plan_cache=plan_cache, device=device)

    def _tensor(self, x, dtype):
        import torch
        return torch.as_tensor(_np(x, dtype, copy=True),
                               device=self.shard.device)

    def ping(self) -> dict:
        return {"role": self.role, "pid": os.getpid(),
                "shard_id": self.shard.shard_id,
                "lo": self.shard.lo, "hi": self.shard.hi,
                "backend": self.backend, "device": str(self.shard.device),
                "launches": _launches(),
                "device_memory": _device_memory(self.shard.device),
                "obs": obs.enabled()}

    # -- write path --------------------------------------------------------

    def build(self, u, v, w, n, fp: Optional[str], Y) -> int:
        """Fit on a routed sub-multiset.  `fp` is the router's chained
        sub-multiset fingerprint, stamped onto the Graph so the worker's
        plan cache keys on the content identity the in-process shard
        would use.  Returns once the device has finished the build (the
        router's rebuild span covers it, and a device fault answers this
        call)."""
        from repro_torch.graph.edges import Graph
        g = Graph(_np(u, np.int32, copy=True), _np(v, np.int32, copy=True),
                  _np(w, np.float32, copy=True), int(n))
        if fp is not None:
            g._fp = fp
        self.shard.build(g, _np(Y, np.int32, copy=True))
        if self.shard.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.shard.device)
        return self.shard.accumulator_nbytes

    def apply_delta(self, u, v, w, n) -> None:
        from repro_torch.graph.edges import Graph
        self.shard.apply_delta(
            Graph(_np(u, np.int32, copy=True), _np(v, np.int32, copy=True),
                  _np(w, np.float32, copy=True), int(n)))

    # -- read path ---------------------------------------------------------

    def z_owned(self):
        return _host(self.shard.Z_owned)

    def accumulator_nbytes(self) -> int:
        return int(self.shard.accumulator_nbytes)

    def rows(self, nodes):
        return _host(self.shard.rows(_np(nodes, np.int64)))

    def normalized(self):
        return _host(self.shard.normalized())

    def class_stats(self, Y):
        sums, counts = self.shard.class_stats(_np(Y, np.int32, copy=True))
        return [_host(sums), _host(counts)]

    def topk_candidates(self, q, qnodes, k, block_rows):
        ids, vals = self.shard.topk_candidates(
            self._tensor(q, np.float32), _np(qnodes, np.int32, copy=True),
            k=int(k), block_rows=int(block_rows))
        return [np.asarray(ids), np.asarray(vals)]

    # -- IVF index ---------------------------------------------------------

    def has_index(self) -> bool:
        return self.shard.index is not None

    def index_cell_sizes(self):
        return np.asarray(self.shard.index.cell_sizes())

    def build_index(self, centroids) -> None:
        self.shard.build_index(_np(centroids, np.float32, copy=True))

    def update_index(self, touched_global) -> int:
        return int(self.shard.update_index(
            _np(touched_global, np.int64, copy=True)))

    def index_topk(self, q, qnodes, probe, k, block_rows):
        ids, vals, scanned = self.shard.index_topk(
            self._tensor(q, np.float32), _np(qnodes, np.int32, copy=True),
            _np(probe, np.int32, copy=True), k=int(k),
            block_rows=int(block_rows))
        return [np.asarray(ids), np.asarray(vals), int(scanned)]

    # -- introspection / one-shard surface ---------------------------------

    def plan_stats(self) -> dict:
        return dict(self.shard.plan_stats)

    def embedder_Z(self):
        return _host(self.shard.embedder.Z_)

    def embedder_Wv(self):
        return _host(self.shard.embedder.Wv_)


class ReplicaHost:
    """Wire-facing wrapper around one `ReplicaEngine`."""

    role = "replica"

    def __init__(self, data_dir: str, *, poll_s: float = 0.02,
                 chunk_size: int = 1 << 20, backend: str = "streaming",
                 plan_cache="auto", device="cuda"):
        from repro_torch.transport.replica import ReplicaEngine
        self.backend = backend
        self.rep = ReplicaEngine(data_dir, poll_s=poll_s,
                                 chunk_size=chunk_size, backend=backend,
                                 plan_cache=plan_cache, device=device)

    def ping(self) -> dict:
        out = {"role": self.role, "pid": os.getpid(),
               "backend": self.backend, "device": str(self.rep.device),
               "launches": _launches(),
               "device_memory": _device_memory(self.rep.device),
               "obs": obs.enabled()}
        out.update(self.rep.status())
        return out

    def status(self) -> dict:
        return self.rep.status()

    def embed(self, nodes, min_version):
        return self.rep.embed(_np(nodes, np.int64),
                              min_version=int(min_version))

    def predict(self, nodes, min_version):
        pred, score = self.rep.predict(_np(nodes, np.int64),
                                       min_version=int(min_version))
        return [pred, score]

    def topk(self, nodes, k, block_rows, mode, nprobe, min_version):
        idx, val = self.rep.topk(
            _np(nodes, np.int64), k=int(k), block_rows=int(block_rows),
            mode=str(mode),
            nprobe=(int(nprobe) if nprobe is not None else None),
            min_version=int(min_version))
        return [idx, val]


def _parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="repro_torch.transport.worker",
        description="host one EmbeddingShard or WAL-tail replica "
                    "over RPC")
    ap.add_argument("--role", choices=["shard", "replica"],
                    required=True)
    ap.add_argument("--addr", default="127.0.0.1:0",
                    help="HOST:PORT (port 0 = ephemeral; the real "
                         "address is printed as 'LISTENING <addr>') "
                         "or unix:PATH")
    ap.add_argument("--backend",
                    default=os.environ.get("REPRO_TRANSPORT_BACKEND",
                                           "streaming"))
    ap.add_argument("--plan-cache", default="auto",
                    help="'auto', 'off', or a cache dir")
    ap.add_argument("--chunk-size", type=int, default=1 << 20)
    ap.add_argument("--obs", choices=["on", "off"], default=None,
                    help="override the inherited REPRO_OBS state")
    ap.add_argument("--device", default="cuda",
                    help="cuda[:i] (default: the kernels) or cpu")
    # shard role
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--lo", type=int, default=None)
    ap.add_argument("--hi", type=int, default=None)
    ap.add_argument("--classes", type=int, default=None,
                    help="K, the embedding width")
    ap.add_argument("--nodes", type=int, default=None,
                    help="n, the global row count")
    # replica role
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--poll-ms", type=float, default=20.0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Serve until a ``__shutdown__`` RPC, then end the process (it does
    not return)."""
    args = _parse(argv)
    # the handshake line keeps the real stdout; everything else written
    # to file descriptor 1 from here on lands on stderr
    handshake_fd = os.dup(1)
    os.dup2(2, 1)
    import torch

    from repro_torch.device import resolve_device
    if args.obs is not None:             # explicit flag wins over env
        obs.configure(enabled=(args.obs == "on"))
    plan_cache = (None if args.plan_cache in ("off", "none")
                  else args.plan_cache)
    device = resolve_device(args.device)     # no card: raise, never cpu
    thread_init = None
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)

        def thread_init():               # a new thread starts on card 0
            torch.cuda.set_device(device)
    if args.role == "shard":
        for name in ("lo", "hi", "classes", "nodes"):
            if getattr(args, name) is None:
                raise SystemExit(f"--role shard requires --{name}")
        handler = ShardHost(args.shard_id, args.lo, args.hi,
                            K=args.classes, n=args.nodes,
                            chunk_size=args.chunk_size,
                            backend=args.backend, plan_cache=plan_cache,
                            device=device)
    else:
        if args.data_dir is None:
            raise SystemExit("--role replica requires --data-dir")
        handler = ReplicaHost(args.data_dir,
                              poll_s=args.poll_ms / 1e3,
                              chunk_size=args.chunk_size,
                              backend=args.backend,
                              plan_cache=plan_cache, device=device)
    addr = parse_addr(args.addr)
    if isinstance(addr, str):
        server = RpcServer(handler, path=addr, thread_init=thread_init)
    else:
        server = RpcServer(handler, host=addr[0], port=addr[1],
                           thread_init=thread_init)
    # the spawner's handshake: exactly one line, then silence
    os.write(handshake_fd, f"LISTENING {server.address}\n".encode())
    os.close(handshake_fd)
    try:
        server.serve_forever()
    finally:
        if isinstance(handler, ReplicaHost):
            handler.rep.close()          # stop the tail before exit
    # leave without the interpreter's teardown, as a multiprocessing
    # child does: a connection thread can still be unwinding while the
    # teardown runs the CUDA libraries' static destructors, and on a
    # card that aborted the worker now and then (exit code -6).  A
    # worker holds nothing durable: the owner's WAL is the state.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    raise SystemExit(main())
