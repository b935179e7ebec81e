"""Client proxies: `RemoteShard` / `RemoteReplica`.

The port of `repro.transport.remote`.  `RemoteShard` is
**call-compatible with the port's `EmbeddingShard`**: the same methods,
argument shapes and return conventions (tensors on `device` where the
shard returns tensors, numpy where it returns numpy, global node ids
in).  `ServingEngine(transport="socket")` drops it into
`engine.shards`, and every code path — delta fan-out, scatter/gather
reads, IVF probes, stats, the one-shard `engine.embedder` surface —
routes over RPC with no change to the routing logic.  Answers are
bit-equal to in-process shards: the codec is lossless for the arrays
involved, and the worker runs the same shard code.  `device` is the
router's: answers land there, where the engine merges them.

Retry policy rides on `RpcClient`: pure reads declare
``idempotent=True`` (bounded retry + jitter on a fresh connection);
mutations never retry — a timed-out `apply_delta` MAY have landed, so
the error must surface to the engine rather than risk folding an edge
batch twice.  Builds get a stretched timeout.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.edges import Graph
from repro_torch.transport.rpc import RpcClient

#: multiplier on the base timeout for slow calls (a build, an index
#: build)
_SLOW = 10.0


def _client(addr_or_client, timeout_s: float) -> RpcClient:
    if isinstance(addr_or_client, RpcClient):
        return addr_or_client
    return RpcClient(addr_or_client, timeout_s=timeout_s)


def _wire(x, dtype=None) -> np.ndarray:
    """A tensor or array-like as a numpy array for the codec."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


class _RemoteEmbedderView:
    """The one-shard surface (`engine.embedder`): just the fitted state,
    fetched on demand."""

    def __init__(self, shard: "RemoteShard"):
        self._shard = shard

    @property
    def Z_(self) -> Optional[torch.Tensor]:
        return self._shard._tensor(
            self._shard._call("embedder_Z", idempotent=True))

    @property
    def Wv_(self) -> Optional[torch.Tensor]:
        return self._shard._tensor(
            self._shard._call("embedder_Wv", idempotent=True))


class _RemoteIndexView:
    """Mirror of the engine-facing `IVFIndex` read surface (`stats()`
    occupancy reporting)."""

    def __init__(self, shard: "RemoteShard"):
        self._shard = shard

    def cell_sizes(self) -> np.ndarray:
        return np.asarray(
            self._shard._call("index_cell_sizes", idempotent=True))


# repro: twin-of EmbeddingShard; extra: ping, close, address, client, proc, timeout_s, device
class RemoteShard:
    """`EmbeddingShard`, one process boundary away."""

    def __init__(self, addr_or_client, shard_id: int, lo: int, hi: int,
                 *, timeout_s: float = 60.0, proc=None,
                 device: Union[str, torch.device] = "cuda"):
        self.shard_id = int(shard_id)
        self.lo, self.hi = int(lo), int(hi)
        self.timeout_s = float(timeout_s)
        #: where answers land (the router's device)
        self.device = resolve_device(device)
        self.client = _client(addr_or_client, timeout_s)
        #: owning WorkerProc when the engine spawned this worker
        #: (None for --connect deployments managed externally)
        self.proc = proc

    def _call(self, method, *args, **kwargs):
        return self.client.call(method, *args, **kwargs)

    def _tensor(self, a) -> Optional[torch.Tensor]:
        """A wire array as a tensor on `device` (copied: the codec's
        arrays are read-only views of the frame)."""
        if a is None:
            return None
        return torch.from_numpy(np.array(a)).to(self.device)

    @property
    def address(self) -> str:
        return self.client.address

    def ping(self) -> dict:
        return self._call("ping", idempotent=True)

    # -- write path --------------------------------------------------------

    def build(self, graph_or_source, Y: np.ndarray) -> None:
        """Ship the routed sub-multiset (or a source's materialized
        graph) with its fingerprint, so the worker's plan cache keys on
        the same content.  Sources resolve router-side: their
        fingerprint is the cheap one (the store's chained value)."""
        if isinstance(graph_or_source, Graph):
            g, fp = graph_or_source, graph_or_source.fingerprint()
        else:                            # GraphSource duck type
            g, fp = graph_or_source.graph(), \
                graph_or_source.fingerprint()
        self._call("build", np.asarray(g.u), np.asarray(g.v),
                   np.asarray(g.w), int(g.n), fp,
                   np.asarray(Y, np.int32),
                   timeout_s=self.timeout_s * _SLOW)

    def apply_delta(self, sub: Graph) -> None:
        if sub.s:                        # NOT idempotent: never retried
            self._call("apply_delta", np.asarray(sub.u),
                       np.asarray(sub.v), np.asarray(sub.w),
                       int(sub.n))

    # -- read path ---------------------------------------------------------

    @property
    def Z_owned(self) -> torch.Tensor:
        return self._tensor(self._call("z_owned", idempotent=True))

    @property
    def accumulator_nbytes(self) -> int:
        return int(self._call("accumulator_nbytes", idempotent=True))

    def rows(self, nodes: np.ndarray) -> torch.Tensor:
        return self._tensor(self._call("rows", np.asarray(nodes),
                                       idempotent=True))

    def normalized(self) -> torch.Tensor:
        return self._tensor(self._call("normalized", idempotent=True))

    def class_stats(self, Y: np.ndarray):
        sums, counts = self._call("class_stats", np.asarray(Y, np.int32),
                                  idempotent=True)
        return self._tensor(sums), self._tensor(counts)

    def topk_candidates(self, q, qnodes, *, k: int,
                        block_rows: int = 1 << 14):
        ids, vals = self._call("topk_candidates", _wire(q, np.float32),
                               np.asarray(qnodes, np.int32), int(k),
                               int(block_rows), idempotent=True)
        return np.asarray(ids), np.asarray(vals)

    # -- IVF index ---------------------------------------------------------

    @property
    def index(self) -> Optional[_RemoteIndexView]:
        if self._call("has_index", idempotent=True):
            return _RemoteIndexView(self)
        return None

    def build_index(self, centroids) -> None:
        self._call("build_index", _wire(centroids, np.float32),
                   timeout_s=self.timeout_s * _SLOW)

    def update_index(self, touched_global: np.ndarray) -> int:
        return int(self._call("update_index",
                              np.asarray(touched_global, np.int64)))

    def index_topk(self, q, qnodes, probe, *, k: int,
                   block_rows: int = 1 << 14):
        ids, vals, scanned = self._call(
            "index_topk", _wire(q, np.float32),
            np.asarray(qnodes, np.int32), np.asarray(probe, np.int32),
            int(k), int(block_rows), idempotent=True)
        return np.asarray(ids), np.asarray(vals), int(scanned)

    # -- introspection / one-shard surface ---------------------------------

    @property
    def plan_stats(self) -> dict:
        return self._call("plan_stats", idempotent=True)

    @property
    def embedder(self) -> _RemoteEmbedderView:
        return _RemoteEmbedderView(self)

    def close(self, *, shutdown: bool = False) -> None:
        if shutdown:
            self.client.shutdown_server()
        self.client.close()
        if self.proc is not None:
            self.proc.stop()
            self.proc = None


# repro: twin-of ReplicaEngine; extra: ping, address, client, proc, timeout_s
class RemoteReplica:
    """Client for a WAL-tail replica worker.  Every method is a
    version-pinned read — all idempotent, all retried on transport
    faults; `ReplicaLagError` crosses the wire typed, so the router's
    owner fallback sees the same exception it would in-process.
    Answers are numpy, as the engine's reads return."""

    def __init__(self, addr_or_client, *, timeout_s: float = 30.0,
                 proc=None):
        self.timeout_s = float(timeout_s)
        self.client = _client(addr_or_client, timeout_s)
        self.proc = proc

    @property
    def address(self) -> str:
        return self.client.address

    def ping(self) -> dict:
        return self.client.call("ping", idempotent=True)

    def status(self, *, timeout_s: Optional[float] = None) -> dict:
        return self.client.call("status", idempotent=True,
                                timeout_s=timeout_s)

    def embed(self, nodes, *, min_version: int = 0) -> np.ndarray:
        return np.asarray(self.client.call(
            "embed", np.asarray(nodes), int(min_version),
            idempotent=True))

    def predict(self, nodes, *, min_version: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
        pred, score = self.client.call(
            "predict", np.asarray(nodes), int(min_version),
            idempotent=True)
        return np.asarray(pred), np.asarray(score)

    def topk(self, nodes, *, k: int = 10, block_rows: int = 1 << 14,
             mode: str = "exact", nprobe: Optional[int] = None,
             min_version: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        idx, val = self.client.call(
            "topk", np.asarray(nodes), int(k), int(block_rows),
            str(mode), (int(nprobe) if nprobe is not None else None),
            int(min_version), idempotent=True)
        return np.asarray(idx), np.asarray(val)

    def close(self, *, shutdown: bool = False) -> None:
        if shutdown:
            self.client.shutdown_server()
        self.client.close()
        if self.proc is not None:
            self.proc.stop()
            self.proc = None
