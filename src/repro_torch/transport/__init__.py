"""Multi-process transport for the serving deployment (the port of
`repro.transport`).

The serving engine's shard router treats each `EmbeddingShard` as an
opaque worker behind a narrow call surface; this package moves that
surface across a process boundary without changing it:

* `framing`   — length-prefixed CRC frames (the WAL's discipline on a
                socket) + a no-pickle tagged codec with zero-copy numpy
                arrays, byte for byte the reference's;
* `rpc`       — `RpcServer`/`RpcClient`: per-call timeouts, bounded
                jittered retry for idempotent reads, connection
                re-establishment, typed errors across the wire;
* `worker`    — the subprocess entry (`python -m
                repro_torch.transport.worker`) hosting one shard or one
                WAL-tail replica on ``--device``;
* `remote`    — `RemoteShard` (call-compatible with `EmbeddingShard`)
                and `RemoteReplica` proxies;
* `replica`   — `ReplicaEngine`: bootstrap from the owner's snapshot
                generation, stay fresh by tailing its WAL, serve
                version-pinned reads;
* `procs`     — spawn/handshake/teardown with the router's config and
                device pinned into the worker.

Tensors cross as numpy and land on the router's device.  Entry point:
``ServingEngine(..., transport="socket")`` (spawn workers) or
``transport="socket", shard_addrs=[...]`` (connect to externally
launched ones), plus ``replicas=N`` / ``replica_addrs=[...]`` on any
durable deployment.
"""
from repro_torch.transport.errors import (CallTimeout, FrameError,
                                          RemoteCallError, ReplicaLagError,
                                          TransportError)
from repro_torch.transport.framing import (MAX_FRAME, pack_obj, recv_frame,
                                           recv_msg, send_frame, send_msg,
                                           unpack_obj)
from repro_torch.transport.procs import (WorkerProc, spawn_replica_worker,
                                         spawn_shard_worker, worker_env)
from repro_torch.transport.remote import RemoteReplica, RemoteShard
from repro_torch.transport.replica import ReplicaEngine
from repro_torch.transport.rpc import (RpcClient, RpcServer, format_addr,
                                       parse_addr)

__all__ = [
    "CallTimeout", "FrameError", "RemoteCallError", "ReplicaLagError",
    "TransportError", "MAX_FRAME", "pack_obj", "unpack_obj",
    "send_frame", "recv_frame", "send_msg", "recv_msg", "WorkerProc",
    "spawn_shard_worker", "spawn_replica_worker", "worker_env",
    "RemoteShard", "RemoteReplica", "ReplicaEngine", "RpcClient",
    "RpcServer", "parse_addr", "format_addr",
]
