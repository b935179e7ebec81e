"""Socket RPC: one request/response frame pair per call.

The port of `repro.transport.rpc`, with the same messages, metric names
(``repro_transport_*``) and policies; a port client talks to a reference
server and the other way round.  One addition: `RpcServer` takes a
`thread_init` callable that every connection thread runs first (a
worker on a card pins the thread's CUDA device with it, since a new
thread starts on device 0).

`RpcServer` hosts a **handler** object (a `worker.ShardHost` or
`worker.ReplicaHost`) on a localhost TCP socket or a UNIX-domain
socket.  Requests dispatch by method name to the handler's public
methods — there is no pickle and no eval; an unknown or underscored
method is an error response, never an attribute walk.

    request  = {"id": int, "method": str, "args": [...], "kwargs": {...}}
    response = {"id": int, "ok": True,  "value": ...}
             | {"id": int, "ok": False, "etype": str, "error": str}

`RpcClient` adds the robustness the router needs:

* **per-call timeouts** — a socket deadline per request/response pair;
* **bounded retry with jitter, idempotent calls only** — reads may
  execute twice (a timed-out request can still land server-side), so
  only calls declared ``idempotent=True`` are retried, always on a
  FRESH connection (the old stream may hold a stale response that
  would otherwise be mis-paired with the retry);
* **connection re-establishment** — connects lazily, drops the socket
  on any framing/IO error, and reconnects on the next call.

One connection per client, one in-flight call per connection: the
engine already serializes calls per shard under its own lock, so the
simple protocol (strict request/response alternation, ids as a sanity
check) is exactly enough.
"""
from __future__ import annotations

import os
import random
import socket
import threading
import time
from typing import Any, Callable, Optional, Tuple, Union

from repro_torch import obs
from repro_torch.transport.errors import (CallTimeout, FrameError,
                                          TransportError, from_wire_error,
                                          to_wire_error)
from repro_torch.transport.framing import recv_msg, send_msg

Addr = Union[Tuple[str, int], str]       # (host, port) | unix socket path


def parse_addr(addr: str) -> Addr:
    """"host:port" -> (host, port); "unix:/path" -> "/path"."""
    if addr.startswith("unix:"):
        return addr[len("unix:"):]
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"address {addr!r} is not HOST:PORT or unix:PATH")
    return host, int(port)


def format_addr(addr: Addr) -> str:
    if isinstance(addr, str):
        return f"unix:{addr}"
    return f"{addr[0]}:{addr[1]}"


def _connect(addr: Addr, timeout: Optional[float]) -> socket.socket:
    if isinstance(addr, str):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(addr)
    else:
        sock = socket.create_connection(addr, timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


class RpcServer:
    """Hosts one handler object; threaded accept loop, one thread per
    connection, dispatch serialized by a handler lock (reconnects can
    briefly overlap connections; the handler itself stays
    single-threaded)."""

    def __init__(self, handler, *, host: str = "127.0.0.1", port: int = 0,
                 path: Optional[str] = None,
                 thread_init: Optional[Callable[[], None]] = None):
        self.handler = handler
        self.thread_init = thread_init
        self._lock = threading.Lock()
        self._stop = threading.Event()
        #: bookkeeping lock for the thread list — deliberately NOT
        #: _lock, which is held across handler dispatch: accepting a
        #: new connection must not wait out a slow RPC
        self._tlock = threading.Lock()
        self._threads: list[threading.Thread] = []  # guarded by: _tlock
        if path is not None:
            if os.path.exists(path):
                os.unlink(path)
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(path)
            self.addr: Addr = path
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self.addr = self._sock.getsockname()[:2]
        self._sock.listen(16)

    @property
    def address(self) -> str:
        return format_addr(self.addr)

    def start(self) -> "RpcServer":
        t = threading.Thread(target=self.serve_forever,
                             name="rpc-accept", daemon=True)
        t.start()
        with self._tlock:
            self._threads.append(t)
        return self

    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:              # listener closed: shutdown
                break
            conn.settimeout(None)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="rpc-conn", daemon=True)
            t.start()
            with self._tlock:
                self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        """Request loop for one connection.  A torn frame, a mid-message
        disconnect, or garbage bytes end THIS connection only — the
        server keeps accepting (clean failure routing: a flaky client
        cannot take the worker down)."""
        if self.thread_init is not None:
            self.thread_init()
        try:
            while not self._stop.is_set():
                try:
                    req = recv_msg(conn)
                except (FrameError, OSError):
                    return               # torn/closed stream: drop conn
                resp = self._dispatch(req)
                try:
                    send_msg(conn, resp)
                except OSError:
                    return               # peer vanished mid-response
                if req.get("method") == "__shutdown__":
                    self.close()
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, req: Any) -> dict:
        rid = req.get("id", -1) if isinstance(req, dict) else -1
        try:
            if not isinstance(req, dict):
                raise TypeError("request is not a message dict")
            method = req["method"]
            if method == "__shutdown__":
                return {"id": rid, "ok": True, "value": None}
            if method.startswith("_") or not hasattr(self.handler, method):
                raise AttributeError(f"no such RPC method {method!r}")
            fn = getattr(self.handler, method)
            t0 = obs.tick()
            with self._lock:
                value = fn(*req.get("args", ()), **req.get("kwargs", {}))
            if obs.enabled():
                obs.observe("repro_transport_server_seconds",
                            obs.tock(t0), method=method)
                obs.counter("repro_transport_server_requests_total",
                            method=method)
            return {"id": rid, "ok": True, "value": value}
        except BaseException as e:       # noqa: BLE001 — errors cross the
            etype, msg = to_wire_error(e)   # wire, they don't kill the loop
            if obs.enabled():
                obs.counter("repro_transport_server_errors_total",
                            etype=etype)
            return {"id": rid, "ok": False, "etype": etype, "error": msg}

    def close(self) -> None:
        self._stop.set()
        try:
            # a plain close() does NOT wake a thread blocked in
            # accept() on Linux — shutdown() does (EINVAL there)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if isinstance(self.addr, str):
            try:
                os.unlink(self.addr)
            except OSError:
                pass


class RpcClient:
    """One lazy connection to an RpcServer; see the module docstring
    for the retry/reconnect policy.

    Thread-safe: a lock serializes each round trip, so concurrent
    callers (e.g. engine reads racing the health prober on one
    RemoteReplica) can never interleave frames on the shared stream.
    The backoff sleep between retry attempts happens OUTSIDE the lock,
    so a retrying caller does not stall the others."""

    def __init__(self, addr: Union[str, Addr], *, timeout_s: float = 10.0,
                 retries: int = 2, backoff_s: float = 0.05,
                 rng: Optional[random.Random] = None):
        self.addr: Addr = parse_addr(addr) if isinstance(addr, str) else addr
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self._rng = rng or random.Random(0xC0FFEE)
        #: serializes the (send, recv) round trip + connection state
        self._lock = threading.Lock()
        # guarded by: _lock
        self._sock: Optional[socket.socket] = None
        self._next_id = 0                # guarded by: _lock
        self.reconnects = 0              # guarded by: _lock

    @property
    def address(self) -> str:
        return format_addr(self.addr)

    # holds: _lock
    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # holds: _lock
    def _ensure(self, timeout: float) -> socket.socket:
        if self._sock is None:
            self._sock = _connect(self.addr, timeout)
            self.reconnects += 1
            if obs.enabled():
                obs.counter("repro_transport_reconnects_total")
        self._sock.settimeout(timeout)
        return self._sock

    def call(self, method: str, *args, idempotent: bool = False,
             timeout_s: Optional[float] = None, **kwargs) -> Any:
        """One RPC round trip.  `idempotent=True` opts into bounded
        retry (fresh connection + jittered backoff) on transport-level
        failures; remote exceptions are never retried — they are
        deterministic answers, not faults."""
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        attempts = 1 + (self.retries if idempotent else 0)
        last: Optional[TransportError] = None
        t0 = obs.tick()
        for attempt in range(attempts):
            if attempt and obs.enabled():
                obs.counter("repro_transport_client_retries_total",
                            method=method)
            try:
                with self._lock:
                    value = self._call_once(method, args, kwargs,
                                            timeout)
                if obs.enabled():
                    obs.observe("repro_transport_client_seconds",
                                obs.tock(t0), method=method)
                    obs.counter("repro_transport_client_calls_total",
                                method=method, outcome="ok")
                return value
            except TransportError as e:
                last = e
                with self._lock:
                    self._drop()         # never reuse a torn stream
                if attempt + 1 < attempts:
                    time.sleep(self.backoff_s * (2 ** attempt)
                               * (1.0 + self._rng.random()))
        if obs.enabled():
            obs.counter("repro_transport_client_calls_total",
                        method=method, outcome="error")
        raise last if last is not None else TransportError("no attempt ran")

    # holds: _lock — call() serializes each round trip
    def _call_once(self, method: str, args, kwargs, timeout: float) -> Any:
        rid = self._next_id
        self._next_id += 1
        try:
            sock = self._ensure(timeout)
            sent = send_msg(sock, {"id": rid, "method": method,
                                   "args": list(args), "kwargs": kwargs})
            resp = recv_msg(sock)
            if obs.enabled():
                obs.counter("repro_transport_bytes_sent_total", sent)
        except socket.timeout as e:
            raise CallTimeout(
                f"{method} to {self.address} exceeded {timeout:.3f}s"
            ) from e
        except FrameError:
            raise
        except OSError as e:
            raise TransportError(
                f"{method} to {self.address} failed: {e}") from e
        if not isinstance(resp, dict) or resp.get("id") != rid:
            raise FrameError(f"response id mismatch for {method} "
                             f"(got {resp.get('id') if isinstance(resp, dict) else resp!r})")
        if resp.get("ok"):
            return resp.get("value")
        raise from_wire_error(resp.get("etype", "RemoteCallError"),
                              resp.get("error", "unknown remote error"))

    def shutdown_server(self) -> None:
        """Ask the server to exit its accept loop (best effort)."""
        try:
            self.call("__shutdown__")
        except (TransportError, OSError):
            pass

    def close(self) -> None:
        with self._lock:
            self._drop()
