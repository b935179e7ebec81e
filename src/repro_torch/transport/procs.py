"""Worker subprocess lifecycle: spawn, handshake, pinned env, teardown.

The port of `repro.transport.procs`.  The router spawns each shard or
replica as ``python -m repro_torch.transport.worker`` with port 0 and
learns the real address from the worker's one-line stdout handshake
(``LISTENING <addr>``).

**Environment and device pinning** (the config-divergence guard): a
worker that inherited another ``REPRO_OBS`` / plan-cache / device
config than the router would silently produce other metrics, other
cache behaviour, or run on another device.  :func:`worker_env` stamps
the router's *effective* state into the child environment —
``REPRO_OBS`` from `obs.enabled()` (not the raw env: the router may have
called ``obs.configure``); ``REPRO_PLAN_CACHE``, ``CUDA_VISIBLE_DEVICES``
and ``REPRO_TRANSPORT_BACKEND`` passed through verbatim when set — and
prepends the live ``repro_torch`` package's source root to
``PYTHONPATH``.  The device itself rides on the command line
(``--device``, the router's pinned ``cuda:<i>`` or ``cpu``); a worker
asked for a card where there is none fails its handshake, it never
serves on the CPU.

**The two pipes.**  The worker's stdout carries the handshake line and
nothing else (the worker points its file descriptor 1 at stderr for
everything after), since nothing reads that pipe once the address is
known.  Its stderr goes through a second pipe that a daemon thread
drains onto this process's stderr, each line prefixed with the worker's
label, keeping the last lines: a worker that exits before listening
raises `TransportError` naming them.

Spawn is two-phase (``wait=False`` + :meth:`WorkerProc.handshake`) so a
router bringing up N workers pays one torch-import latency, not N.
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import repro_torch
from repro_torch import obs
from repro_torch.transport.errors import TransportError

#: env vars forwarded verbatim when set in the router's process
_FORWARD = ("REPRO_PLAN_CACHE", "CUDA_VISIBLE_DEVICES",
            "REPRO_TRANSPORT_BACKEND")

#: stderr lines of a worker kept for the handshake's error message
_TAIL_LINES = 40


def worker_env() -> dict:
    """Child environment with the router's effective config pinned."""
    env = os.environ.copy()
    env["REPRO_OBS"] = "on" if obs.enabled() else "off"
    for key in _FORWARD:
        val = os.environ.get(key)
        if val is not None:
            env[key] = val
    pkg_dir = (os.path.dirname(repro_torch.__file__) if repro_torch.__file__
               else list(repro_torch.__path__)[0])
    src_root = os.path.dirname(os.path.abspath(pkg_dir))
    parts = [src_root] + [p for p in
                          env.get("PYTHONPATH", "").split(os.pathsep)
                          if p and p != src_root]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


class _StderrTail:
    """Drains a worker's stderr pipe onto this process's stderr, each line
    prefixed with the worker's label, and keeps its last lines (a full
    pipe would block the worker)."""

    def __init__(self, stream, label: str):
        self.label = label
        self.lines: collections.deque = collections.deque(
            maxlen=_TAIL_LINES)
        self._thread = threading.Thread(target=self._drain, args=(stream,),
                                        name="worker-stderr", daemon=True)
        self._thread.start()

    def _drain(self, stream) -> None:
        with stream:
            for raw in stream:
                line = raw.decode("utf-8", "replace")
                self.lines.append(line.rstrip("\n"))
                try:
                    sys.stderr.write(f"[{self.label}] {line}")
                except (OSError, ValueError):    # our stderr is gone
                    pass

    def text(self, timeout_s: float = 5.0) -> str:
        """The kept lines, once the pipe reached its end (or after
        `timeout_s`)."""
        self._thread.join(timeout_s)
        return "\n".join(self.lines)


class WorkerProc:
    """One spawned worker: the Popen handle plus its RPC address (None
    until :meth:`handshake` reads the LISTENING line)."""

    def __init__(self, proc: subprocess.Popen, role: str, label: str):
        self.proc = proc
        self.role = role
        self.label = label
        self.addr: Optional[str] = None
        self._stderr = _StderrTail(proc.stderr, label)
        self._t_spawn = time.perf_counter()
        #: seconds from spawn to the LISTENING line (None before)
        self.ready_s: Optional[float] = None

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def handshake(self, timeout_s: float = 120.0) -> str:
        """Block until the worker prints ``LISTENING <addr>``; kills the
        child and raises `TransportError` (with the worker's last stderr
        lines) on timeout or early exit.  Idempotent once the address is
        known."""
        if self.addr is not None:
            return self.addr
        timer = threading.Timer(timeout_s, self.proc.kill)
        timer.start()
        try:
            for raw in self.proc.stdout:
                line = raw.decode("utf-8", "replace").strip()
                if line.startswith("LISTENING "):
                    self.addr = line.split(" ", 1)[1]
                    self.ready_s = time.perf_counter() - self._t_spawn
                    return self.addr
        finally:
            timer.cancel()
        rc = self.proc.wait()
        raise TransportError(
            f"{self.label} exited (rc={rc}) before listening"
            + (" [handshake timeout]" if rc and rc < 0 else "")
            + "; its stderr ends:\n" + self._stderr.text())

    def _close_pipes(self) -> None:
        if self.proc.stdout is not None:
            self.proc.stdout.close()
        self._stderr.text()              # the drain ends with the child

    def stop(self, timeout_s: float = 10.0) -> None:
        """Reap the child: wait briefly (the router normally sends
        ``__shutdown__`` first), then terminate, then kill."""
        if self.proc.poll() is None:
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
        self._close_pipes()

    def kill(self) -> None:
        """Hard-kill (the fault-injection tests' crash lever)."""
        self.proc.kill()
        self.proc.wait()
        self._close_pipes()


def _plan_cache_arg(plan_cache) -> str:
    """The worker's ``--plan-cache``: "off", "auto" or a directory (a
    `PlanDiskCache` crosses as its root)."""
    if plan_cache is None or plan_cache is False:
        return "off"
    return str(getattr(plan_cache, "root", plan_cache))


def _spawn(cmd: list, role: str, label: str, *,
           wait: bool, timeout_s: float) -> WorkerProc:
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=worker_env())
    wp = WorkerProc(proc, role, label)
    if obs.enabled():
        obs.counter("repro_transport_workers_spawned_total", role=role)
    if wait:
        wp.handshake(timeout_s)
    return wp


def spawn_shard_worker(shard_id: int, lo: int, hi: int, *, K: int,
                       n: int, chunk_size: int = 1 << 20,
                       backend: str = "streaming", plan_cache="auto",
                       device: str = "cuda", addr: str = "127.0.0.1:0",
                       wait: bool = True,
                       timeout_s: float = 120.0) -> WorkerProc:
    cmd = [sys.executable, "-m", "repro_torch.transport.worker",
           "--role", "shard", "--addr", addr,
           "--shard-id", str(shard_id), "--lo", str(lo),
           "--hi", str(hi), "--classes", str(K), "--nodes", str(n),
           "--chunk-size", str(chunk_size), "--backend", backend,
           "--plan-cache", _plan_cache_arg(plan_cache),
           "--device", str(device)]
    return _spawn(cmd, "shard", f"shard worker {shard_id}",
                  wait=wait, timeout_s=timeout_s)


def spawn_replica_worker(data_dir: str, *, poll_ms: float = 20.0,
                         chunk_size: int = 1 << 20,
                         backend: str = "streaming", plan_cache="auto",
                         device: str = "cuda",
                         addr: str = "127.0.0.1:0", wait: bool = True,
                         timeout_s: float = 120.0) -> WorkerProc:
    cmd = [sys.executable, "-m", "repro_torch.transport.worker",
           "--role", "replica", "--addr", addr,
           "--data-dir", str(data_dir), "--poll-ms", str(poll_ms),
           "--chunk-size", str(chunk_size), "--backend", backend,
           "--plan-cache", _plan_cache_arg(plan_cache),
           "--device", str(device)]
    return _spawn(cmd, "replica", f"replica worker @ {data_dir}",
                  wait=wait, timeout_s=timeout_s)
