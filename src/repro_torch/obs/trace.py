"""Span tracing: parent-linked timed events for "where did the time go".

A span is a context manager around one logical operation::

    with obs.span("encoder.plan", backend="cuda", n=n, s=s) as sp:
        plan = build(...)
        sp.fence(Z)                # synchronize Z's CUDA device: device
                                   # work is attributed to THIS span

Spans nest per thread (a thread-local stack links each span to its
parent), so a serving rebuild shows up as one ``serving.rebuild`` span
with ``encoder.plan`` / ``encoder.fit`` children per shard.  On exit
each span becomes an **event**:

    {"name", "id", "parent", "t0" (epoch seconds), "dur_s", "thread",
     "attrs", "error"?}

Events land in a bounded in-memory ring (default 4096, newest wins;
``REPRO_OBS_RING``) and, when a JSONL sink is configured
(``REPRO_OBS_TRACE=/path`` or ``obs.configure(trace_path=...)``), are
appended one JSON object per line; `render_tree` rebuilds and
pretty-prints the parent-linked tree from such a file.

The port's own copy of `repro.obs.trace`.  ``fence()`` matters because
CUDA launches are asynchronous: without a synchronize at the span
boundary, device work started inside the span would be billed to
whichever LATER span happens to synchronize.  The port's fence
synchronizes the CUDA device of every tensor it is given (CPU tensors
and other values pass through) and lets a device error out, where the
reference's swallowed every exception.  When tracing is disabled the
no-op span singleton neither times nor blocks.
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional


class Tracer:
    """Ring buffer + optional JSONL sink; one per process."""

    def __init__(self, ring: int = 4096,
                 trace_path: Optional[str] = None):
        self._mu = threading.Lock()
        self._ids = itertools.count(1)   # guarded by: _mu
        self._tls = threading.local()
        # guarded by: _mu
        self.ring: collections.deque = collections.deque(maxlen=ring)
        self._trace_path: Optional[str] = None   # guarded by: _mu
        self._trace_file = None          # guarded by: _mu
        self.set_sink(trace_path)

    # -- configuration -----------------------------------------------------

    def set_ring(self, size: int) -> None:
        with self._mu:
            self.ring = collections.deque(self.ring, maxlen=int(size))

    def set_sink(self, path: Optional[str]) -> None:
        """(Re)point the JSONL sink; None/"" closes it."""
        with self._mu:
            if self._trace_file is not None:
                try:
                    self._trace_file.close()
                except OSError:
                    pass
                self._trace_file = None
            self._trace_path = path or None

    @property
    def trace_path(self) -> Optional[str]:
        with self._mu:
            return self._trace_path

    # -- span plumbing -----------------------------------------------------

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def begin(self, name: str, attrs: Dict[str, Any]) -> "Span":
        sp = Span(self, name, attrs)
        stack = self._stack()
        sp.parent = stack[-1] if stack else None
        with self._mu:
            sp.id = next(self._ids)
        stack.append(sp.id)
        return sp

    def end(self, sp: "Span") -> None:
        stack = self._stack()
        # tolerate exotic exits (generator spans resumed on another
        # thread): only pop if we are the top of OUR thread's stack
        if stack and stack[-1] == sp.id:
            stack.pop()
        event = {"name": sp.name, "id": sp.id, "parent": sp.parent,
                 "t0": sp.t_wall, "dur_s": sp.duration,
                 "thread": sp.thread, "attrs": sp.attrs}
        if sp.error:
            event["error"] = sp.error
        with self._mu:
            self.ring.append(event)
            if self._trace_path is not None:
                try:
                    if self._trace_file is None:
                        self._trace_file = open(self._trace_path, "a")
                    self._trace_file.write(
                        json.dumps(event, default=str) + "\n")
                    self._trace_file.flush()
                except OSError:
                    self._trace_path = None     # sink broke: stop trying

    def events(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self.ring)

    def reset(self) -> None:
        with self._mu:
            self.ring.clear()


class Span:
    """One live span (use via ``obs.span(...)`` — not constructed
    directly).  `metric`/`mlabels` optionally mirror the duration into
    a registry histogram on exit, so call sites need one construct for
    both tracing and metrics."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent", "t_wall",
                 "_t0", "duration", "thread", "error", "metric",
                 "mlabels", "_registry")

    def __init__(self, tracer: Tracer, name: str,
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.id = 0
        self.parent: Optional[int] = None
        self.t_wall = 0.0
        self._t0 = 0.0
        self.duration = 0.0
        self.thread = threading.current_thread().name
        self.error: Optional[str] = None
        self.metric: Optional[str] = None
        self.mlabels: Dict[str, str] = {}
        self._registry = None

    def set(self, **attrs) -> "Span":
        """Attach/override attributes mid-span."""
        self.attrs.update(attrs)
        return self

    def fence(self, value):
        """Synchronize the CUDA device of each tensor in `value` (a
        tensor, or a list, tuple or dict of them) so that its pending
        work is attributed to this span; returns `value`.  CPU tensors
        and other values pass through; a device error is raised."""
        for dev in _cuda_devices(value):
            import torch
            torch.cuda.synchronize(dev)
        return value

    def __enter__(self) -> "Span":
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration = time.perf_counter() - self._t0
        if exc is not None:
            self.error = repr(exc)
        self.tracer.end(self)
        if self.metric is not None and self._registry is not None:
            self._registry.observe(self.metric, self.duration,
                                   **self.mlabels)


def _cuda_devices(value) -> set:
    """The CUDA devices of the tensors in `value` (nested lists, tuples
    and dict values), without importing torch for other values."""
    if isinstance(value, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in value))
    if isinstance(value, dict):
        return _cuda_devices(list(value.values()))
    dev = getattr(value, "device", None)
    if getattr(dev, "type", None) == "cuda" and hasattr(value, "data_ptr"):
        return {dev}
    return set()


class NoopSpan:
    """The disabled path: a shared singleton that neither times,
    records, nor blocks."""

    __slots__ = ()

    #: call sites may read `sp.duration` after the block (edges/s
    #: gauges); disabled spans report 0.0 and the gauge is skipped
    duration = 0.0

    def set(self, **attrs) -> "NoopSpan":
        return self

    def fence(self, value):
        return value                      # no block: stay async

    def __enter__(self) -> "NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = NoopSpan()


# -- trace replay ------------------------------------------------------------

def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL trace file (bad lines skipped, not fatal)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events


def render_tree(events: List[Dict[str, Any]]) -> str:
    """Pretty-print events as parent-linked trees, start-time ordered.

    Spans record on EXIT, so children precede parents in the stream;
    the tree is rebuilt from the explicit parent links.  A child whose
    parent fell off the ring/file renders as a root."""
    ids = {e.get("id") for e in events}
    children: Dict[Any, list] = {}
    roots = []
    for e in events:
        p = e.get("parent")
        if p is not None and p in ids:
            children.setdefault(p, []).append(e)
        else:
            roots.append(e)

    def start(e):
        return e.get("t0") or 0.0

    out: List[str] = []

    def walk(e, depth):
        attrs = e.get("attrs") or {}
        extras = " ".join(f"{k}={v}" for k, v in attrs.items())
        err = "  ERROR " + e["error"] if e.get("error") else ""
        out.append(f"{'  ' * depth}- {e.get('name', '?')} "
                   f"{1e3 * (e.get('dur_s') or 0.0):.3f}ms"
                   + (f"  [{extras}]" if extras else "") + err)
        for c in sorted(children.get(e.get("id"), []), key=start):
            walk(c, depth + 1)

    for r in sorted(roots, key=start):
        walk(r, 0)
    return "\n".join(out)
