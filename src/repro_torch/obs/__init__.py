"""repro_torch.obs — the observability layer (the port of `repro.obs`).

One process-wide substrate for every subsystem's telemetry, with the
reference's metric and span names:

* **metrics registry** (`registry.MetricsRegistry`) — labeled
  counters, gauges, and log-bucketed latency histograms with
  p50/p95/p99 summaries; every series follows
  ``repro_<subsystem>_<metric>`` (validated — a renamed series fails
  loudly).
* **span tracing** (`trace`) — ``span("serving.rebuild", ...)``
  context managers producing parent-linked timed events into a
  bounded ring plus an optional JSONL sink, with ``sp.fence(tensor)``
  synchronizing the tensor's CUDA device so that asynchronous device
  work is billed to the span that launched it.
* **export surfaces** — ``snapshot()`` (flat dict, the engine's
  ``stats()`` substrate) and ``render_prometheus()`` (text exposition
  format).  The reference's ``python -m repro.obs`` CLI is not ported
  yet.

Enable/disable: **on by default**; ``REPRO_OBS=off`` (or ``0/none/
disable(d)``) turns the whole layer into true no-ops — module-level
helpers return before touching the registry, ``span()`` hands back a
shared do-nothing singleton that never calls the clock and never
synchronizes a device.

Environment (the reference's variables, read the same way):

    REPRO_OBS        on (default) / off
    REPRO_OBS_TRACE  path: append every span as a JSON line
    REPRO_OBS_RING   in-memory span ring capacity (default 4096)

Usage::

    from repro_torch import obs

    obs.counter("repro_serving_wal_records_total")
    obs.observe("repro_serving_wal_append_seconds", dt)
    with obs.span("serving.checkpoint",
                  metric="repro_serving_checkpoint_seconds") as sp:
        ...
        sp.fence(Z)
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from repro_torch.obs.registry import (MetricsRegistry, summarize,
                                valid_metric_name)
from repro_torch.obs.trace import (NOOP_SPAN, Span, Tracer, load_jsonl,
                             render_tree)

__all__ = ["MetricsRegistry", "Tracer", "configure", "counter",
           "enabled", "gauge", "load_jsonl", "observe", "registry",
           "render_prometheus", "render_tree", "reset", "snapshot",
           "span", "summarize", "tick", "tracer", "valid_metric_name"]

_OFF_VALUES = ("0", "off", "none", "disable", "disabled", "false")


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "on").strip().lower() \
        not in _OFF_VALUES


def _env_ring() -> int:
    try:
        return max(1, int(os.environ.get("REPRO_OBS_RING", "4096")))
    except ValueError:
        return 4096


_ENABLED: bool = _env_enabled()
_REGISTRY = MetricsRegistry()
_TRACER = Tracer(ring=_env_ring(),
                 trace_path=os.environ.get("REPRO_OBS_TRACE") or None)


def registry() -> MetricsRegistry:
    return _REGISTRY


def tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    """Is the observability layer live?  (`REPRO_OBS`, default on.)
    Call sites with non-trivial measurement work (clock reads, label
    dict builds) should guard on this; the helpers below already
    no-op."""
    return _ENABLED


def configure(*, enabled: Optional[bool] = None,
              trace_path: Optional[str] = None,
              ring: Optional[int] = None) -> None:
    """Runtime overrides (tests, benchmarks).
    ``trace_path=""`` closes the JSONL sink."""
    global _ENABLED
    if enabled is not None:
        _ENABLED = bool(enabled)
    if trace_path is not None:
        _TRACER.set_sink(trace_path or None)
    if ring is not None:
        _TRACER.set_ring(ring)


def reset() -> None:
    """Clear every metric series and the span ring (tests)."""
    _REGISTRY.reset()
    _TRACER.reset()


# -- hot-path helpers (each returns immediately when disabled) ---------------

def tick() -> float:
    """perf_counter when enabled, 0.0 when not — the cheap way to
    bracket a measurement without an enabled() branch at the call
    site.  Pair with `tock`."""
    return time.perf_counter() if _ENABLED else 0.0


def tock(t0: float) -> float:
    """Seconds since `tick()`'s return, or 0.0 when disabled."""
    return time.perf_counter() - t0 if _ENABLED else 0.0


def counter(name: str, value: float = 1.0, **labels) -> None:
    if _ENABLED:
        _REGISTRY.counter(name, value, **labels)


def gauge(name: str, value: float, **labels) -> None:
    if _ENABLED:
        _REGISTRY.gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    if _ENABLED:
        _REGISTRY.observe(name, value, **labels)


def span(name: str, *, metric: Optional[str] = None,
         mlabels: Optional[Dict[str, str]] = None, **attrs):
    """Context manager tracing one operation (see `repro.obs.trace`).
    ``metric=`` mirrors the span duration into a registry histogram on
    exit.  Disabled -> a shared no-op singleton (no clock, no sync)."""
    if not _ENABLED:
        return NOOP_SPAN
    sp = _TRACER.begin(name, dict(attrs))
    if metric is not None:
        sp.metric = metric
        sp.mlabels = mlabels or {}
        sp._registry = _REGISTRY
    return sp


# -- export surfaces ---------------------------------------------------------

def snapshot(prefix: str = "") -> Dict[str, Any]:
    """Flat point-in-time view of every series (optionally filtered by
    metric-name prefix), plus the enabled flag."""
    out = _REGISTRY.snapshot(prefix)
    out["enabled"] = _ENABLED
    return out


def render_prometheus() -> str:
    """The full registry in Prometheus text exposition format."""
    return _REGISTRY.render_prometheus()


def trace_events():
    """The in-memory span ring, oldest first."""
    return _TRACER.events()
