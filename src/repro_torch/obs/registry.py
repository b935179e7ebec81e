"""Process-wide metrics registry: counters, gauges, latency histograms.

The port's own copy of `repro.obs.registry`: the same names, buckets,
summaries and Prometheus text.  One registry per process
(`repro_torch.obs` owns the default), three instrument kinds, all
labeled:

  counter    monotonically-increasing float (events, bytes, edges);
  gauge      last-write-wins float (edges/s, accumulator bytes,
             health state);
  histogram  log-bucketed value distribution with O(1) observe and
             cheap p50/p95/p99 summaries — latencies land here.

Every series is addressed by ``(name, sorted(labels))``.  Names are
validated against the repo-wide scheme ``repro_<subsystem>_<metric>``
(lowercase ``[a-z0-9_]``, at least three underscore-separated segments
with ``repro`` first) so a renamed series is a loud failure at the
emission site, not a silently-empty dashboard (`benchmarks.run`
additionally cross-checks bench rows against this scheme).

Thread safety: one lock per registry around the series maps; observe /
add / set are dict-lookup + float-add under that lock — cheap enough
for every hot path this repo has (WAL appends, batcher tickets).  The
truly-free disabled path lives in `repro_torch.obs` (the facade returns
before any registry call when ``REPRO_OBS=off``); the registry itself
always does real work.

Histogram buckets are geometric, base 2, anchored at 1 microsecond:
bucket ``i`` holds values in ``(1e-6 * 2**(i-1), 1e-6 * 2**i]`` — 64
buckets span sub-microsecond to ~half a million years, so one layout
serves latencies, byte counts, and batch sizes alike.  Quantiles are
read from the cumulative bucket walk and reported as the matching
bucket's upper bound: an over-estimate bounded by the 2x bucket width,
the standard log-histogram trade.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

_NAME_RE = re.compile(r"^repro_[a-z0-9]+(_[a-z0-9]+)+$")
_LABEL_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: bucket 0 upper bound (seconds for latencies; unitless otherwise)
_B0 = 1e-6
_NBUCKETS = 64


def valid_metric_name(name: str) -> bool:
    """True iff `name` follows ``repro_<subsystem>_<metric>``."""
    return _NAME_RE.match(name) is not None


def _check_name(name: str) -> None:
    if not valid_metric_name(name):
        raise ValueError(
            f"metric name {name!r} violates the repo naming scheme "
            "repro_<subsystem>_<metric> (lowercase [a-z0-9_], >= 3 "
            "underscore-separated segments starting with 'repro')")


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _format_series(name: str, key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


def bucket_index(value: float) -> int:
    """Index of the log2 bucket holding `value` (clamped)."""
    if value <= _B0:
        return 0
    return min(_NBUCKETS - 1, int(math.ceil(math.log2(value / _B0))))


def bucket_upper(i: int) -> float:
    return _B0 * (2.0 ** i)


class _Hist:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * _NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bucket_index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket containing the q-quantile rank."""
        if not self.count:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                # clamp the log-bucket over-estimate to the observed
                # extremes so tiny samples read sanely
                return float(min(max(bucket_upper(i), self.min),
                                 self.max))
        return float(self.max)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum,
                "min": (0.0 if self.count == 0 else self.min),
                "max": (0.0 if self.count == 0 else self.max),
                "p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Labeled counters / gauges / histograms behind one lock."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: Dict[str, Dict[Tuple, float]] = {}  # guarded by: _mu
        self._gauges: Dict[str, Dict[Tuple, float]] = {}    # guarded by: _mu
        self._hists: Dict[str, Dict[Tuple, _Hist]] = {}     # guarded by: _mu

    # -- write side --------------------------------------------------------

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._mu:
            fam = self._counters.get(name)
            if fam is None:
                _check_name(name)
                fam = self._counters[name] = {}
            fam[key] = fam.get(key, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._mu:
            fam = self._gauges.get(name)
            if fam is None:
                _check_name(name)
                fam = self._gauges[name] = {}
            fam[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._mu:
            fam = self._hists.get(name)
            if fam is None:
                _check_name(name)
                fam = self._hists[name] = {}
            h = fam.get(key)
            if h is None:
                h = fam[key] = _Hist()
            h.observe(float(value))

    def reset(self) -> None:
        with self._mu:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- read side ---------------------------------------------------------

    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        """Point-in-time copy: flat ``series-string -> value`` maps
        (histograms -> summary dicts).  `prefix` filters by metric
        name."""
        with self._mu:
            out: Dict[str, Any] = {"counters": {}, "gauges": {},
                                   "histograms": {}}
            for name, fam in self._counters.items():
                if not name.startswith(prefix):
                    continue
                for key, v in fam.items():
                    out["counters"][_format_series(name, key)] = v
            for name, fam in self._gauges.items():
                if not name.startswith(prefix):
                    continue
                for key, v in fam.items():
                    out["gauges"][_format_series(name, key)] = v
            for name, fam in self._hists.items():
                if not name.startswith(prefix):
                    continue
                for key, h in fam.items():
                    out["histograms"][_format_series(name, key)] = \
                        h.summary()
            return out

    def series_names(self) -> set:
        """Every distinct metric NAME (label sets collapsed)."""
        with self._mu:
            return (set(self._counters) | set(self._gauges)
                    | set(self._hists))

    def counter_value(self, name: str, **labels) -> float:
        with self._mu:
            return self._counters.get(name, {}).get(
                _label_key(labels), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        with self._mu:
            return self._gauges.get(name, {}).get(_label_key(labels))

    def hist_summary(self, name: str, **labels) -> Dict[str, float]:
        with self._mu:
            h = self._hists.get(name, {}).get(_label_key(labels))
            return h.summary() if h is not None else _Hist().summary()

    # -- export ------------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4).

        Counters/gauges render one sample per series; histograms render
        cumulative ``_bucket{le=...}`` samples (only non-empty buckets
        plus ``+Inf``) with ``_sum`` / ``_count``."""
        def fmt(v: float) -> str:
            return f"{v:.10g}"

        lines = []
        with self._mu:
            for name in sorted(self._counters):
                lines.append(f"# TYPE {name} counter")
                for key, v in sorted(self._counters[name].items()):
                    lines.append(
                        f"{_format_series(name, key)} {fmt(v)}")
            for name in sorted(self._gauges):
                lines.append(f"# TYPE {name} gauge")
                for key, v in sorted(self._gauges[name].items()):
                    lines.append(
                        f"{_format_series(name, key)} {fmt(v)}")
            for name in sorted(self._hists):
                lines.append(f"# TYPE {name} histogram")
                for key, h in sorted(self._hists[name].items()):
                    cum = 0
                    for i, c in enumerate(h.counts):
                        if not c:
                            continue
                        cum += c
                        le = fmt(bucket_upper(i))
                        lines.append(_format_series(
                            name + "_bucket",
                            key + (("le", le),)) + f" {cum}")
                    lines.append(_format_series(
                        name + "_bucket",
                        key + (("le", "+Inf"),)) + f" {h.count}")
                    lines.append(
                        f"{_format_series(name + '_sum', key)} "
                        f"{fmt(h.sum)}")
                    lines.append(
                        f"{_format_series(name + '_count', key)} "
                        f"{h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def summarize(snapshot: Dict[str, Any],
              kinds: Iterable[str] = ("counters", "gauges",
                                      "histograms")) -> str:
    """Human-readable rendering of a `snapshot()` dict (the CLI's
    pretty printer)."""
    out = []
    for kind in kinds:
        rows = snapshot.get(kind) or {}
        if not rows:
            continue
        out.append(f"== {kind} ==")
        width = max(len(k) for k in rows)
        for series in sorted(rows):
            v = rows[series]
            if kind == "histograms":
                out.append(
                    f"{series:<{width}}  n={v['count']:<8g} "
                    f"p50={v['p50']:.3g} p95={v['p95']:.3g} "
                    f"p99={v['p99']:.3g} max={v['max']:.3g} "
                    f"sum={v['sum']:.3g}")
            else:
                out.append(f"{series:<{width}}  {v:g}")
    return "\n".join(out)
