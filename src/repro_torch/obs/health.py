"""Health state machine for long-running components (the port's own
copy of `repro.obs.health`).

Three states, strictly ordered by severity::

    starting  ->  serving  <->  degraded

* ``starting``  — construction/recovery in progress; reads may block
  or be refused.
* ``serving``   — steady state.
* ``degraded``  — still answering, but a standing fault is present
  (the serving engine enters it when the background flush loop has
  recorded a ``loop_error``, or when WAL append/fsync latency breaches
  its threshold).  Degraded is re-evaluated, not latched: when the
  condition clears the tracker returns to ``serving``.

Every transition is counted (``repro_<component>_health_transitions_
total{to=...}``) and the current state is exported as a gauge
(``repro_<component>_health_state``: 0 starting / 1 serving /
2 degraded) so a Prometheus alert can fire on ``> 1``.
"""
from __future__ import annotations

import time
from typing import Optional

STARTING = "starting"
SERVING = "serving"
DEGRADED = "degraded"

STATE_VALUES = {STARTING: 0, SERVING: 1, DEGRADED: 2}


class HealthTracker:
    """Tracks one component's health state + reason; exports gauges."""

    def __init__(self, component: str):
        self.component = str(component)
        self.state = STARTING
        self.reason: Optional[str] = None
        self.since = time.time()
        self._export()

    def _export(self) -> None:
        from repro_torch import obs
        obs.gauge(f"repro_{self.component}_health_state",
                  STATE_VALUES[self.state])

    def to(self, state: str, reason: Optional[str] = None) -> bool:
        """Transition (idempotent).  Returns True iff the state
        actually changed; the reason refreshes either way."""
        if state not in STATE_VALUES:
            raise ValueError(f"unknown health state {state!r}")
        changed = state != self.state
        self.reason = reason
        if changed:
            self.state = state
            self.since = time.time()
            from repro_torch import obs
            obs.counter(
                f"repro_{self.component}_health_transitions_total",
                to=state)
            self._export()
        return changed

    def as_dict(self) -> dict:
        out = {"state": self.state, "since": self.since}
        if self.reason:
            out["reason"] = self.reason
        return out
