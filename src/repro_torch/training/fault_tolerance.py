"""Fault tolerance for long runs: the port of
`repro.training.fault_tolerance` for one process.

1. Crash recovery: atomic checkpoints + `restore_checkpoint`
   (checkpoint.py); the trainer saves params + optimizer state every
   `--ckpt-every` steps and resumes from LATEST on restart.
2. Straggler detection: `StragglerMonitor` tracks per-step wall times;
   a step over `deadline_factor` x the trailing median is logged and
   counted (hook `on_straggler`).
3. Heartbeats: `Heartbeat` files under the run dir let a supervisor
   detect a dead host by mtime.

The reference's `ElasticMeshManager` rebuilds a `jax` device mesh; the
port has no mesh yet (it comes with `torch.distributed`), so only
`simulate_failure`, the test hook that drops devices, is here.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class Heartbeat:
    def __init__(self, run_dir: str, host_id: int = 0,
                 interval_s: float = 10.0):
        self.path = os.path.join(run_dir, f"heartbeat_{host_id}")
        self.interval = interval_s
        self._last = 0.0
        os.makedirs(run_dir, exist_ok=True)

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "time": now}, f)
            os.replace(tmp, self.path)
            self._last = now

    @staticmethod
    def dead_hosts(run_dir: str, timeout_s: float = 60.0) -> list:
        now = time.time()
        dead = []
        for f in os.listdir(run_dir):
            if f.startswith("heartbeat_") and not f.endswith(".tmp"):
                if now - os.path.getmtime(os.path.join(run_dir, f)) > \
                        timeout_s:
                    dead.append(int(f.split("_")[1]))
        return dead


@dataclass
class StragglerMonitor:
    deadline_factor: float = 3.0
    window: int = 50
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    times: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=50))
    straggler_steps: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step counts as a straggler."""
        is_straggler = False
        if len(self.times) >= 10:
            med = statistics.median(self.times)
            if dt > self.deadline_factor * med:
                is_straggler = True
                self.straggler_steps.append((step, dt, med))
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self.times.append(dt)
        return is_straggler


def simulate_failure(devices, kill: int):
    """Test hook: drop `kill` devices from the tail (a dead host)."""
    return devices[:len(devices) - kill]
