"""Fault tolerance for long runs: the port of
`repro.training.fault_tolerance`.

1. Crash recovery: atomic checkpoints + `restore_checkpoint`
   (checkpoint.py); the trainer saves params + optimizer state every
   `--ckpt-every` steps and resumes from LATEST on restart.
2. Elastic re-mesh: `ElasticMeshManager` rebuilds the (data, model)
   `DeviceMesh` over the surviving ranks and rebuilds the step.
   Checkpoints are stored unsharded and placements derive from (mesh,
   logical rules), so restoring onto another rank count is
   `make_rules(new_mesh)`.
3. Straggler detection: `StragglerMonitor` tracks per-step wall times;
   a step over `deadline_factor` x the trailing median is logged and
   counted (hook `on_straggler`).
4. Heartbeats: `Heartbeat` files under the run dir let a supervisor
   detect a dead host by mtime.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh


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


class ElasticMeshManager:
    """Rebuild mesh/rules/step when the healthy rank set changes.

    The model axis is preserved (weights must still fit), the data axis
    shrinks to what the surviving ranks support.  `healthy_devices` are
    global ranks of the default process group; `device_type` the mesh's
    ("cuda" or "cpu").  Every rank of the default group calls `remesh`
    with the same list (building a mesh creates its groups on every
    rank); a rank outside the new mesh gets it back all the same and
    takes no part in its collectives."""

    def __init__(self, build_step: Callable, model_axis_size: int,
                 device_type: str = "cuda"):
        self.build_step = build_step
        self.model_axis = model_axis_size
        self.device_type = device_type
        self.generation = 0

    def remesh(self, healthy_devices) -> tuple:
        n = len(healthy_devices)
        model = self.model_axis
        if n < model:
            raise ValueError(f"{n} ranks cannot hold a model axis of "
                             f"{model}")
        data = n // model
        usable = list(healthy_devices)[:data * model]
        mesh = DeviceMesh(self.device_type,
                          torch.tensor(usable).view(data, model),
                          mesh_dim_names=("data", "model"))
        self.generation += 1
        step = self.build_step(mesh)
        return mesh, step, self.generation


def simulate_failure(devices, kill: int):
    """Test hook: drop `kill` devices from the tail (a dead host)."""
    return devices[:len(devices) - kill]
