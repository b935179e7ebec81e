"""Optimizers (self-contained): the port of `repro.training.optimizer`.

AdamW with dtype-configurable moments (`state_dtype`; the 314B-class
configs keep bf16 moments), the reference's math: b1 0.9, b2 0.95, eps
1e-8, bias correction at step = state.step + 1, lr x schedule(step),
clipping by the global norm of the float32 grads, and weight decay on
every leaf with ndim >= 2 (which includes the stacked (L, d) norm
scales: the reference decays them because they are stacked).

The update runs in place, leaf by leaf, under `torch.no_grad()`: the
reference's functional update would hold three more float32 copies of
the model (31 GB for yi-6b's width at 12 layers).  Params are a
`ParamTree`; grads, m and v nested dicts at the same key paths.
`AdamWState(step, m, v)` is the reference's state; `step` is a Python
int here, saved by `checkpoint` as the reference's int32 scalar.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.layers import dtype_of
from repro_torch.training.trees import items, tree_map


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def _f32(x) -> float:
    """A float32 value as a Python float (exact), so that a tensor op
    with it computes as the reference's float32 scalar does."""
    return float(np.float32(x))


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    clip_norm: float = 1.0
    schedule: Optional[Callable] = None     # step -> lr multiplier

    def init(self, params) -> AdamWState:
        """Zero moments laid out as the params (a DTensor param's moments
        are DTensors with its placements)."""
        dt = dtype_of(self.state_dtype)

        def zeros(p):
            return torch.zeros_like(p, dtype=dt,
                                    memory_format=torch.contiguous_format)

        return AdamWState(0, tree_map(zeros, params),
                          tree_map(zeros, params))

    def init_abstract(self, abstract_params) -> AdamWState:
        """The state of `init` as meta tensors (the dry run's stand-ins),
        step an int32 scalar as the reference's."""
        dt = dtype_of(self.state_dtype)

        def zeros(p):
            return torch.empty(p.shape, dtype=dt, device="meta")

        return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                          tree_map(zeros, abstract_params),
                          tree_map(zeros, abstract_params))

    def update(self, grads, state: AdamWState, params):
        """Writes params, m and v in place; returns (params,
        AdamWState(state.step + 1, m, v)).  grads is left as it was."""
        step = state.step + 1
        dt = dtype_of(self.state_dtype)
        b1, b2 = self.b1, self.b2
        f32 = np.float32
        bc1 = _f32(f32(1) - f32(b1) ** f32(step))
        bc2 = _f32(f32(1) - f32(b2) ** f32(step))
        lr = _f32(f32(self.lr) * (self.schedule(step) if self.schedule
                                  else f32(1)))
        g_leaves, m_leaves, v_leaves = (dict(items(t)) for t in
                                        (grads, state.m, state.v))
        with torch.no_grad():
            scale = None
            if self.clip_norm:
                gn = global_norm(grads)
                scale = torch.clamp(
                    self.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
            for path, p in items(params):
                g = g_leaves[path].to(torch.float32)
                if scale is not None:
                    g = g * scale
                m, v = m_leaves[path], v_leaves[path]
                m32 = m.to(torch.float32) * b1 + g * (1 - b1)
                v32 = v.to(torch.float32) * b2 + g.square() * (1 - b2)
                del g
                delta = (m32 / bc1) / ((v32 / bc2).sqrt() + self.eps)
                if self.weight_decay and p.ndim >= 2:   # decay matrices only
                    delta = delta + self.weight_decay * p.to(torch.float32)
                p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
                del delta
                m.copy_(m32.to(dt))
                v.copy_(v32.to(dt))
        return params, AdamWState(step, state.m, state.v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves
    added in the reference's order."""
    total = 0
    for _, x in items(tree):
        total = total + x.to(torch.float32).square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def cosine_schedule(warmup: int, total: int, floor: float = 0.1):
    """step (int) -> lr multiplier, in float32 as the reference's: a
    linear warm-up over `warmup` steps, then a cosine from 1 to `floor`
    at `total`."""
    def fn(step):
        f32 = np.float32
        s = f32(step)
        warm = min(s / f32(max(warmup, 1)), f32(1))
        prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0), f32(1))
        cos = f32(floor) + f32((1 - floor) * 0.5) * (
            f32(1) + np.cos(f32(np.pi) * prog))
        return f32(warm * cos)
    return fn
