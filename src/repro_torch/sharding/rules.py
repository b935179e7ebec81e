"""Logical-axis sharding rules -> DTensor placements, divisibility-aware.

The port of `repro.sharding.rules`.  Two rule tables, because the same
logical name means different things on weights and activations:

  * weight rules — "embed" shards over the data axes (ZeRO-3/FSDP: a
    layer's weights are all-gathered where it runs), "mlp", "heads",
    "vocab" shard over the model axis (TP).
  * activation rules — "batch" over (pod, data); head/mlp/vocab dims
    over model; "embed" replicated (activations are batch-sharded, not
    feature-sharded, except where sequence parallelism is enabled).

Every rule application checks divisibility and axis reuse: a dim that
does not divide (xlstm's 4 heads on a 16-way model axis) falls back to
replication.  `spec` answers as the reference's `PartitionSpec` does:
one entry per tensor dim, each None, an axis name or a tuple of axis
names, trailing Nones dropped (a plain tuple here).  `placements` turns
that answer into one DTensor placement per mesh dim: a tensor dim over
("pod", "data") is `Shard(d)` on both mesh dims, pod major, the order in
which JAX lays a tuple of axes out.

A mesh is a `DeviceMesh` with named dims, or any object with a
name -> size `shape` dict and `axis_names` (a shape-only mesh: the rules
never touch a device).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (dtype_of, set_activation_sharder,
                                       tree_map_specs)

DATA_AXES = ("pod", "data")      # FSDP/DP axes (pod present on multi-pod)
MODEL_AXIS = "model"


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _present(mesh, names) -> tuple:
    have = mesh_axes(mesh)
    return tuple(a for a in names if a in have)


def default_weight_rules(mesh) -> dict:
    fsdp = _present(mesh, DATA_AXES)
    return {
        "embed": fsdp,
        "mlp": MODEL_AXIS,
        "heads": MODEL_AXIS,
        "kv_heads": MODEL_AXIS,
        "vocab": MODEL_AXIS,
        "experts": None,
        "layers": None,
        "inner": None,
        "embed_out": None,
        # state/cache logical names that can appear in spec trees
        "batch": fsdp,
        "kv_seq": MODEL_AXIS,
        "seq": None,
    }


def default_act_rules(mesh) -> dict:
    batch = _present(mesh, DATA_AXES)
    return {
        "batch": batch,
        "seq": None,
        "embed": None,
        "heads": MODEL_AXIS,
        "kv_heads": MODEL_AXIS,
        "mlp": MODEL_AXIS,
        "vocab": MODEL_AXIS,
        "experts": None,
        "kv_seq": MODEL_AXIS,
    }


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass
class ShardingRules:
    mesh: object
    weight: dict
    act: dict

    def spec(self, shape, logical, table) -> tuple:
        sizes = mesh_axes(self.mesh)
        used: set = set()
        parts = []
        for dim, name in zip(shape, logical):
            axes = table.get(name) if name is not None else None
            if axes is None:
                parts.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            axes = tuple(a for a in axes if a in sizes and a not in used)
            size = math.prod(sizes[a] for a in axes)
            if not axes or size == 1 or dim % size != 0:
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def weight_spec(self, shape, logical) -> tuple:
        return self.spec(shape, logical, self.weight)

    def act_spec(self, shape, logical) -> tuple:
        return self.spec(shape, logical, self.act)

    def placements(self, spec: tuple) -> tuple:
        """One placement per mesh dim: Shard(d) where tensor dim d lies
        over that axis, Replicate elsewhere."""
        out = {a: Replicate() for a in mesh_axes(self.mesh)}
        for d, entry in enumerate(spec):
            for a in _axes_of(entry):
                out[a] = Shard(d)
        return tuple(out.values())

    def named(self, spec: tuple) -> tuple:
        """The reference's NamedSharding: the spec's placements."""
        return self.placements(spec)

    def shards(self, spec: tuple) -> int:
        """How many pieces a tensor with `spec` is cut into."""
        sizes = mesh_axes(self.mesh)
        return math.prod(sizes[a] for e in spec for a in _axes_of(e))

    def local_shape(self, shape, spec: tuple) -> tuple:
        """One rank's shape of a tensor of `shape` laid out by `spec`."""
        sizes = mesh_axes(self.mesh)
        out = list(shape)
        for d, entry in enumerate(spec):
            out[d] //= math.prod(sizes[a] for a in _axes_of(entry))
        return tuple(out)


def make_rules(mesh, *, seq_shard_acts: bool = False,
               fsdp: bool = True) -> ShardingRules:
    w = default_weight_rules(mesh)
    a = default_act_rules(mesh)
    if not fsdp:
        w["embed"] = None
        w["batch"] = _present(mesh, DATA_AXES)
    if seq_shard_acts:                       # sequence parallelism
        a["seq"] = MODEL_AXIS
    return ShardingRules(mesh, w, a)


# ---------------------------------------------------------------------------
# Tree helpers
# ---------------------------------------------------------------------------


def spec_tree_shardings(rules: ShardingRules, spec_tree):
    """ParamSpec tree -> placements tree (weight rules)."""
    return tree_map_specs(
        lambda s: rules.named(rules.weight_spec(s.shape, s.logical)),
        spec_tree)


def spec_tree_pspecs(rules: ShardingRules, spec_tree):
    return tree_map_specs(
        lambda s: rules.weight_spec(s.shape, s.logical), spec_tree)


# ---------------------------------------------------------------------------
# Placing tensors
# ---------------------------------------------------------------------------


def local_piece(full, mesh, placements):
    """This rank's piece of `full` under `placements` on a DeviceMesh:
    mesh dims that shard one tensor dim cut it in mesh-dim order (the
    first one major), as DTensor does.  No communication: every rank
    holds `full`."""
    out = full
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(mdim)
            step = out.shape[pl.dim] // n
            out = out.narrow(pl.dim, mesh.get_local_rank(mdim) * step, step)
    return out


def distribute(full, mesh, placements):
    """A DTensor of `full` (the same on every rank) under `placements`,
    built from each rank's own piece without communication."""
    return DTensor.from_local(
        local_piece(full, mesh, placements).contiguous(), mesh,
        placements, run_check=False, shape=full.shape,
        stride=full.contiguous().stride())


def relayout(x, want):
    """DTensor x redistributed to `want`, whose gradient goes back in x's
    layout with a pending sum (`Partial`) read as `Replicate`: the
    gradient of a summed value is the same on every rank that held a
    piece of it.  (DTensor's own backward would hand back a `Partial`
    gradient, which the products before it then keep by gathering their
    weights over the model axis.)"""
    return _Relayout.apply(x, tuple(want))


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, want):
        ctx.back = [Replicate() if isinstance(p, Partial) else p
                    for p in x.placements]
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != ctx.back:
            g = g.redistribute(g.device_mesh, ctx.back)
        return g, None


# ---------------------------------------------------------------------------
# Activation-constraint context
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[ShardingRules] = None):
    """Within this context, models' ashard() calls redistribute a DTensor
    activation to the activation rule's placements, and decode dispatch
    sees the mesh."""
    rules = rules or make_rules(mesh)

    def shard_fn(x, logical):
        if not isinstance(x, DTensor):
            return x
        want = rules.placements(rules.act_spec(x.shape, logical))
        if tuple(x.placements) == want:
            return x
        return relayout(x, want)

    def spec_zeros(spec, device):
        ps = rules.weight_spec(spec.shape, spec.logical)
        local = torch.zeros(rules.local_shape(spec.shape, ps),
                            dtype=dtype_of(spec.dtype), device=device)
        return DTensor.from_local(local, mesh, rules.placements(ps),
                                  run_check=False)

    set_activation_sharder(shard_fn, spec_zeros)
    tfm.set_current_mesh(mesh)
    try:
        yield rules
    finally:
        set_activation_sharder(None)
        tfm.set_current_mesh(None)
