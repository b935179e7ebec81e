"""Training step factory: grad-accum microbatching, remat, compression
(the port of `repro.training.train_loop`, on one device).

`make_train_step` returns step(params, opt_state, batch) -> (params,
opt_state, metrics).  The loss is `models.model.forward_train`; its
gradients come from autograd (`torch.autograd.grad` over the
ParamTree's leaves, so nothing is kept in `.grad`).  With
`accum_steps > 1` the batch is cut into that many microbatches along
its first dim, their gradients are summed in float32 and divided by
`accum_steps` (the reference's `lax.scan` over an f32 accumulator).
`compress_grads` passes the gradients through the int8 wire format.
`grad_norm` is measured after compression and before clipping.  The
optimizer updates params and its state in place.

`jit_train_step(cfg, opt, mesh, rules)` is the sharded step: the same
step on DTensors.  It keeps the reference's name; nothing is compiled.
It places params, m and v by the weight rules and the batch by the
activation rules (leaves already placed stay as they are) and runs the
step under `use_sharding`.  Autograd leaves a gradient `Partial` over
the ranks that computed pieces of it; each is brought to its
parameter's placements (an all-reduce or, under FSDP, a
reduce-scatter: what XLA places in the reference's compiled step)
before the norm, clipping and update, which then reduce over the mesh.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import model as M
from repro_torch.models.layers import ParamTree, relaid
from repro_torch.sharding.rules import (distribute, mesh_axes,
                                        spec_tree_shardings, use_sharding)
from repro_torch.training import compression
from repro_torch.training.optimizer import AdamW, AdamWState, global_norm
from repro_torch.training.trees import build, items


def make_loss_fn(cfg, impl: str = "flash"):
    def loss_fn(params, batch):
        return M.forward_train(cfg, params, batch, impl=impl)
    return loss_fn


def make_train_step(cfg, opt: AdamW, *, impl: str = "flash",
                    accum_steps: int = 1,
                    compress_grads: bool = False) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).
    params: a trainable `ParamTree` (`requires_grad_(True)`); batch:
    {"tokens": (B, S)[, "frames": (B, F, D)]} on its device."""
    loss_fn = make_loss_fn(cfg, impl)

    def grads_of(leaves, params, batch):
        total, metrics = loss_fn(params, batch)
        gs = torch.autograd.grad(total, leaves, allow_unused=True)
        return metrics, [torch.zeros_like(p) if g is None else _like(g, p)
                         for g, p in zip(gs, leaves)]

    def step(params, opt_state, batch):
        paths, leaves = zip(*items(params))
        if accum_steps == 1:
            metrics, gs = grads_of(leaves, params, batch)
            metrics = {k: v.detach() if torch.is_tensor(v) else v
                       for k, v in metrics.items()}
        else:
            B, S = batch["tokens"].shape
            if B % accum_steps:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"accum_steps {accum_steps}")
            mb = B // accum_steps
            gs, losses, auxes = None, [], []
            for i in range(accum_steps):
                sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                m, g = grads_of(leaves, params, sub)
                gs = ([x.to(torch.float32) for x in g] if gs is None
                      else [a + x for a, x in zip(gs, g)])
                losses.append(m["loss"].detach())
                auxes.append(m["aux_loss"].detach())
            gs = [g / accum_steps for g in gs]
            metrics = {"loss": torch.stack(losses).mean(),
                       "aux_loss": torch.stack(auxes).mean(),
                       "tokens": B * (S - 1)}
        grads = build(zip(paths, gs))
        del gs
        if compress_grads:
            grads = compression.int8_roundtrip(grads)
        metrics["grad_norm"] = global_norm(grads)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, metrics

    return step


def _like(g, p):
    """Gradient g laid out as its parameter p (a DTensor's pending sum
    reduced, FSDP's reduce-scatter); a plain g as it is."""
    return relaid(g, p.device_mesh, p.placements) if isinstance(
        g, DTensor) else g


def place_tree(tree, placements, mesh):
    """Every leaf of `tree` (a ParamTree or nested dicts) as a DTensor
    with the placements at its path in `placements`; a leaf that is a
    DTensor already stays.  A ParamTree comes back a ParamTree, its
    leaves as trainable as they were."""
    pls = dict(spec_leaves_of(placements))

    def one(path, t):
        if isinstance(t, DTensor):
            return t
        return distribute(t.detach(), mesh, pls[path])

    pairs = [(path, one(path, t)) for path, t in items(tree)]
    if not isinstance(tree, ParamTree):
        return build(pairs)
    out = ParamTree(build(pairs))
    grad = {path: t.requires_grad for path, t in items(tree)}
    for path, t in items(out):
        t.requires_grad_(grad[path])
    return out


def spec_leaves_of(tree, prefix=()):
    """(key path, placements) of a nested dict whose leaves are tuples
    of placements."""
    if isinstance(tree, tuple):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from spec_leaves_of(tree[k], prefix + (k,))


def jit_train_step(cfg, opt: AdamW, mesh, rules, **kw):
    """The sharded step (params, opt_state, batch) -> (params, opt_state,
    metrics) on `mesh` under `rules`: `make_train_step(cfg, opt, **kw)`
    on DTensors.  Params, m and v are placed by the weight rules, the
    batch by the activation rules; returned params and state stay
    placed.  Metrics are DTensors (`.full_tensor()` reads one)."""
    step = make_train_step(cfg, opt, **kw)
    pshard = spec_tree_shardings(rules, M.param_specs(cfg))
    ostate = AdamWState_shardings(opt, pshard, rules)

    def placed(params, opt_state, batch):
        params = place_tree(params, pshard, mesh)
        opt_state = AdamWState(opt_state.step,
                               place_tree(opt_state.m, ostate.m, mesh),
                               place_tree(opt_state.v, ostate.v, mesh))
        batch = place_batch(batch, mesh, rules)
        with use_sharding(mesh, rules), implicit_replication():
            return step(params, opt_state, batch)

    return placed


def place_batch(batch, mesh, rules):
    """tokens (B, S) by the ("batch", "seq") rule, frames (B, F, D) by
    ("batch", "seq", "embed"); placed leaves stay."""
    logical = {"tokens": ("batch", "seq"), "token": ("batch",),
               "frames": ("batch", "seq", "embed")}
    return {k: v if isinstance(v, DTensor) else distribute(
        v, mesh, rules.placements(rules.act_spec(v.shape, logical[k])))
        for k, v in batch.items()}


def AdamWState_shardings(opt, param_shardings, rules):
    """The optimizer state's placements: m and v as the params, the step
    (a host int) replicated."""
    step = tuple(Replicate() for _ in mesh_axes(rules.mesh))
    return AdamWState(step, param_shardings, param_shardings)
