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

The reference's `jit_train_step` and `AdamWState_shardings` need a
device mesh and sharding rules; they come with the port's
`torch.distributed` path.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import model as M
from repro_torch.training import compression
from repro_torch.training.optimizer import AdamW, global_norm
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
        return metrics, [torch.zeros_like(p) if g is None else g
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
