"""End-to-end training driver (the port of `repro.launch.train`).

Runs any registry arch (or its reduced config on the CPU) through the
production loop on one device: grad-accum, async atomic checkpoints,
resume from LATEST, heartbeats, straggler monitoring, an optional GEE
embedding init (the scatter kernel on a card) and int8 gradient
compression.  On a card every causal self-attention's forward is the
flash kernel; its backward is plain autograd.  Batches are the
reference's `SyntheticTokens` bit for bit; whisper's frames come from
``np.random.default_rng(step)`` as in the reference.  The reference's
mesh and sharding rules have no counterpart yet (one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --reduced --device cpu --steps 20 --batch 4 --seq 64

Without ``--device cpu`` it runs on the card (and raises without one).
`run` is the loop itself, taking the initial `ParamTree`, so a caller
can start it from weights of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CK
from repro_torch.training.fault_tolerance import Heartbeat, StragglerMonitor
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_loop import make_train_step


def build_batch_fn(cfg, args, device):
    """step -> the batch of that step on `device`."""
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    src = SyntheticTokens(data_cfg)

    def get(step):
        b = {"tokens": torch.as_tensor(src.batch(step), device=device)}
        if cfg.is_encdec:
            rng = np.random.default_rng(step)
            b["frames"] = torch.as_tensor(rng.normal(
                0, 1, (args.batch, cfg.n_frames, cfg.d_model)
            ).astype(np.float32), device=device)
        return b
    return get


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving small config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--gee-embed-init", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def config_of(args):
    """The arch's config as the reference's driver builds it (reduced
    configs without remat)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), remat=False)
    return cfg


def run(cfg, params, args) -> Dict[str, Any]:
    """The training loop from the `ParamTree` `params` (on the device it
    runs on) and parsed `args`.  Returns {"losses", "grad_norms",
    "step_s" (host seconds a step, the device synchronized), "start"
    (the first step run), "params", "opt_state"}."""
    device = next(iter(params.parameters())).device
    opt = AdamW(lr=args.lr, state_dtype=cfg.state_dtype,
                schedule=cosine_schedule(warmup=20, total=args.steps))
    get_batch = build_batch_fn(cfg, args, device)
    step_fn = make_train_step(cfg, opt, accum_steps=args.accum_steps,
                              compress_grads=args.compress_grads)

    if args.gee_embed_init:
        from repro_torch.encoder.bridge import gee_embedding_init
        stream = np.concatenate(
            [get_batch(s)["tokens"].cpu().numpy().reshape(-1)
             for s in range(4)])
        table = gee_embedding_init(stream, cfg.padded_vocab, cfg.d_model,
                                   device=device)
        with torch.no_grad():
            params["embed"]["tokens"].copy_(torch.as_tensor(table))
        print("[train] GEE co-occurrence embedding init applied")
    params.requires_grad_(True)
    opt_state = opt.init(params)

    start = 0
    ck = hb = None
    if args.ckpt_dir:
        ck = CK.AsyncCheckpointer(args.ckpt_dir)
        if CK.latest_step(args.ckpt_dir) is not None:
            (params, opt_state), start = CK.restore_checkpoint(
                args.ckpt_dir, (params, opt_state))
            params.requires_grad_(True)
            print(f"[train] resumed from step {start}")
        hb = Heartbeat(args.ckpt_dir)
    mon = StragglerMonitor()

    hist: Dict[str, Any] = {"losses": [], "grad_norms": [], "step_s": [],
                            "start": start}
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = get_batch(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        _sync(device)
        dt = time.perf_counter() - t0
        mon.record(step, dt)
        hist["losses"].append(loss)
        hist["grad_norms"].append(gnorm)
        hist["step_s"].append(dt)
        if ck is not None:
            hb.beat(step)
            if (step + 1) % args.ckpt_every == 0:
                ck.save(step + 1, (params, opt_state))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {gnorm:8.3f} dt {dt * 1e3:7.1f}ms")

    if ck is not None:
        ck.save(args.steps, (params, opt_state))
        ck.close()
    if mon.straggler_steps:
        print(f"[train] stragglers: {mon.straggler_steps}")
    if hist["losses"]:
        print(f"[train] first loss {hist['losses'][0]:.4f} last "
              f"{hist['losses'][-1]:.4f}")
    hist.update(params=params, opt_state=opt_state)
    return hist


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_of(args)
    params = M.init_params(cfg, args.seed, device=device)
    return run(cfg, params, args)["losses"]


if __name__ == "__main__":
    main()
