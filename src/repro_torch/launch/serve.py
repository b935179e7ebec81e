"""Batched LM serving driver: prefill + greedy decode.

The port of `repro.launch.serve`: the batch of prompts is prefilled once,
then decoded greedily token by token with the shared decode cache (KV
caches, SSM / xLSTM states).  Weights are random, drawn on the device
from ``--seed``; the encoder-decoder (whisper) also gets random frame
embeddings (B, n_frames, d_model) from the seed, as the reference draws
them.  On a card the prefill's causal self-attention runs the
hand-written flash-attention kernel.  ``--arch`` takes every id of
`repro_torch.configs.list_archs()`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts: torch.Tensor, gen: int, *,
             frames: Optional[torch.Tensor] = None,
             timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Greedy continuation of `prompts` (B, S) int on the params' device:
    one prefill, then gen - 1 decode steps.  `frames`: the encoder's
    input (B, n_frames, d_model) for an encoder-decoder.  Returns
    (B, gen) int64 tokens.  With `timings`, records ``prefill_s`` and
    ``decode_s`` (host clock, the device synchronized)."""
    S = prompts.shape[1]
    dev = prompts.device
    batch = {"tokens": prompts}
    if cfg.is_encdec:
        batch["frames"] = frames
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = M.prefill(cfg, params, batch, max_len=S + gen)
        toks = logits.argmax(-1)
        _sync(dev)
        t1 = time.perf_counter()
        out = [toks]
        for i in range(gen - 1):
            logits, cache = M.decode_step(cfg, params, toks, S + i, cache)
            toks = logits.argmax(-1)
            out.append(toks)
        _sync(dev)
        t2 = time.perf_counter()
    if timings is not None:
        timings.update(prefill_s=t1 - t0, decode_s=t2 - t1)
    return torch.stack(out, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="any id of repro_torch.configs.list_archs()")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    B, S, G = args.batch, args.prompt_len, args.gen
    prompts = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    frames = None
    if cfg.is_encdec:
        frames = torch.as_tensor(rng.normal(
            0, 1, (B, cfg.n_frames, cfg.d_model)).astype(np.float32),
            device=device)
    params = M.init_params(cfg, args.seed, device=device)

    t: Dict[str, float] = {}
    gen = generate(cfg, params, torch.as_tensor(prompts, device=device), G,
                   frames=frames, timings=t)
    gen = gen.cpu().numpy()
    t_prefill, t_decode = t["prefill_s"], t["decode_s"]
    print(f"[serve] arch={cfg.name} batch={B} prompt={S} gen={G} "
          f"device={device}")
    print(f"[serve] prefill {t_prefill*1e3:9.1f} ms "
          f"({B*S/max(t_prefill,1e-9):,.0f} tok/s)")
    print(f"[serve] decode  {t_decode*1e3:9.1f} ms "
          f"({B*(G-1)/max(t_decode,1e-9):,.0f} tok/s)")
    print(f"[serve] sample continuation[0]: {gen[0][:12].tolist()}")
    return gen


if __name__ == "__main__":
    main()
