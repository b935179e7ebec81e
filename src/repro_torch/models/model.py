"""Top-level model API: one entry point per lifecycle stage.

The port of `repro.models.model` for the dense (uniform) decoder stack:

    param_specs(cfg)             -> ParamSpec tree (shapes + logical axes)
    init_params(cfg, seed)       -> ParamTree on a device (random weights)
    forward_logits(cfg, p, tok)  -> (logits, aux), full sequence
    prefill(cfg, p, batch)       -> (last-token logits, decode cache)
    decode_step(cfg, p, tok, pos, cache) -> (logits, cache)
    cache_specs / init_cache     -> decode cache (specs / real)

The MoE, SSM, xLSTM, zamba2 and whisper families raise
`NotImplementedError` (not ported yet).  Tokens are integer tensors on
the params' device; `pos` is a Python int.  Run under
`torch.inference_mode()`: nothing here needs gradients.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (ParamTree, apply_norm, count_specs,
                                       dtype_of, embed_specs, embed_tokens,
                                       init_from_specs, norm_specs,
                                       stack_specs, unembed, unembed_specs)


def require_dense(cfg: ModelConfig) -> None:
    """Raise for the families the port does not run yet."""
    for what, present in (("encoder-decoder (whisper)", cfg.is_encdec),
                          ("xLSTM", cfg.xlstm is not None),
                          ("SSM / zamba2", cfg.ssm is not None),
                          ("MoE", cfg.moe is not None)):
        if present:
            raise NotImplementedError(f"{cfg.name}: the {what} family is "
                                      "not ported yet")


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig):
    require_dense(cfg)
    sp: Dict[str, Any] = {
        "embed": embed_specs(cfg),
        "final_norm": norm_specs(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        sp["unembed"] = unembed_specs(cfg)
    sp["stack"] = tfm.uniform_stack_specs(cfg)
    return sp


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> ParamTree:
    """Random weights from `seed`, drawn on `device` (a CUDA device
    without a card raises)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_from_specs(param_specs(cfg), gen, cfg.param_dtype,
                           device=device)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    return count_specs(param_specs(cfg))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _logits(cfg, params, x):
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"]["tokens"].to(x.dtype).T
    return unembed(cfg, params["unembed"], x)


def _mask_padded_vocab(cfg, logits):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    ids = torch.arange(cfg.padded_vocab, device=logits.device)
    return logits.masked_fill(ids >= cfg.vocab, -1e30)


def forward_logits(cfg, params, tokens, impl="flash"):
    """Full-sequence logits (train shape). Returns (logits, aux)."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(cfg, params["embed"], tokens,
                     positions if cfg.learned_pos else None)
    x, _, aux = tfm.uniform_stack_train(cfg, params["stack"], x, positions,
                                        impl=impl)
    return _logits(cfg, params, x), aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill(cfg, params, batch, impl="flash", max_len=None):
    """Process the prompt; return (last-token logits, decode cache).

    max_len sizes the KV caches (>= prompt length) so decode can continue
    past the prompt."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(cfg, params["embed"], tokens,
                     positions if cfg.learned_pos else None)
    x, cache, _ = tfm.uniform_stack_train(cfg, params["stack"], x,
                                          positions, impl=impl,
                                          collect_kv=True, max_len=max_len)
    logits = _logits(cfg, params, x[:, -1:])[:, 0]
    return _mask_padded_vocab(cfg, logits), cache


def decode_step(cfg, params, token, pos: int, cache):
    """One decode step. token: (B,) int; pos: position of the token being
    fed.  Returns (logits (B, Vp), cache), the cache written in place."""
    B = token.shape[0]
    pos_b = torch.full((B, 1), pos, device=token.device)
    x = embed_tokens(cfg, params["embed"], token[:, None],
                     pos_b if cfg.learned_pos else None)[:, 0]
    x, cache, _ = tfm.uniform_stack_decode(cfg, params["stack"], x, pos,
                                           cache)
    logits = _logits(cfg, params, x[:, None])[:, 0]
    return _mask_padded_vocab(cfg, logits), cache


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def cache_specs(cfg, batch: int, max_len: int):
    require_dense(cfg)
    dtype = dtype_of(cfg.compute_dtype)
    return stack_specs(attn_mod.kv_cache_specs(cfg, batch, max_len, dtype),
                       cfg.n_layers)


def init_cache(cfg, batch: int, max_len: int, *, device="cuda"):
    """Zero-initialized decode cache (for decode-from-scratch tests)."""
    device = resolve_device(device)
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in cache_specs(cfg, batch, max_len).items()}
