"""Top-level model API: one entry point per lifecycle stage.

The port of `repro.models.model` for every family (dense, MoE, VLM,
zamba2, xLSTM, whisper):

    param_specs(cfg)             -> ParamSpec tree (shapes + logical axes)
    init_params(cfg, seed)       -> ParamTree on a device (random weights)
    forward_logits(cfg, p, tok)  -> (logits, aux), full sequence
    prefill(cfg, p, batch)       -> (last-token logits, decode cache)
    decode_step(cfg, p, tok, pos, cache) -> (logits, cache)
    cache_specs / init_cache     -> decode cache (specs / real)

Tokens are integer tensors on the params' device (whisper's `frames`
too: (B, n_frames, d_model)); `pos` is a Python int.  A decode step
writes the cache in place and returns it.  Run under
`torch.inference_mode()`: nothing here needs gradients.  Training
(`forward_train`, `cross_entropy`) is not ported yet.
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
                                       stack_specs, unembed, unembed_specs,
                                       zeros_from_specs)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def _is_zamba(cfg) -> bool:
    return cfg.ssm is not None and bool(cfg.attn_every)


def param_specs(cfg: ModelConfig):
    sp: Dict[str, Any] = {
        "embed": embed_specs(cfg),
        "final_norm": norm_specs(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        sp["unembed"] = unembed_specs(cfg)
    if cfg.is_encdec:
        sp.update(tfm.whisper_specs(cfg))
    elif cfg.xlstm is not None:
        sp["stack"] = tfm.xlstm_stack_specs(cfg)
    elif _is_zamba(cfg):
        sp["stack"] = tfm.zamba_stack_specs(cfg)
    else:
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
    total = count_specs(param_specs(cfg))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        total -= (cfg.n_layers * 3 * (m.num_experts - m.top_k)
                  * cfg.d_model * m.expert_d_ff)
    return total


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


def _trunk_train(cfg, params, x, positions, impl):
    """Shared trunk: stacked blocks, train shape.  Returns (x, aux)."""
    if cfg.xlstm is not None:
        x, _, aux = tfm.xlstm_stack_apply(cfg, params["stack"], x, None)
    elif _is_zamba(cfg):
        x, _, aux = tfm.zamba_stack_train(cfg, params["stack"], x, positions,
                                          impl=impl, collect=False)
    else:
        x, _, aux = tfm.uniform_stack_train(cfg, params["stack"], x,
                                            positions, impl=impl)
    return x, aux


def forward_logits(cfg, params, tokens, frames=None, impl="flash"):
    """Full-sequence logits (train shape). Returns (logits, aux)."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(cfg, params["embed"], tokens,
                     positions if cfg.learned_pos else None)
    if cfg.is_encdec:
        enc_out = tfm.whisper_encode(cfg, params, frames)
        x, _, aux = tfm.whisper_decode_train(cfg, params, enc_out, x,
                                             positions, impl=impl)
    else:
        x, aux = _trunk_train(cfg, params, x, positions, impl)
    return _logits(cfg, params, x), aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill(cfg, params, batch, impl="flash", max_len=None):
    """Process the prompt; return (last-token logits, decode cache).

    batch: {"tokens": (B, S)[, "frames": (B, n_frames, d_model)]}.
    max_len sizes the KV caches (>= prompt length) so decode can continue
    past the prompt."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(cfg, params["embed"], tokens,
                     positions if cfg.learned_pos else None)
    if cfg.is_encdec:
        enc_out = tfm.whisper_encode(cfg, params, batch["frames"])
        x, cache, _ = tfm.whisper_decode_train(cfg, params, enc_out, x,
                                               positions, impl=impl,
                                               collect_kv=True,
                                               max_len=max_len)
    elif cfg.xlstm is not None:
        x, cache, _ = tfm.xlstm_stack_apply(cfg, params["stack"], x, None)
    elif _is_zamba(cfg):
        x, cache, _ = tfm.zamba_stack_train(cfg, params["stack"], x,
                                            positions, impl=impl,
                                            collect=True, max_len=max_len)
    else:
        x, cache, _ = tfm.uniform_stack_train(cfg, params["stack"], x,
                                              positions, impl=impl,
                                              collect_kv=True,
                                              max_len=max_len)
    logits = _logits(cfg, params, x[:, -1:])[:, 0]
    return _mask_padded_vocab(cfg, logits), cache


def decode_step(cfg, params, token, pos: int, cache):
    """One decode step. token: (B,) int; pos: position of the token being
    fed.  Returns (logits (B, Vp), cache), the cache written in place."""
    B = token.shape[0]
    pos_b = torch.full((B, 1), pos, device=token.device)
    x = embed_tokens(cfg, params["embed"], token[:, None],
                     pos_b if cfg.learned_pos else None)[:, 0]
    if cfg.is_encdec:
        x, cache, _ = tfm.whisper_stack_decode(cfg, params, x, pos, cache)
    elif cfg.xlstm is not None:
        x2, cache, _ = tfm.xlstm_stack_apply(cfg, params["stack"],
                                             x[:, None], cache)
        x = x2[:, 0]
    elif _is_zamba(cfg):
        x, cache, _ = tfm.zamba_stack_decode(cfg, params["stack"], x, pos,
                                             cache)
    else:
        x, cache, _ = tfm.uniform_stack_decode(cfg, params["stack"], x, pos,
                                               cache)
    logits = _logits(cfg, params, x[:, None])[:, 0]
    return _mask_padded_vocab(cfg, logits), cache


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def cache_specs(cfg, batch: int, max_len: int):
    dtype = dtype_of(cfg.compute_dtype)
    if cfg.is_encdec:
        return tfm.whisper_cache_specs(cfg, batch, max_len, dtype)
    if cfg.xlstm is not None:
        return tfm.xlstm_state_specs(cfg, batch)
    if _is_zamba(cfg):
        return tfm.zamba_cache_specs(cfg, batch, max_len, dtype)
    return stack_specs(attn_mod.kv_cache_specs(cfg, batch, max_len, dtype),
                       cfg.n_layers)


def init_cache(cfg, batch: int, max_len: int, *, device="cuda"):
    """Zero-initialized decode cache (for decode-from-scratch tests)."""
    return zeros_from_specs(cache_specs(cfg, batch, max_len),
                            device=resolve_device(device))
