"""Top-level model API: one entry point per lifecycle stage.

The port of `repro.models.model` for every family (dense, MoE, VLM,
zamba2, xLSTM, whisper):

    param_specs(cfg)             -> ParamSpec tree (shapes + logical axes)
    init_params(cfg, seed)       -> ParamTree on a device (random weights)
    forward_logits(cfg, p, tok)  -> (logits, aux), full sequence
    forward_train(cfg, p, batch) -> (loss, metrics), differentiable
    prefill(cfg, p, batch)       -> (last-token logits, decode cache)
    decode_step(cfg, p, tok, pos, cache) -> (logits, cache)
    cache_specs / init_cache     -> decode cache (specs / real)
    abstract_params / abstract_cache / input_specs
                                 -> meta tensors for the dry run
    logical_axes(cfg)            -> the logical axis names of each param

Tokens are integer tensors on the params' device (whisper's `frames`
too: (B, n_frames, d_model)); `pos` is a Python int.  A decode step
writes the cache in place and returns it.  Serving runs under
`torch.inference_mode()`; training differentiates `forward_train` with
autograd (`repro_torch.training.train_loop`) on a ParamTree made
trainable with `requires_grad_(True)`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (ParamTree, abstract_from_specs,
                                       apply_norm, ashard, count_specs,
                                       dtype_of, embed_specs, embed_tokens,
                                       init_from_specs, local_range,
                                       logical_axes_tree, norm_specs, relaid,
                                       sharded_only, stack_specs, unembed,
                                       unembed_specs, zeros_from_specs)
from repro_torch.sharding.rules import relayout


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


def abstract_params(cfg: ModelConfig):
    """The params as meta tensors (shapes and dtypes, no allocation)."""
    return abstract_from_specs(param_specs(cfg), cfg.param_dtype)


def logical_axes(cfg: ModelConfig):
    return logical_axes_tree(param_specs(cfg))


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
        x, _, aux = tfm.xlstm_stack_apply(cfg, params["stack"], x, None,
                                          collect=False)
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
    x = ashard(x, "batch", "seq", "embed")
    if cfg.is_encdec:
        enc_out = tfm.whisper_encode(cfg, params, frames)
        x, _, aux = tfm.whisper_decode_train(cfg, params, enc_out, x,
                                             positions, impl=impl)
    else:
        x, aux = _trunk_train(cfg, params, x, positions, impl)
    return _logits(cfg, params, x), aux


def cross_entropy(cfg, logits, targets):
    """logits: (B, S, Vp) any float dtype; targets: (B, S) int.  Returns
    (mean loss, logz (B, S)), both in float32; padded vocab ids are
    masked to -1e30 first."""
    if isinstance(logits, DTensor):
        # its gradient comes back in its own layout: DTensor's backward
        # of the vocab-parallel log-sum-exp would cut it over the
        # sequence, and the unembedding's backward would then gather the
        # vocab on every model rank
        logits = relayout(logits, logits.placements)
    logits = _mask_padded_vocab(cfg, logits.to(torch.float32))
    logz = _logsumexp(logits)
    return (logz - _gold(logits, targets)).mean(), logz


def _logsumexp(logits):
    """logsumexp over the last dim.  For DTensor logits whose vocab is
    sharded: max and sum over each rank's slice, reduced over the ranks
    (DTensor's `logsumexp` would gather the whole vocab first)."""
    if not (isinstance(logits, DTensor)
            and Shard(logits.ndim - 1) in logits.placements):
        return torch.logsumexp(logits, dim=-1)
    m = logits.detach().amax(-1, keepdim=True)
    return (logits - m).exp().sum(-1).log() + m[..., 0]


def _gold(logits, targets):
    """logits[b, s, targets[b, s]].  For DTensor logits with the vocab
    sharded, each rank picks the targets that fall in its vocab slice
    and the pieces sum over the ranks (a `Partial` result)."""
    if not isinstance(logits, DTensor):
        return logits.gather(-1, targets[..., None].long())[..., 0]
    logits = sharded_only(logits, (0, 2))
    targets = relaid(targets, logits.device_mesh, [
        pl if pl == Shard(0) else Replicate() for pl in logits.placements])
    vocab = local_range(logits, 2)
    local = logits.to_local()
    t = targets.to_local().long() - vocab.start
    hit = (t >= 0) & (t < len(vocab))
    g = local.gather(-1, t.clamp(0, len(vocab) - 1)[..., None])[..., 0]
    g = torch.where(hit, g, torch.zeros((), dtype=g.dtype, device=g.device))
    out = [Partial() if pl == Shard(2) else pl for pl in logits.placements]
    return DTensor.from_local(g, logits.device_mesh, out, run_check=False)


def forward_train(cfg, params, batch, impl="flash", aux_weight=0.01,
                  z_weight=0.0):
    """Next-token LM loss.  batch: {"tokens": (B, S)[, "frames":
    (B, F, D)]}.  Returns (total loss, metrics): the cross-entropy of
    logits[:, :-1] against tokens[:, 1:], plus aux_weight x the MoE
    load-balance loss and z_weight x mean(logz[:, :-1] ** 2); metrics
    `loss` (the cross-entropy), `aux_loss` and `tokens` (B x (S - 1))."""
    tokens = batch["tokens"]
    logits, aux = forward_logits(cfg, params, tokens,
                                 frames=batch.get("frames"), impl=impl)
    loss, logz = cross_entropy(cfg, logits[:, :-1], tokens[:, 1:])
    total = loss + aux_weight * aux
    if z_weight:
        total = total + z_weight * logz[:, :-1].square().mean()
    metrics = {"loss": loss, "aux_loss": aux,
               "tokens": tokens.shape[0] * (tokens.shape[1] - 1)}
    return total, metrics


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
    x = ashard(x, "batch", "seq", "embed")
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


def abstract_cache(cfg, batch: int, max_len: int):
    return abstract_from_specs(cache_specs(cfg, batch, max_len))


# ---------------------------------------------------------------------------
# Dry-run input specs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell: tokens
    (and whisper's frames) for train and prefill; for decode one new
    token, its position (an int32 scalar) and a cache of size S."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        out = {"tokens": meta((B, S), i32)}
        if cfg.is_encdec:
            out["frames"] = meta((B, cfg.n_frames, cfg.d_model),
                                 dtype_of(cfg.compute_dtype))
        return out
    return {"token": meta((B,), i32), "pos": meta((), i32),
            "cache": abstract_cache(cfg, B, S)}
