"""Block assembly for the dense (uniform) decoder stack.

The port of `repro.models.transformer` for the attention + MLP block.
The reference scans over stacked layer params (``lax.scan``, optional
remat); here a plain loop takes layer i's views of the same stacked
tensors.  There is no remat: the port runs inference.  The MoE, Mamba2,
xLSTM, zamba2 and whisper stacks are not ported yet.

Block contract: body(x, p, c) -> (x_out, new_cache, aux), aux a scalar
(the MoE load-balance loss, 0 for the MLP block).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_specs,
                                       norm_specs, stack_specs, take)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet")


# ---------------------------------------------------------------------------
# Attention (+MLP) block
# ---------------------------------------------------------------------------


def attn_block_specs(cfg, use_moe: bool = False, cross: bool = False):
    if use_moe:
        raise _not_ported("the MoE FFN (models/moe.py)")
    if cross:
        raise _not_ported("cross-attention (whisper)")
    sp = {"ln1": norm_specs(cfg, cfg.d_model),
          "attn": attn.attn_specs(cfg),
          "ln2": norm_specs(cfg, cfg.d_model)}
    if cfg.d_ff:
        sp["mlp"] = mlp_specs(cfg, cfg.d_model, cfg.d_ff)
    return sp


def _ffn(cfg, p, x):
    """Second half-block: norm + mlp + residual. Returns (x, aux)."""
    if "moe" in p:
        raise _not_ported("the MoE FFN (models/moe.py)")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mlp" in p:
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, aux


def attn_block_train(cfg, p, x, positions, *, impl="flash", causal=True):
    """Train/prefill-shaped attention block. Returns (x, kv, aux)."""
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = attn.project_qkv(cfg, p["attn"], h, positions)
    if causal:
        o = attn.self_attention(cfg, q, k, v, positions, positions, impl=impl)
    else:
        o = attn.attn_full(q, k, v, positions, positions, causal=False)
    x = x + attn.out_proj(cfg, p["attn"], o)
    x, aux = _ffn(cfg, p, x)
    return x, (k, v), aux


def attn_block_decode(cfg, p, x, pos: int, cache):
    """One-token attention block. x: (B, D). cache: {"k","v"} of this
    layer, written in place."""
    h = apply_norm(cfg, p["ln1"], x)[:, None]            # (B,1,D)
    pos_arr = torch.full((1,), pos, device=x.device)
    q, k, v = attn.project_qkv(cfg, p["attn"], h, pos_arr)
    o, new_cache = attn.decode_attention(cfg, cache, q[:, 0], k[:, 0],
                                         v[:, 0], pos)
    x = x + attn.out_proj(cfg, p["attn"], o[:, None])[:, 0]
    x2, aux = _ffn(cfg, p, x[:, None])
    return x2[:, 0], new_cache, aux


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def scan_stack(cfg, body, x, stacked_params, stacked_cache=None):
    """Run body(x, p, c) -> (x, new_c, aux) over the layer dim, layer i
    reading views of the stacked params (and cache).  Returns (x,
    stacked_cache, aux summed)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        c = None if stacked_cache is None else take(stacked_cache, i)
        x, _, a = body(x, take(stacked_params, i), c)
        aux = aux + a
    return x, stacked_cache, aux


def uniform_stack_specs(cfg):
    block = attn_block_specs(cfg, use_moe=cfg.moe is not None)
    return stack_specs(block, cfg.n_layers)


def uniform_stack_train(cfg, params, x, positions, *, impl="flash",
                        collect_kv=False, max_len=None):
    """Returns (x, stacked kv cache or None, aux).  With collect_kv the
    cache (layers first, `max_len` slots, x's dtype) is filled as each
    layer runs."""
    cache = None
    if collect_kv:
        ml = max_len or positions.shape[0]
        shape = (cfg.n_layers, x.shape[0], attn.cache_window(cfg, ml),
                 cfg.n_kv_heads, cfg.head_dim)
        cache = {n: torch.zeros(shape, dtype=x.dtype, device=x.device)
                 for n in ("k", "v")}

    def body(x, p, c):
        x, kv, aux = attn_block_train(cfg, p, x, positions, impl=impl)
        if c is not None:
            attn.fill_kv_cache(cfg, c, kv[0], kv[1])
        return x, c, aux

    return scan_stack(cfg, body, x, params, cache)


def uniform_stack_decode(cfg, params, x, pos: int, cache):
    def body(x, p, c):
        return attn_block_decode(cfg, p, x, pos, c)

    return scan_stack(cfg, body, x, params, cache)
