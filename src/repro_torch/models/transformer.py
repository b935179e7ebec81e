"""Block assembly for every architecture family.

The port of `repro.models.transformer`.  The reference scans over
stacked layer params (``lax.scan``, optional remat); here a plain loop
takes layer i's views of the same stacked tensors.  Remat is the
reference's too: with `cfg.remat` and grad enabled, each layer's body
runs under `torch.utils.checkpoint` (non-reentrant), so its activations
are recomputed in the backward pass instead of kept.

Block contract (uniform across attn / moe / mamba / mlstm / slstm):

    body(x, p, c) -> (x_out, new_cache, aux)

where `c` is this layer's view of the stacked cache (None without one)
and aux is a scalar (MoE load-balance loss, 0 elsewhere).  JAX returns
new caches; the port writes each layer's new cache into its view of the
stacked one, in place, and returns the stacked cache.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (ParamSpec, apply_mlp, apply_norm,
                                       dtype_of, mlp_specs, norm_specs,
                                       stack_specs, take, zeros_from_specs)


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _write(dst, src):
    """Copy a nested dict of tensors into `dst`'s views, in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write(dst[k], v)
        else:
            dst[k].copy_(v)


# ---------------------------------------------------------------------------
# Attention (+MLP / +MoE) block
# ---------------------------------------------------------------------------


def attn_block_specs(cfg, use_moe: bool = False, cross: bool = False):
    sp = {"ln1": norm_specs(cfg, cfg.d_model),
          "attn": attn.attn_specs(cfg),
          "ln2": norm_specs(cfg, cfg.d_model)}
    if cross:
        sp["lnx"] = norm_specs(cfg, cfg.d_model)
        sp["xattn"] = attn.attn_specs(cfg, cross=True)
    if use_moe:
        sp["moe"] = moe_mod.moe_specs(cfg)
    elif cfg.d_ff:
        sp["mlp"] = mlp_specs(cfg, cfg.d_model, cfg.d_ff)
    return sp


def _ffn(cfg, p, x):
    """Second half-block: norm + (moe|mlp) + residual. Returns (x, aux)."""
    aux = _zero(x)
    if "moe" in p:
        h = apply_norm(cfg, p["ln2"], x)
        aux = moe_mod.aux_load_balance_loss(cfg, p["moe"], h)
        x = x + moe_mod.apply_moe(cfg, p["moe"], h)
    elif "mlp" in p:
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, aux


def encoder_kv(p, enc_out):
    """The decoder block's cross-attention k, v of the encoder's output:
    (B, F, KV, Dh) each."""
    return {n: torch.einsum("bfd,dhk->bfhk", enc_out,
                            p["xattn"][w].to(enc_out.dtype))
            for n, w in (("k", "wk"), ("v", "wv"))}


def self_attn_train(cfg, p, x, positions, *, impl="flash", causal=True):
    """The block's first half: x + self-attention(norm(x)), where prefill
    reaches the kernel.  Returns (x, (k, v))."""
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = attn.project_qkv(cfg, p["attn"], h, positions)
    if causal:
        o = attn.self_attention(cfg, q, k, v, positions, positions, impl=impl)
    else:
        o = attn.attn_full(q, k, v, positions, positions, causal=False)
    return x + attn.out_proj(cfg, p["attn"], o), (k, v)


def self_attn_decode(cfg, p, x, pos: int, cache):
    """The decode form of `self_attn_train`. x: (B, D); cache: {"k","v"}
    of this layer, written in place.  Returns (x, cache)."""
    h = apply_norm(cfg, p["ln1"], x)[:, None]            # (B,1,D)
    pos_arr = torch.full((1,), pos, device=x.device)
    q, k, v = attn.project_qkv(cfg, p["attn"], h, pos_arr)
    o, cache = attn.decode_attention(cfg, cache, q[:, 0], k[:, 0], v[:, 0],
                                     pos)
    return x + attn.out_proj(cfg, p["attn"], o[:, None])[:, 0], cache


def block_tail(cfg, p, x, positions, *, enc_kv=None):
    """The block's second half: cross-attention on the encoder's k/v
    (whisper's decoder), then norm + (moe|mlp), each with its residual.
    x: (B, S, D).  Returns (x, aux)."""
    if enc_kv is not None:
        h = apply_norm(cfg, p["lnx"], x)
        qx, _, _ = attn.project_qkv(cfg, p["xattn"], h, positions, rope=False)
        ox = attn.cross_attention(cfg, qx, enc_kv["k"], enc_kv["v"])
        x = x + attn.out_proj(cfg, p["xattn"], ox)
    return _ffn(cfg, p, x)


def attn_block_train(cfg, p, x, positions, *, impl="flash", causal=True,
                     enc_out=None):
    """Train/prefill-shaped attention block. Returns (x, kv, aux)."""
    x, kv = self_attn_train(cfg, p, x, positions, impl=impl, causal=causal)
    x, aux = block_tail(cfg, p, x, positions, enc_kv=None if enc_out is None
                        else encoder_kv(p, enc_out))
    return x, kv, aux


def attn_block_decode(cfg, p, x, pos: int, cache, *, cross_kv=None):
    """One-token attention block. x: (B, D). cache: {"k","v"} of this
    layer, written in place; cross_kv: this layer's encoder k/v."""
    x, cache = self_attn_decode(cfg, p, x, pos, cache)
    x2, aux = block_tail(cfg, p, x[:, None],
                         torch.full((1,), pos, device=x.device),
                         enc_kv=cross_kv)
    return x2[:, 0], cache, aux


# ---------------------------------------------------------------------------
# Mamba2 / mLSTM / sLSTM blocks (pre-norm + residual)
# ---------------------------------------------------------------------------


def mamba_block_specs(cfg):
    return {"ln": norm_specs(cfg, cfg.d_model), "ssm": ssm_mod.ssm_specs(cfg)}


def mamba_block(cfg, p, x, state=None):
    h = apply_norm(cfg, p["ln"], x)
    out, new_state = ssm_mod.apply_ssm(cfg, p["ssm"], h, state)
    return x + out, new_state


def mlstm_block_specs(cfg):
    return {"ln": norm_specs(cfg, cfg.d_model),
            "mlstm": xlstm_mod.mlstm_specs(cfg)}


def mlstm_block(cfg, p, x, state=None):
    h = apply_norm(cfg, p["ln"], x)
    out, new_state = xlstm_mod.apply_mlstm(cfg, p["mlstm"], h, state)
    return x + out, new_state


def slstm_block_specs(cfg):
    return {"ln": norm_specs(cfg, cfg.d_model),
            "slstm": xlstm_mod.slstm_specs(cfg)}


def slstm_block(cfg, p, x, state=None):
    h = apply_norm(cfg, p["ln"], x)
    out, new_state = xlstm_mod.apply_slstm(cfg, p["slstm"], h, state)
    return x + out, new_state


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def depth(stacked) -> int:
    """Layers of a stacked tree: the leading dim of its first leaf."""
    while not torch.is_tensor(stacked):
        stacked = stacked[next(iter(stacked.keys()))]
    return stacked.shape[0]


def scan_stack(cfg, body, x, stacked_params, stacked_cache=None):
    """Run body(x, p, c) -> (x, new_c, aux) over the layer dim, layer i
    reading views of the stacked params (and cache).  Returns (x,
    stacked_cache, aux summed).  With `cfg.remat` and grad enabled each
    call of `body` is checkpointed (the reference's `_maybe_remat`)."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = _zero(x)
    for i in range(depth(stacked_params)):
        c = None if stacked_cache is None else take(stacked_cache, i)
        p = take(stacked_params, i)
        if remat:
            x, _, a = checkpoint(body, x, p, c, use_reentrant=False)
        else:
            x, _, a = body(x, p, c)
        aux = aux + a
    return x, stacked_cache, aux


# ----- homogeneous decoder (dense / moe / vlm) ------------------------------


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
        kv = attn.kv_cache_specs(cfg, x.shape[0],
                                 max_len or positions.shape[0], x.dtype)
        cache = zeros_from_specs(stack_specs(kv, depth(params)),
                                 device=x.device)

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


# ----- xLSTM stack ----------------------------------------------------------


def xlstm_group_layout(cfg):
    """(n_groups, mlstm_per_group) — one sLSTM closes each group."""
    every = cfg.xlstm.slstm_every
    if cfg.n_layers % every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"slstm_every {every}")
    return cfg.n_layers // every, every - 1


def xlstm_stack_specs(cfg):
    g, m = xlstm_group_layout(cfg)
    group = {"mlstm": stack_specs(mlstm_block_specs(cfg), m, "inner"),
             "slstm": slstm_block_specs(cfg)}
    return stack_specs(group, g, "layers")


def xlstm_stack_apply(cfg, params, x, state=None, *, collect=True):
    """Prefill (state None: zero states consumed, states returned) and
    decode (state given, written in place).  Returns (x, state, aux).
    collect=False (training): every block starts from the zero state and
    nothing is written, so autograd never sees a state changed in place;
    the returned state is None."""
    if not collect:
        def group_fresh(x, p, _):
            def inner(x, ip, _c):
                return mlstm_block(cfg, ip, x)[0], None, _zero(x)

            x, _, _ = scan_stack(cfg, inner, x, p["mlstm"])
            return slstm_block(cfg, p["slstm"], x)[0], None, _zero(x)

        x, _, _ = scan_stack(cfg, group_fresh, x, params)
        return x, None, _zero(x)
    if state is None:
        state = xlstm_init_state(cfg, x.shape[0], device=x.device)

    def group_body(x, p, c):
        def inner(x, ip, ic):
            x, st = mlstm_block(cfg, ip, x, ic)
            _write(ic, st)
            return x, ic, _zero(x)

        x, _, _ = scan_stack(cfg, inner, x, p["mlstm"], c["mlstm"])
        x, s_state = slstm_block(cfg, p["slstm"], x, c["slstm"])
        _write(c["slstm"], s_state)
        return x, c, _zero(x)

    x, state, _ = scan_stack(cfg, group_body, x, params, state)
    return x, state, _zero(x)


def xlstm_state_specs(cfg, batch):
    g, m = xlstm_group_layout(cfg)
    group = {"mlstm": stack_specs(xlstm_mod.mlstm_state_specs(cfg, batch),
                                  m, "inner"),
             "slstm": xlstm_mod.slstm_state_specs(cfg, batch)}
    return stack_specs(group, g, "layers")


def xlstm_init_state(cfg, batch, *, device):
    """The states prefill starts from: every mLSTM's m at -1e30, the rest
    zero (`init_cache`'s zeros differ from it in m)."""
    g, m = xlstm_group_layout(cfg)

    def rep(t, n):
        return {k: rep(v, n) if isinstance(v, dict)
                else v.expand((n,) + v.shape).clone() for k, v in t.items()}

    group = {"mlstm": rep(xlstm_mod.init_mlstm_state(cfg, batch,
                                                     device=device), m),
             "slstm": xlstm_mod.init_slstm_state(cfg, batch, device=device)}
    return rep(group, g)


# ----- zamba2 hybrid stack --------------------------------------------------


def zamba_layout(cfg):
    g = cfg.n_layers // cfg.attn_every
    tail = cfg.n_layers - g * cfg.attn_every
    return g, cfg.attn_every, tail


def zamba_stack_specs(cfg):
    g, per, tail = zamba_layout(cfg)
    sp = {
        "groups": stack_specs(
            {"mamba": stack_specs(mamba_block_specs(cfg), per, "inner")},
            g, "layers"),
        "shared_attn": attn_block_specs(cfg),
        "shared_proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                                 ("embed", None), fan_in=2 * cfg.d_model),
    }
    if tail:
        sp["tail"] = stack_specs(mamba_block_specs(cfg), tail, "layers")
    return sp


def _zamba_shared_in(cfg, p, x, x0):
    h = torch.cat([x, x0], dim=-1)
    return h @ p["shared_proj"].to(x.dtype)


def attn_cfg_for_shared(cfg):
    return cfg          # shared attn uses the same dims; no SWA


def zamba_cache_specs(cfg, batch, max_len, dtype):
    g, per, tail = zamba_layout(cfg)
    group = {"mamba": stack_specs(
                 ssm_mod.ssm_state_specs(cfg, batch, dtype), per, "inner"),
             "attn": attn.kv_cache_specs(attn_cfg_for_shared(cfg), batch,
                                         max_len, dtype)}
    sp = {"groups": stack_specs(group, g, "layers"), "tail": None}
    if tail:
        sp["tail"] = stack_specs(ssm_mod.ssm_state_specs(cfg, batch, dtype),
                                 tail, "layers")
    return sp


def _mamba_body(cfg, collect):
    def body(x, p, c):
        x, st = mamba_block(cfg, p, x, None)
        if collect:
            _write(c, st)
        return x, c, _zero(x)
    return body


def zamba_stack_train(cfg, params, x, positions, *, impl="flash",
                      collect=False, max_len=None):
    """Returns (x, cache, aux). cache collects ssm states (+kv if collect)."""
    x0 = x
    cache = None
    if collect:
        cache = zeros_from_specs(zamba_cache_specs(
            cfg, x.shape[0], max_len or x.shape[1], x.dtype), device=x.device)
    mamba = _mamba_body(cfg, collect)

    def group_body(x, p, c):
        x, _, _ = scan_stack(cfg, mamba, x, p["mamba"],
                             None if c is None else c["mamba"])
        h = _zamba_shared_in(cfg, params, x, x0)
        h, kv, aux = attn_block_train(cfg, params["shared_attn"], h,
                                      positions, impl=impl)
        if c is not None:
            attn.fill_kv_cache(attn_cfg_for_shared(cfg), c["attn"], kv[0],
                               kv[1])
        return x + h, c, aux

    x, _, aux = scan_stack(cfg, group_body, x, params["groups"],
                           None if cache is None else cache["groups"])
    if "tail" in params:
        x, _, _ = scan_stack(cfg, mamba, x, params["tail"],
                             None if cache is None else cache["tail"])
    return x, cache, aux


def zamba_stack_decode(cfg, params, x, pos: int, cache):
    x0 = x

    def mamba(x, p, c):
        y, st = mamba_block(cfg, p, x[:, None], c)
        _write(c, st)
        return y[:, 0], c, _zero(x)

    def group_body(x, p, c):
        x, _, _ = scan_stack(cfg, mamba, x, p["mamba"], c["mamba"])
        h = _zamba_shared_in(cfg, params, x, x0)
        h, _, aux = attn_block_decode(cfg, params["shared_attn"], h, pos,
                                      c["attn"])
        return x + h, c, aux

    x, _, aux = scan_stack(cfg, group_body, x, params["groups"],
                           cache["groups"])
    if cache.get("tail") is not None:
        x, _, _ = scan_stack(cfg, mamba, x, params["tail"], cache["tail"])
    return x, cache, aux


# ----- whisper enc-dec stack ------------------------------------------------


def whisper_specs(cfg):
    enc_block = attn_block_specs(cfg)
    dec_block = attn_block_specs(cfg, cross=True)
    return {
        "enc": stack_specs(enc_block, cfg.enc_layers),
        "dec": stack_specs(dec_block, cfg.dec_layers),
        "enc_pos": ParamSpec((cfg.n_frames, cfg.d_model), (None, "embed"),
                             "pos"),
        "enc_norm": norm_specs(cfg, cfg.d_model),
    }


def whisper_encode(cfg, params, frames):
    """frames: (B, F, D) precomputed embeddings (conv frontend stub)."""
    x = frames.to(dtype_of(cfg.compute_dtype))
    x = x + params["enc_pos"].to(x.dtype)
    positions = torch.arange(frames.shape[1], device=frames.device)

    def body(x, p, _):
        x, _, aux = attn_block_train(cfg, p, x, positions, causal=False)
        return x, None, aux

    x, _, _ = scan_stack(cfg, body, x, params["enc"], None)
    return apply_norm(cfg, params["enc_norm"], x)


def whisper_cache_specs(cfg, batch, max_len, dtype):
    cross_shape = (batch, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim)
    cross = ParamSpec(cross_shape, ("batch", None, "kv_heads", None),
                      "zeros", dtype)
    return {"self": stack_specs(attn.kv_cache_specs(cfg, batch, max_len,
                                                    dtype), cfg.dec_layers),
            "cross": stack_specs({"k": cross, "v": cross}, cfg.dec_layers)}


def whisper_decode_train(cfg, params, enc_out, x, positions, *,
                         impl="flash", collect_kv=False, max_len=None):
    cache = None
    if collect_kv:
        cache = zeros_from_specs(whisper_cache_specs(cfg, x.shape[0],
                                           max_len or x.shape[1], x.dtype),
                       device=x.device)

    def body(x, p, c):
        ekv = encoder_kv(p, enc_out)         # computed once a layer
        x, kv = self_attn_train(cfg, p, x, positions, impl=impl)
        x, aux = block_tail(cfg, p, x, positions, enc_kv=ekv)
        if c is not None:
            attn.fill_kv_cache(cfg, c["self"], kv[0], kv[1])
            _write(c["cross"], ekv)
        return x, c, aux

    return scan_stack(cfg, body, x, params["dec"], cache)


def whisper_stack_decode(cfg, params, x, pos: int, cache):
    def body(x, p, c):
        x, _, aux = attn_block_decode(cfg, p, x, pos, c["self"],
                                      cross_kv=c["cross"])
        return x, c, aux

    return scan_stack(cfg, body, x, params["dec"], cache)
