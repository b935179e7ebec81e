"""Attention layers: GQA, sliding-window, chunked-flash, decode paths.

The port of `repro.models.attention`, with the reference's one math in
three plain implementations and one kernel:
  * full   — dense mask, O(S^2) memory. Small seq / encoder / cross.
  * flash  — chunked online softmax, O(S * chunk) memory.  On CUDA
             tensors, causal self-attention goes to the hand-written
             kernel (`repro_torch.kernels.flash_attention`, the
             reference's "TPU twin") at every S, unless a window masks
             something (S > swa_window, `flash_kernel_takes`); on the
             CPU, and for such a window, the plain path the reference
             runs.
  * triangular — the lower-triangular block loop (plain on any device).

Decode: plain cache attention (one-token query vs. a (B, S, KV, Dh)
cache, ring buffer for a window).  The reference's sequence-sharded
flash-decoding needs several cards and is not ported yet.

JAX returns new caches; the port writes the cache tensors in place (a
decode step would otherwise copy every layer's cache) and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (ParamSpec, apply_rope,
                                       head_norm_specs, rms_norm)

_NEG = -1e30


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def attn_specs(cfg, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed"), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((h, hd), ("heads", None), "zeros")
        sp["bk"] = ParamSpec((kv, hd), ("kv_heads", None), "zeros")
        sp["bv"] = ParamSpec((kv, hd), ("kv_heads", None), "zeros")
    if cfg.qk_norm:
        sp["q_norm"] = head_norm_specs(cfg, h, hd)
        sp["k_norm"] = head_norm_specs(cfg, kv, hd)
    return sp


def project_qkv(cfg, p, x, positions, rope: bool = True):
    """x: (B, S, D) -> q (B,S,H,Dh), k,v (B,S,KV,Dh)."""
    cdt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"])
        k = rms_norm(k, p["k_norm"]["scale"])
    if rope and cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(cfg, p, attn_out):
    """attn_out: (B, S, H, Dh) -> (B, S, D)."""
    return torch.einsum("bshk,hkd->bsd", attn_out,
                        p["wo"].to(attn_out.dtype))


# ---------------------------------------------------------------------------
# Exact softmax attention variants (training / prefill)
# ---------------------------------------------------------------------------


def _gqa_scores(q, k, scale):
    """q: (B,Sq,H,Dh) k: (B,Skv,KV,Dh) -> scores (B,KV,G,Sq,Skv) f32."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, Dh).to(torch.float32)
    return torch.einsum("bqkgd,bskd->bkgqs", qg,
                        k.to(torch.float32)) * scale


def _gqa_weighted(pweights, v):
    """pweights: (B,KV,G,Sq,Skv) f32, v: (B,Skv,KV,Dh) -> (B,Sq,H,Dh) f32."""
    B, KV, G, Sq, Skv = pweights.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", pweights, v.to(torch.float32))
    return out.reshape(B, Sq, KV * G, v.shape[-1])


def _mask(q_pos, kv_pos, causal: bool, window: int, kv_len=None):
    """(Sq, Skv) boolean mask (True = attend)."""
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None]
    if window:
        m &= kv_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        m &= kv_pos[None, :] < kv_len
    return m


def attn_full(q, k, v, q_pos, kv_pos, *, causal, window=0, scale=None):
    """Dense-mask exact attention. Memory O(Sq*Skv)."""
    scale = scale or q.shape[-1] ** -0.5
    s = _gqa_scores(q, k, scale)
    m = _mask(q_pos, kv_pos, causal, window)
    s = s.masked_fill(~m, _NEG)
    p = torch.softmax(s, dim=-1)
    return _gqa_weighted(p, v).to(q.dtype)


def _online_block(q, kb, vb, q_pos, kv_pos_b, carry, *, causal, window, scale):
    """One KV block of online-softmax. carry = (m, l, acc)."""
    m, l, acc = carry
    s = _gqa_scores(q, kb, scale)                       # (B,KV,G,Sq,C)
    msk = _mask(q_pos, kv_pos_b, causal, window)
    s = s.masked_fill(~msk, _NEG)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    pexp = torch.exp(s - m_new[..., None])
    l = l * alpha + pexp.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", pexp, vb.to(torch.float32))
    return m_new, l, acc


def _finish(q, l, acc):
    B, KV, G, Sq, Dh = acc.shape
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * G, Dh)
    return out.to(q.dtype)


def attn_flash(q, k, v, q_pos, kv_pos, *, causal, window=0, scale=None,
               q_chunk=1024, kv_chunk=1024):
    """Chunked online-softmax attention: a loop over Q chunks, an inner
    loop over KV chunks (the reference's lax.map x lax.scan).  Computes
    (and masks) every QxKV block, as the reference does."""
    scale = scale or q.shape[-1] ** -0.5
    B, Sq, H, Dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError("chunks must divide the sequence: "
                         f"{(Sq, q_chunk, Skv, kv_chunk)}")
    G = H // KV
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qb, qp = q[:, q0:q0 + q_chunk], q_pos[q0:q0 + q_chunk]
        f32 = dict(dtype=torch.float32, device=q.device)
        carry = (torch.full((B, KV, G, q_chunk), _NEG, **f32),
                 torch.zeros((B, KV, G, q_chunk), **f32),
                 torch.zeros((B, KV, G, q_chunk, Dh), **f32))
        for k0 in range(0, Skv, kv_chunk):
            sl = slice(k0, k0 + kv_chunk)
            carry = _online_block(qb, k[:, sl], v[:, sl], qp, kv_pos[sl],
                                  carry, causal=causal, window=window,
                                  scale=scale)
        outs.append(_finish(qb, carry[1], carry[2]))
    return torch.cat(outs, dim=1)


def attn_triangular(q, k, v, q_pos, kv_pos, *, window=0, scale=None,
                    chunk=2048):
    """FLOP-optimal causal attention: the lower-triangular block loop.  Q
    chunk i runs online softmax over KV chunks 0..i only (and, with a
    window, not those entirely left of it), so upper-triangular blocks
    are never computed.  Requires Sq == Skv (self-attention)."""
    scale = scale or q.shape[-1] ** -0.5
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {S}")
    G = H // KV
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    for i in range(S // chunk):
        qs = slice(i * chunk, (i + 1) * chunk)
        qb, qp = q[:, qs], q_pos[qs]
        carry = (torch.full((B, KV, G, chunk), _NEG, **f32),
                 torch.zeros((B, KV, G, chunk), **f32),
                 torch.zeros((B, KV, G, chunk, Dh), **f32))
        lo = 0
        if window:  # blocks entirely left of the window are all-masked
            lo = max(0, (i * chunk - window) // chunk)
        for j in range(lo, i + 1):
            ks = slice(j * chunk, (j + 1) * chunk)
            # off-diagonal in-window blocks need no mask at all
            need_mask = (j == i) or (window and (i * chunk - window
                                                 < (j + 1) * chunk))
            carry = _online_block(qb, k[:, ks], v[:, ks], qp, kv_pos[ks],
                                  carry, causal=(j == i),
                                  window=window if need_mask else 0,
                                  scale=scale)
        outs.append(_finish(qb, carry[1], carry[2]))
    return torch.cat(outs, dim=1)


def flash_kernel_takes(cfg, S: int) -> bool:
    """Whether the kernel computes causal self-attention over positions
    0..S-1 under `cfg`'s window: always without one, and with one when
    S <= window (then kv_pos > q_pos - window holds for every causal
    pair, since q_pos - window <= S - 1 - window < 0 <= kv_pos)."""
    return not cfg.swa_window or S <= cfg.swa_window


def self_attention(cfg, q, k, v, q_pos, kv_pos, *, impl="flash"):
    """Causal self-attention over positions 0..S-1 (prefill)."""
    window = cfg.swa_window
    if impl not in ("full", "flash", "triangular"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "flash" and q.is_cuda and flash_kernel_takes(cfg, q.shape[1]):
        # the kernel's layout is (B, H, S, Dh)
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous())
        return o.transpose(1, 2)
    if (impl == "full" or q.shape[1] <= cfg.attn_chunk
            or q.shape[1] % cfg.attn_chunk != 0):
        # small or chunk-indivisible sequences: dense-mask path
        return attn_full(q, k, v, q_pos, kv_pos, causal=True, window=window)
    if impl == "triangular":
        return attn_triangular(q, k, v, q_pos, kv_pos, window=window,
                               chunk=cfg.attn_chunk)
    return attn_flash(q, k, v, q_pos, kv_pos, causal=True, window=window,
                      q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk)


# ---------------------------------------------------------------------------
# Decode paths
# ---------------------------------------------------------------------------


def cache_window(cfg, S):
    return min(S, cfg.swa_window) if cfg.swa_window else S


def init_kv_cache(cfg, batch: int, max_len: int, dtype, *, device):
    """(k, v) cache; SWA archs allocate only the window ring-buffer."""
    shape = (batch, cache_window(cfg, max_len), cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _seq_sharded(cfg) -> bool:
    return bool(cfg.decode_seq_shard) and not cfg.swa_window


def kv_cache_specs(cfg, batch: int, max_len: int, dtype):
    shape = (batch, cache_window(cfg, max_len), cfg.n_kv_heads, cfg.head_dim)
    seq_ax = "kv_seq" if _seq_sharded(cfg) else None
    sp = ParamSpec(shape, ("batch", seq_ax, "kv_heads", None), "zeros", dtype)
    return {"k": sp, "v": sp}


def fill_kv_cache(cfg, cache, k, v, start: int = 0):
    """Write prefill k/v (B, S, KV, Dh) into the cache, in place."""
    S = k.shape[1]
    if cfg.swa_window:
        W = cache["k"].shape[1]
        if S >= W:
            # last W positions; slot p % W. (S - W) % W == 0 when W | S.
            if (S - W) % W and S != W:
                raise ValueError(f"window {W} must divide prompt {S}")
            cache["k"].copy_(k[:, -W:])
            cache["v"].copy_(v[:, -W:])
            return cache
    cache["k"][:, start:start + S] = k
    cache["v"][:, start:start + S] = v
    return cache


def decode_attention(cfg, cache, q, new_k, new_v, pos: int):
    """One-token decode. q: (B,H,Dh), new_k/new_v: (B,KV,Dh), pos: int.

    Returns (attn_out (B,H,Dh), cache) with the cache written in place."""
    return _decode_attn_local(cfg, cache, q, new_k, new_v, pos)


def _write_slot(cfg, pos, S):
    if cfg.swa_window:
        return pos % cache_window(cfg, S)
    return pos


def _decode_attn_local(cfg, cache, q, new_k, new_v, pos):
    B, S, KV, Dh = cache["k"].shape
    slot = _write_slot(cfg, pos, S)
    cache["k"][:, slot] = new_k
    cache["v"][:, slot] = new_v
    slots = torch.arange(S, device=q.device)
    if cfg.swa_window:
        # ring buffer: slot s holds global position pos - ((pos - s) mod S)
        valid = pos - torch.remainder(pos - slots, S) >= 0
    else:
        valid = slots <= pos
    out = _decode_scores(cfg, q, cache["k"], cache["v"], valid)
    return out, cache


def _decode_scores(cfg, q, kc, vc, valid):
    """q (B,H,Dh), kc/vc (B,S,KV,Dh), valid (S,) -> (B,H,Dh)."""
    B, S, KV, Dh = kc.shape
    H = q.shape[1]
    G = H // KV
    scale = Dh ** -0.5
    qg = q.reshape(B, KV, G, Dh).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc.to(torch.float32)) * scale
    s = s.masked_fill(~valid[None, None, None], _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, vc.to(torch.float32))
    return o.reshape(B, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Cross attention (enc-dec)
# ---------------------------------------------------------------------------


def cross_attention(cfg, q, enc_k, enc_v):
    """q: (B,Sq,H,Dh) vs. precomputed encoder k/v (B,F,KV,Dh). Non-causal."""
    q_pos = torch.arange(q.shape[1], device=q.device)
    kv_pos = torch.arange(enc_k.shape[1], device=q.device)
    return attn_full(q, enc_k, enc_v, q_pos, kv_pos, causal=False)
