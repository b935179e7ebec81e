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
             runs.  Where q, k or v require grad the kernel runs under
             `FlashAttentionFunction`: its forward is the kernel (with
             each row's log-sum-exp), its backward the hand-written
             backward kernel (the reference differentiates `attn_flash`
             with XLA); on CPU tensors both run their plain versions.
  * triangular — the lower-triangular block loop (plain on any device).

Decode: plain cache attention (one-token query vs. a (B, S, KV, Dh)
cache, ring buffer for a window), or, for an arch with
`decode_seq_shard` under a mesh with a model axis, the reference's
sequence-sharded flash-decoding: each model-axis rank holds a chunk of
the cache, takes a partial softmax over it, and the partials merge by
log-sum-exp with `all_reduce` MAX and SUM over the model dim's group.

Under `use_sharding` q, k and v are DTensors.  Causal self-attention
then runs on each rank's local heads (`_on_local_heads`): its q heads
and the KV heads those read (global head g reads KV head g // (H // KV)),
also where `kv_heads` fell back to replicated while `heads` shards
(yi-6b's 32 / 4 heads on a 16-wide model axis: 2 query heads and all 4
KV heads a rank).  The kernel and the plain paths see plain tensors.

JAX returns new caches; the port writes the cache tensors in place (a
decode step would otherwise copy every layer's cache) and returns them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.models.layers import (ParamSpec, apply_rope, ashard,
                                       batch_local, head_norm_specs,
                                       local_range, relaid, rms_norm,
                                       sharded_only)

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


def _project(x, w):
    """x (B, S, D) @ w (D, n, hd) -> (B, S, n, hd).  For a DTensor x
    whose weight's heads fell back to replicated (yi-6b's 4 KV heads on
    a 16-wide model axis), each rank projects its batch rows onto all n
    heads: DTensor would otherwise be free to cut the flat (n * hd)
    product into pieces that are not whole heads, which it cannot then
    split into (n, hd).  Sharded heads take the flat product, whose cut
    then falls on whole heads (DTensor's einsum gathers them)."""
    if not isinstance(x, DTensor):
        return torch.einsum("bsd,dhk->bshk", x, w)
    if Shard(1) not in w.placements:
        return batch_local(
            lambda a, b: torch.einsum("bsd,dhk->bshk", a, b), (x,), (w,))
    # the heads' cut carries through the flat product and its split
    D, n, hd = w.shape
    return (x @ w.reshape(D, n * hd)).unflatten(-1, (n, hd))


def project_qkv(cfg, p, x, positions, rope: bool = True):
    """x: (B, S, D) -> q (B,S,H,Dh), k,v (B,S,KV,Dh)."""
    cdt = x.dtype
    q = _project(x, p["wq"].to(cdt))
    k = _project(x, p["wk"].to(cdt))
    v = _project(x, p["wv"].to(cdt))
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
    q = ashard(q, "batch", "seq", "heads", None)
    k = ashard(k, "batch", "seq", "kv_heads", None)
    v = ashard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def out_proj(cfg, p, attn_out):
    """attn_out: (B, S, H, Dh) -> (B, S, D).  A DTensor takes the flat
    product, (B, S, H * Dh) @ (H * Dh, D), which keeps the heads' cut
    (DTensor's einsum gathers the heads first)."""
    wo = p["wo"].to(attn_out.dtype)
    if isinstance(attn_out, DTensor):
        H, Dh, D = wo.shape
        return attn_out.flatten(2) @ wo.reshape(H * Dh, D)
    return torch.einsum("bshk,hkd->bsd", attn_out, wo)


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


def _flash_kernel(q, k, v):
    """The kernel on (B, S, H, Dh) tensors, read in place as the
    (B, H, S, Dh) views of its signature; the output comes back in q's
    layout."""
    o = flash_attention(*(x.transpose(1, 2) for x in (q, k, v)))
    return o.transpose(1, 2)


def causal_plain(q, k, v, chunk: int):
    """Causal self-attention over positions 0..S-1 without a window, by
    the plain path: dense where S <= chunk or chunk does not divide S
    (as `self_attention`), else the lower-triangular block loop, whose
    values are `attn_flash`'s bit for bit (an all-masked block adds
    exp(-1e30 - m) = 0 and rescales by exp(0) = 1) at half its work and
    memory.  The plain path that tests hold `FlashAttentionFunction`
    against; nothing on the card's path calls it."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    if S <= chunk or S % chunk:
        return attn_full(q, k, v, pos, pos, causal=True)
    return attn_triangular(q, k, v, pos, pos, chunk=chunk)


class FlashAttentionFunction(torch.autograd.Function):
    """Causal self-attention on (B, S, H, Dh) q and (B, S, KV, Dh) k, v.
    The forward is `flash_attention_fwd` on their (B, H, S, Dh) views,
    read in place; it saves the model's own q, k, v, the output and each
    row's log-sum-exp.  The backward is `flash_attention_bwd` on the same
    views and on those of the output and of the cotangent (one launch a
    call on the card; on CPU tensors both run their plain versions, the
    dense oracle and dense float32 gradients).  The kernels write the
    output and the gradients in their inputs' layout, so a (B, S, H, Dh)
    q gets a (B, S, H, Dh) output and gradient with no copy.  On the card
    a layout the kernels cannot read (a last axis that is not contiguous,
    strides that are not multiples of 16 bytes) raises.  Under remat the
    forward runs again inside the checkpoint and the backward reads the
    recomputed output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(*(x.transpose(1, 2) for x in (q, k, v)))
        out = o.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        views = (x.transpose(1, 2) for x in (q, k, v, out))
        grads = flash_attention_bwd(*views, lse, grad_out.transpose(1, 2))
        need = ctx.needs_input_grad[:3]
        return tuple(g.transpose(1, 2) if n else None
                     for g, n in zip(grads, need))


# ---------------------------------------------------------------------------
# DTensor q, k, v: attention on each rank's local heads
# ---------------------------------------------------------------------------


def local_kv_heads(q_heads: range, H: int, KV: int):
    """What of the KV heads the global query heads `q_heads` read: a
    slice of KV heads where the local heads split evenly over a run of
    them (GQA with a local group), else an index per local head."""
    G = H // KV
    idx = [h // G for h in q_heads]
    lo, hi = idx[0], idx[-1] + 1
    per = len(idx) // (hi - lo)
    if idx == [lo + i // per for i in range(len(idx))]:
        return slice(lo, hi)
    return idx


def _on_local_heads(fn, q, k, v):
    """fn(q, k, v) on plain tensors, run on this rank's heads of DTensor
    q (B, S, H, Dh), k and v (B, S, KV, Dh).  k and v follow q's batch
    sharding; they keep their heads sharded only where q's heads are
    sharded over the same mesh dims (then a rank's KV heads are exactly
    those its query heads read), else every rank gathers all KV heads
    and takes those its query heads read.  Returns a DTensor laid out as
    q (with only its batch and heads dims sharded)."""
    q, k, v = (sharded_only(x, (0, 2)) for x in (q, k, v))
    mesh = q.device_mesh

    def head_dims(x):
        return [m for m, pl in enumerate(x.placements) if pl == Shard(2)]

    same = head_dims(k) == head_dims(q) == head_dims(v)
    want, grad = [], []
    for pq in q.placements:
        if pq == Shard(0) or (pq == Shard(2) and same):
            want.append(pq)
            grad.append(pq)
        else:
            want.append(Replicate())
            # a KV head read on several ranks gets its gradient summed
            grad.append(Partial() if pq == Shard(2) else Replicate())
    k, v = (relaid(x, mesh, want) for x in (k, v))
    ql = q.to_local()
    kl = k.to_local(grad_placements=grad)
    vl = v.to_local(grad_placements=grad)
    if not same:
        sel = local_kv_heads(local_range(q, 2), q.shape[2], k.shape[2])
        kl, vl = kl[:, :, sel], vl[:, :, sel]
    return DTensor.from_local(fn(ql, kl, vl), mesh, q.placements,
                              run_check=False)


def self_attention(cfg, q, k, v, q_pos, kv_pos, *, impl="flash"):
    """Causal self-attention over positions 0..S-1 (prefill, training).
    DTensor q, k, v run on each rank's local heads."""
    window = cfg.swa_window
    if impl not in ("full", "flash", "triangular"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if isinstance(q, DTensor):
        return _on_local_heads(
            lambda a, b, c: self_attention(cfg, a, b, c, q_pos, kv_pos,
                                           impl=impl), q, k, v)
    if impl == "flash" and q.is_cuda and flash_kernel_takes(cfg, q.shape[1]):
        if any(t.requires_grad for t in (q, k, v)):
            return FlashAttentionFunction.apply(q, k, v)
        return _flash_kernel(q, k, v)
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


def write_seq(dst, x, start: int) -> None:
    """dst[:, start:start + x.shape[1]] = x, in place.  For a DTensor
    cache each rank writes the positions its piece holds (its batch rows
    and, where the cache is sequence-sharded, its chunk of the
    sequence)."""
    if not isinstance(dst, DTensor):
        dst[:, start:start + x.shape[1]] = x
        return
    x = relaid(x, dst.device_mesh, [Replicate() if pl == Shard(1) else pl
                                     for pl in dst.placements])
    held = local_range(dst, 1)
    lo, hi = max(start, held.start), min(start + x.shape[1], held.stop)
    if lo < hi:
        dst.to_local()[:, lo - held.start:hi - held.start] = \
            x.to_local()[:, lo - start:hi - start]


def fill_kv_cache(cfg, cache, k, v, start: int = 0):
    """Write prefill k/v (B, S, KV, Dh) into the cache, in place."""
    S = k.shape[1]
    if cfg.swa_window:
        W = cache["k"].shape[1]
        if S >= W:
            # last W positions; slot p % W. (S - W) % W == 0 when W | S.
            if (S - W) % W and S != W:
                raise ValueError(f"window {W} must divide prompt {S}")
            k, v, start = k[:, -W:], v[:, -W:], 0
    write_seq(cache["k"], k, start)
    write_seq(cache["v"], v, start)
    return cache


def decode_attention(cfg, cache, q, new_k, new_v, pos: int, mesh=None):
    """One-token decode. q: (B,H,Dh), new_k/new_v: (B,KV,Dh), pos: int.

    Returns (attn_out (B,H,Dh), cache) with the cache written in place.
    Dispatches to the sequence-sharded flash-decoding path when the arch
    is configured for it and a mesh with a model axis is active (its
    cache a DTensor)."""
    if (_seq_sharded(cfg) and mesh is not None
            and "model" in (mesh.mesh_dim_names or ())
            and isinstance(cache["k"], DTensor)
            and cache["k"].shape[1] % mesh["model"].size() == 0):
        return _decode_attn_seq_sharded(cfg, mesh, cache, q, new_k, new_v,
                                        pos)
    return _decode_attn_local(cfg, cache, q, new_k, new_v, pos)


def _write_slot(cfg, pos, S):
    if cfg.swa_window:
        return pos % cache_window(cfg, S)
    return pos


def _decode_attn_local(cfg, cache, q, new_k, new_v, pos):
    B, S, KV, Dh = cache["k"].shape
    slot = _write_slot(cfg, pos, S)
    write_seq(cache["k"], new_k[:, None], slot)
    write_seq(cache["v"], new_v[:, None], slot)
    slots = torch.arange(S, device=q.device)
    if cfg.swa_window:
        # ring buffer: slot s holds global position pos - ((pos - s) mod S)
        valid = pos - torch.remainder(pos - slots, S) >= 0
    else:
        valid = slots <= pos
    if isinstance(q, DTensor):
        # each rank its batch rows, all heads and the whole cache
        out = batch_local(lambda a, b, c: _decode_scores(cfg, a, b, c,
                                                         valid),
                          (q, cache["k"], cache["v"]))
    else:
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


def _decode_attn_seq_sharded(cfg, mesh, cache, q, new_k, new_v, pos: int):
    """Flash-decoding: the cache (DTensors) sharded over its sequence on
    the model axis; every rank writes the new k/v if it holds position
    `pos`, computes a partial softmax over its chunk, and the partials
    are merged by log-sum-exp: `all_reduce` MAX of the running maxima,
    then SUM of the rescaled denominators and outputs, over the model
    dim's group (the reference's pmax and psum).  q, new_k, new_v: (B,
    H|KV, Dh), DTensors or plain tensors the same on every rank.  Returns
    (out (B, H, Dh) DTensor, batch rows as the cache, heads whole)."""
    kc_d, vc_d = cache["k"], cache["v"]
    rows = [pl if pl == Shard(0) else Replicate() for pl in kc_d.placements]
    ql, nk, nv = (relaid(x, mesh, rows).to_local() for x in (q, new_k,
                                                             new_v))
    kc, vc = kc_d.to_local(), vc_d.to_local()
    held = local_range(kc_d, 1)
    if pos in held:
        kc[:, pos - held.start] = nk
        vc[:, pos - held.start] = nv
    B, S_loc, KV, Dh = kc.shape
    H = ql.shape[1]
    G = H // KV
    valid = torch.arange(held.start, held.stop, device=kc.device) <= pos
    qg = ql.reshape(B, KV, G, Dh).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc.to(torch.float32)) * \
        Dh ** -0.5
    s = s.masked_fill(~valid[None, None, None], _NEG)
    m_l = s.amax(-1)
    pexp = torch.exp(s - m_l[..., None])
    l_l = pexp.sum(-1)
    o_l = torch.einsum("bkgs,bskd->bkgd", pexp, vc.to(torch.float32))
    group = mesh.get_group("model")
    m_g = m_l.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m_l - m_g)
    l_g = l_l * corr
    o_g = o_l * corr[..., None]
    dist.all_reduce(l_g, group=group)
    dist.all_reduce(o_g, group=group)
    o = o_g / torch.clamp(l_g, min=1e-30)[..., None]
    out = o.reshape(B, H, Dh).to(ql.dtype)
    return DTensor.from_local(out, mesh, rows, run_check=False), cache


# ---------------------------------------------------------------------------
# Cross attention (enc-dec)
# ---------------------------------------------------------------------------


def cross_attention(cfg, q, enc_k, enc_v):
    """q: (B,Sq,H,Dh) vs. precomputed encoder k/v (B,F,KV,Dh). Non-causal."""
    q_pos = torch.arange(q.shape[1], device=q.device)
    kv_pos = torch.arange(enc_k.shape[1], device=q.device)
    return attn_full(q, enc_k, enc_v, q_pos, kv_pos, causal=False)
