"""Mamba2 (SSD) block: chunked-parallel scan for train/prefill, O(1)-state
recurrence for decode.

The port of `repro.models.ssm` (Dao & Gu 2024): scalar-per-head A,
single B/C group, depthwise conv frontend, gated RMSNorm before out-proj.
The chunked algorithm computes, per chunk of length L:
  intra-chunk:  Y_ij = C_i . B_j * exp(cumA_i - cumA_j) * dt_j  (j <= i)
  chunk state:  S_c  = sum_j exp(cumA_last - cumA_j) * dt_j * (B_j x X_j)
  inter-chunk:  a loop over chunk states (the only sequential part)
so the sequential depth is T/chunk instead of T.  The SSM state is
float32, (B, H, N, P); decode is the same block at T = 1 continuing from
the conv and SSM states.  The reference has no Pallas kernel here: XLA
compiles these einsums, and the port leaves them to torch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, ashard, dtype_of, rms_norm


def ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.state


def ssm_specs(cfg):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, Pdim, N = ssm_dims(cfg)
    conv_dim = d_inner + 2 * N          # x, B, C all pass the conv
    return {
        # in_proj -> [z, xBC, dt]
        "w_in": ParamSpec((d, 2 * d_inner + 2 * N + H), ("embed", "mlp")),
        "conv_w": ParamSpec((s.conv, conv_dim), (None, "mlp"), fan_in=s.conv),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), "zeros"),
        "A_log": ParamSpec((H,), (None,), "mamba_a"),
        "D": ParamSpec((H,), (None,), "ones"),
        "dt_bias": ParamSpec((H,), (None,), "dt_bias"),
        "norm_scale": ParamSpec((d_inner,), ("mlp",), "ones"),
        "w_out": ParamSpec((d_inner, d), ("mlp", "embed")),
    }


def _split_in(cfg, proj):
    d_inner, H, Pdim, N = ssm_dims(cfg)
    z, xBC, dt = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    return z, xBC, dt


def _conv1d(cfg, p, xBC, conv_state=None):
    """Causal depthwise conv. xBC: (B, T, conv_dim).

    Returns (out (B,T,conv_dim), new_conv_state (B, conv-1, conv_dim)).
    """
    W = p["conv_w"]                      # (K, conv_dim)
    K = W.shape[0]
    B, T = xBC.shape[:2]
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, xBC.shape[-1]), dtype=xBC.dtype,
                                 device=xBC.device)
    xpad = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    # depthwise causal conv as sum of shifted scaled copies (K is tiny)
    out = sum(xpad[:, i:i + T] * W[i].to(xBC.dtype) for i in range(K))
    out = F.silu(out + p["conv_b"].to(xBC.dtype))
    new_state = xpad[:, xpad.shape[1] - (K - 1):]
    return out, new_state


def _segsum(a):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} a[..., k] for
    i >= j, -inf elsewhere.  a: (..., L)."""
    L = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    diff = c[..., :, None] - c[..., None, :]      # cum_i - cum_j
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """SSD chunked scan.

    x:  (B, T, H, P)   inputs per head
    dt: (B, T, H)      positive step sizes
    A:  (H,)           negative decay rates
    Bm: (B, T, N)      input mixers (single group)
    Cm: (B, T, N)      output mixers
    initial_state: (B, H, N, P) carried state (decode / continuation)
    Returns y: (B, T, H, P), final_state: (B, H, N, P).
    """
    Bsz, T, H, Pdim = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:  # dt=0 on padding => decay 1, contribution 0 (exact)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    T_pad = T + pad
    nc = T_pad // chunk

    xc = x.reshape(Bsz, nc, chunk, H, Pdim)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    a = (dtc * A).permute(0, 1, 3, 2)             # (B,nc,H,L), negative
    cum_a = torch.cumsum(a, dim=-1)               # (B,nc,H,L)
    dt_h = dtc.permute(0, 1, 3, 2)                # (B,nc,H,L)

    # ---- intra-chunk (quadratic within chunk) -----------------------------
    Lmat = torch.exp(_segsum(a))                  # (B,nc,H,L,L)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B,nc,L,L)
    W = CB[:, :, None] * Lmat * dt_h[:, :, :, None, :]
    del Lmat
    y_intra = torch.einsum("bchij,bcjhp->bcihp", W, xc)
    del W

    # ---- per-chunk state contribution -------------------------------------
    decay_to_end = torch.exp(cum_a[..., -1:] - cum_a)        # (B,nc,H,L)
    Sc = torch.einsum("bchl,bcln,bclhp->bchnp",
                      decay_to_end * dt_h, Bc, xc)           # (B,nc,H,N,P)

    # ---- inter-chunk recurrence (sequential over chunks) -------------------
    chunk_decay = torch.exp(cum_a[..., -1])                  # (B,nc,H)
    S = (torch.zeros((Bsz, H, N, Pdim), dtype=x.dtype, device=x.device)
         if initial_state is None else initial_state.to(x.dtype))
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * chunk_decay[:, c, :, None, None] + Sc[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)                    # (B,nc,H,N,P)

    # ---- inter-chunk output ------------------------------------------------
    decay_from_start = torch.exp(cum_a)                      # (B,nc,H,L)
    y_inter = torch.einsum("bcln,bchl,bchnp->bclhp",
                           Cc, decay_from_start, S_prevs)
    y = (y_intra + y_inter).reshape(Bsz, T_pad, H, Pdim)
    return y[:, :T], S


def apply_ssm(cfg, p, x, state=None):
    """Full mamba2 block. x: (B, T, D).

    state: None (train) or dict(conv, ssm) for chunk-continuation.
    Returns (out (B,T,D), new_state)."""
    s = cfg.ssm
    d_inner, H, Pdim, N = ssm_dims(cfg)
    cdt = x.dtype
    f32 = torch.float32
    proj = x @ p["w_in"].to(cdt)
    z, xBC, dt = _split_in(cfg, proj)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _conv1d(cfg, p, xBC, conv_state)
    xs, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    xs = xs.reshape(*xs.shape[:2], H, Pdim)
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))

    init_S = None if state is None else state["ssm"]
    y, S_final = ssd_chunked(xs.to(f32), dt, A, Bm.to(f32), Cm.to(f32),
                             s.chunk, initial_state=init_S)
    y = y + xs.to(f32) * p["D"].to(f32)[:, None]
    y = y.reshape(*y.shape[:2], d_inner).to(cdt)
    y = rms_norm(y * F.silu(z), p["norm_scale"])
    y = ashard(y, "batch", "seq", "mlp")
    out = y @ p["w_out"].to(cdt)
    return out, {"conv": new_conv, "ssm": S_final}


def init_ssm_state(cfg, batch: int, dtype, *, device):
    s = cfg.ssm
    d_inner, H, Pdim, N = ssm_dims(cfg)
    conv_dim = d_inner + 2 * N
    return {"conv": torch.zeros((batch, s.conv - 1, conv_dim),
                                dtype=dtype_of(dtype), device=device),
            "ssm": torch.zeros((batch, H, N, Pdim), dtype=torch.float32,
                               device=device)}


def ssm_state_specs(cfg, batch: int, dtype):
    s = cfg.ssm
    d_inner, H, Pdim, N = ssm_dims(cfg)
    conv_dim = d_inner + 2 * N
    return {
        "conv": ParamSpec((batch, s.conv - 1, conv_dim),
                          ("batch", None, "mlp"), "zeros", dtype),
        "ssm": ParamSpec((batch, H, N, Pdim),
                         ("batch", "heads", None, None), "zeros",
                         torch.float32),
    }


def decode_ssm(cfg, p, x, state):
    """One-token decode. x: (B, D). Returns (out (B,D), new_state)."""
    out, new_state = apply_ssm(cfg, p, x[:, None], state)
    return out[:, 0], new_state
