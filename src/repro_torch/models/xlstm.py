"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-
parallel) and sLSTM (scalar memory, strictly recurrent).

The port of `repro.models.xlstm`.  mLSTM cell (stabilized, per head):
    i_t = exp(~i_t),  f_t = sigmoid-or-exp(~f_t)   (log-space here)
    C_t = f_t C_{t-1} + i_t v_t k_t^T      (matrix memory, Dh x Dh)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)
run in the chunkwise-parallel form: within a chunk the weights
w_tj = exp(cumF_t - cumF_j + logi_j) form a lower-triangular
attention-like matrix; across chunks the (C, n) state is carried by a
loop over chunks, with the log-space stabilizer m carried beside it.

sLSTM is sequential by construction (recurrent h_{t-1} feeds the gates),
so prefill loops over time, one step per token, as the reference's
`lax.scan` does.  Neither has a Pallas kernel in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import (ParamSpec, ashard, batch_local,
                                       rms_norm)

_NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_dims(cfg):
    """(d_inner, H, Dv, Dqk): block-diagonal per-head projections with
    half-dim q/k (official xLSTM-1.3b structure)."""
    x = cfg.xlstm
    d_inner = x.mlstm_expand * cfg.d_model
    H = cfg.n_heads
    Dv = d_inner // H
    return d_inner, H, Dv, max(Dv // 2, 1)


def mlstm_specs(cfg):
    d = cfg.d_model
    d_inner, H, Dv, Dqk = mlstm_dims(cfg)
    return {
        "w_up": ParamSpec((d, 2 * d_inner), ("embed", "mlp")),   # [x_in, z]
        "wq": ParamSpec((H, Dv, Dqk), ("heads", None, None), fan_in=Dv),
        "wk": ParamSpec((H, Dv, Dqk), ("heads", None, None), fan_in=Dv),
        "wv": ParamSpec((H, Dv, Dv), ("heads", None, None), fan_in=Dv),
        "w_if": ParamSpec((d_inner, 2 * H), ("mlp", None)),      # gates
        "b_if": ParamSpec((2 * H,), (None,), "zeros"),
        "norm_scale": ParamSpec((d_inner,), ("mlp",), "ones"),
        "w_down": ParamSpec((d_inner, d), ("mlp", "embed")),
    }


def _mlstm_chunked(q, k, v, logi, logf, chunk, state=None):
    """q,k,v: (B,T,H,Dh) f32; logi/logf: (B,T,H) f32 (log gates).

    Returns h (B,T,H,Dh), new_state (C (B,H,Dh,Dh), n (B,H,Dh), m (B,H)).
    """
    B, T, H, Dqk = q.shape
    Dv = v.shape[-1]
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:  # logi=-inf (no contribution), logf=0 (no decay) on padding
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=_NEG)
        logf = F.pad(logf, (0, 0, 0, pad))
    T_pad = T + pad
    nc = T_pad // chunk
    q = q * Dqk ** -0.5

    qc = q.reshape(B, nc, chunk, H, Dqk)
    kc = k.reshape(B, nc, chunk, H, Dqk)
    vc = v.reshape(B, nc, chunk, H, Dv)
    lic = logi.reshape(B, nc, chunk, H).permute(0, 1, 3, 2)     # (B,nc,H,L)
    lfc = logf.reshape(B, nc, chunk, H).permute(0, 1, 3, 2)

    cumf = torch.cumsum(lfc, dim=-1)                             # (B,nc,H,L)
    # log weight of source j at target t (within chunk, j <= t):
    #   cumf_t - cumf_j + logi_j
    lw = cumf[..., :, None] - cumf[..., None, :] + lic[..., None, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    lw = lw.masked_fill(~mask, _NEG)
    # chunk-state log weights: contribution of j to end-of-chunk state
    lw_state = cumf[..., -1:] - cumf + lic                       # (B,nc,H,L)

    if state is None:
        C_prev = torch.zeros((B, H, Dqk, Dv), dtype=torch.float32,
                             device=q.device)
        n_prev = torch.zeros((B, H, Dqk), dtype=torch.float32,
                             device=q.device)
        m_prev = torch.full((B, H), _NEG, dtype=torch.float32,
                            device=q.device)
    else:
        C_prev, n_prev, m_prev = state["C"], state["n"], state["m"]

    # ---- sequential pass over chunks (carries C, n, m) --------------------
    hs = []
    for c in range(nc):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]
        lwb, lwsb, cumfb = lw[:, c], lw_state[:, c], cumf[:, c]
        # stabilizer: max over intra weights and inherited state magnitude
        m_intra = lwb.amax(-1)                                   # (B,H,L)
        m_t = torch.maximum(m_prev[..., None] + cumfb, m_intra)  # (B,H,L)
        # intra-chunk
        w = torch.exp(lwb - m_t[..., None])                      # (B,H,L,L)
        sw = torch.einsum("bthd,bshd->bhts", qb, kb) * w         # (B,H,L,L)
        num_intra = torch.einsum("bhts,bshd->bthd", sw, vb)
        den_intra = sw.sum(-1).permute(0, 2, 1)                  # (B,L,H)
        # inter-chunk (state from previous chunks); lw_in = cumf
        decay_in = torch.exp(cumfb + m_prev[..., None] - m_t)    # (B,H,L)
        num_inter = torch.einsum("bthd,bhde->bthe", qb, C_prev) * \
            decay_in.permute(0, 2, 1)[..., None]
        den_inter = torch.einsum("bthd,bhd->bth", qb, n_prev) * \
            decay_in.permute(0, 2, 1)
        num = num_intra + num_inter                              # (B,L,H,Dh)
        den = den_intra + den_inter                              # (B,L,H)
        floor = torch.exp(-m_t).permute(0, 2, 1)                 # (B,L,H)
        hs.append(num / torch.maximum(den.abs(), floor)[..., None])
        # ---- update state to end of chunk
        m_end = torch.maximum(m_prev + cumfb[..., -1], lwsb.amax(-1))
        ws = torch.exp(lwsb - m_end[..., None])                  # (B,H,L)
        carry = torch.exp(m_prev + cumfb[..., -1] - m_end)       # (B,H)
        C_prev = C_prev * carry[..., None, None] + torch.einsum(
            "bht,bthd,bthe->bhde", ws, kb, vb)
        n_prev = n_prev * carry[..., None] + torch.einsum(
            "bht,bthd->bhd", ws, kb)
        m_prev = m_end
    h = torch.stack(hs, dim=1).reshape(B, T_pad, H, Dv)
    return h[:, :T], {"C": C_prev, "n": n_prev, "m": m_prev}


def apply_mlstm(cfg, p, x, state=None):
    """mLSTM block. x: (B,T,D) -> (out, new_state)."""
    d_inner, H, Dv, Dqk = mlstm_dims(cfg)
    cdt = x.dtype
    f32 = torch.float32
    up = x @ p["w_up"].to(cdt)
    xin, z = torch.chunk(up, 2, dim=-1)
    xin = ashard(xin, "batch", "seq", "mlp")
    gates = (xin @ p["w_if"].to(cdt) + p["b_if"].to(cdt)).to(f32)
    names = ("C", "n", "m")

    def cell(xin, gates, *rest):
        """The heads: projections and the chunked cell.  rest: the state
        (if any), then wq, wk, wv."""
        st, (wq, wk, wv) = rest[:-3], rest[-3:]
        xh = xin.reshape(*xin.shape[:2], H, Dv)      # per-head stream
        q = torch.einsum("bthe,hed->bthd", xh, wq.to(cdt))
        k = torch.einsum("bthe,hed->bthd", xh, wk.to(cdt))
        v = torch.einsum("bthe,hed->bthd", xh, wv.to(cdt))
        logi, logf_raw = torch.chunk(gates, 2, dim=-1)           # (B,T,H)
        h, new = _mlstm_chunked(q.to(f32), k.to(f32), v.to(f32), logi,
                                F.logsigmoid(logf_raw),
                                cfg.xlstm.mlstm_chunk,
                                dict(zip(names, st)) if st else None)
        # heads merged here, on local tensors: a DTensor's gradient could
        # come back cut where the heads cannot be split out again
        h = h.reshape(*h.shape[:2], d_inner).to(cdt)
        return (h,) + tuple(new[n] for n in names)

    st = () if state is None else tuple(state[n] for n in names)
    w = (p["wq"], p["wk"], p["wv"])
    if isinstance(xin, DTensor):
        # H heads need not divide the model axis (xlstm-1.3b: 4 on 16):
        # each rank runs its batch rows through all heads
        h, *new = batch_local(cell, (xin, gates, *st), w)
    else:
        h, *new = cell(xin, gates, *st, *w)
    new_state = dict(zip(names, new))
    h = rms_gate(h, z, p["norm_scale"])
    return h @ p["w_down"].to(cdt), new_state


def rms_gate(h, z, scale):
    return rms_norm(h, scale) * F.silu(z)


def init_mlstm_state(cfg, batch, *, device):
    d_inner, H, Dv, Dqk = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, Dqk, Dv), **f32),
            "n": torch.zeros((batch, H, Dqk), **f32),
            "m": torch.full((batch, H), _NEG, **f32)}


def mlstm_state_specs(cfg, batch):
    d_inner, H, Dv, Dqk = mlstm_dims(cfg)
    return {"C": ParamSpec((batch, H, Dqk, Dv),
                           ("batch", "heads", None, None), "zeros",
                           torch.float32),
            "n": ParamSpec((batch, H, Dqk), ("batch", "heads", None),
                           "zeros", torch.float32),
            "m": ParamSpec((batch, H), ("batch", "heads"), "zeros",
                           torch.float32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_dims(cfg):
    H = cfg.n_heads
    return H, cfg.d_model // H


def slstm_specs(cfg):
    d = cfg.d_model
    H, Dh = slstm_dims(cfg)
    return {
        # 4 gates (i, f, z, o) from input and recurrent h (block-diag/head)
        "w_x": ParamSpec((d, H, 4 * Dh), ("embed", "heads", None), fan_in=d),
        "r_h": ParamSpec((H, Dh, 4 * Dh), ("heads", None, None), fan_in=Dh),
        "bias": ParamSpec((H, 4 * Dh), ("heads", None), "zeros"),
        "norm_scale": ParamSpec((d,), ("embed",), "ones"),
        "w_down": ParamSpec((d, d), ("embed", "embed_out")),
    }


def _slstm_cell(p, xg, state):
    """xg: (B, H, 4Dh) f32 gate pre-activations; state (c, n, m, h), all
    f32.  `p["r_h"]` and `p["bias"]` in float32."""
    c, n, m, h = state
    rg = torch.einsum("bhd,hdg->bhg", h, p["r_h"])
    g = xg + rg + p["bias"]
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    logf = F.logsigmoid(gf)
    m_new = torch.maximum(logf + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(logf + m - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new, h_new)


def slstm_scan(xg_all, carry, r_h, bias):
    """The sLSTM recurrence over time.  xg_all: (B, T, H, 4Dh) float32
    gate pre-activations; carry: (c, n, m, h), each (B, H, Dh) float32.
    Returns (h of every step (B, T, H, Dh), c, n, m, h)."""
    pc = {"r_h": r_h, "bias": bias}
    carry = tuple(carry)
    hs = []
    for t in range(xg_all.shape[1]):
        carry = _slstm_cell(pc, xg_all[:, t], carry)
        hs.append(carry[3])
    return (torch.stack(hs, dim=1),) + carry


def apply_slstm(cfg, p, x, state=None):
    """sLSTM block: sequential loop over time. x: (B,T,D)."""
    B, T, D = x.shape
    cdt = x.dtype
    f32 = torch.float32
    xg_all = torch.einsum("btd,dhg->bthg", x, p["w_x"].to(cdt)).to(f32)
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    carry = [state[k].to(f32) for k in ("c", "n", "m", "h")]
    # the recurrent weights cast once, not once a step
    r_h, bias = p["r_h"].to(f32), p["bias"].to(f32)
    def run(xg, c, n, m, h, r_h, bias):
        hs, *st = slstm_scan(xg, (c, n, m, h), r_h, bias)
        return (hs.reshape(xg.shape[0], T, D).to(cdt), *st)

    if isinstance(xg_all, DTensor):
        # the recurrence is independent across batch rows: each rank
        # runs its rows on plain tensors
        out, c, n, m, h = batch_local(run, (xg_all, *carry), (r_h, bias))
    else:
        out, c, n, m, h = run(xg_all, *carry, r_h, bias)
    out = rms_norm(out, p["norm_scale"])
    out = out @ p["w_down"].to(cdt)
    return out, {"c": c, "n": n, "m": m, "h": h}


def init_slstm_state(cfg, batch, *, device):
    H, Dh = slstm_dims(cfg)
    return {k: torch.zeros((batch, H, Dh), dtype=torch.float32,
                           device=device) for k in ("c", "n", "m", "h")}


def slstm_state_specs(cfg, batch):
    H, Dh = slstm_dims(cfg)
    sp = ParamSpec((batch, H, Dh), ("batch", "heads", None), "zeros",
                   torch.float32)
    return {"c": sp, "n": sp, "m": sp, "h": sp}
