"""Plain PyTorch oracles for every kernel (the allclose ground truth)."""
from __future__ import annotations

import torch

from repro_torch.core.gee import (edge_contributions, make_w,
                                  scatter_add_ordered)


def gee_scatter_ref(dst, cls, val, n: int, K: int) -> torch.Tensor:
    """Segment-sum oracle for the gee_scatter kernel (each entry summed
    in list order)."""
    Z = torch.zeros((n, K), dtype=torch.float32, device=dst.device)
    return scatter_add_ordered(Z, dst, cls, val)


def gee_ref(u, v, w, Y, n: int, K: int) -> torch.Tensor:
    Wv = make_w(Y, K)
    dst, cls, val = edge_contributions(u, v, w.to(torch.float32), Y, Wv)
    return gee_scatter_ref(dst, cls, val, n, K)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        return_lse: bool = False):
    """q: (B, H, S, D); k, v: (B, KV, S, D) with KV | H (GQA).  With
    `return_lse`, (out, lse): lse (B, H, S) float32 is each row's natural
    log-sum-exp of its scaled, masked scores (the backward's input)."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, D).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg,
                     k.to(torch.float32)) * (D ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    o = o.reshape(B, H, S, D).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, S)
    return o
