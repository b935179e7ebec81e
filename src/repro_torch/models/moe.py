"""Mixture-of-Experts FFN: top-k routing with sort-based dispatch.

The port of `repro.models.moe`.  Each batch row routes on its own (the
reference vmaps `_route_row` over rows; here the row is a batch
dimension of the same tensor ops): its S * top_k (token, expert) pairs
are sorted by expert id, stably, packed into (E, capacity) buckets, run
through a batched expert product, and added back to their tokens with
their gate weights.  Pairs past an expert's capacity are dropped (they
contribute zero): the standard capacity-factor semantics, cf = 1.25 by
default.

Three orders decide which pairs are kept and what their sums are, and
the port keeps the reference's in each:
  * the top-k experts of a token: by probability, a tie to the lower
    expert id (`jax.lax.top_k`'s order; `torch.topk` promises none);
  * the sort by expert id is stable, so within a bucket pairs keep
    token order, and a pair's place in its bucket is its index minus
    the bucket's first (`searchsorted`, side "left");
  * a token's up to top_k contributions are added one at a time in
    the sorted order (ascending expert id), starting from zero: the
    reference's `.at[t_sorted].add` on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import ParamSpec, ashard, batch_local


def moe_specs(cfg):
    d = cfg.d_model
    m = cfg.moe
    sp = {
        "router": ParamSpec((d, m.num_experts), ("embed", "experts")),
        "w_gate": ParamSpec((m.num_experts, d, m.expert_d_ff),
                            ("experts", "embed", "mlp"), fan_in=d),
        "w_up": ParamSpec((m.num_experts, d, m.expert_d_ff),
                          ("experts", "embed", "mlp"), fan_in=d),
        "w_down": ParamSpec((m.num_experts, m.expert_d_ff, d),
                            ("experts", "mlp", "embed"), fan_in=m.expert_d_ff),
    }
    if m.num_shared:
        sp["shared"] = {
            "w_gate": ParamSpec((d, m.shared_d_ff), ("embed", "mlp")),
            "w_up": ParamSpec((d, m.shared_d_ff), ("embed", "mlp")),
            "w_down": ParamSpec((m.shared_d_ff, d), ("mlp", "embed")),
        }
        # qwen2-moe gates the shared expert with a sigmoid scalar
        sp["shared_gate"] = ParamSpec((d, 1), ("embed", None))
    return sp


def _capacity(tokens: int, num_experts: int, top_k: int, cf: float) -> int:
    c = int(tokens * top_k * cf / num_experts) + 1
    return min(max(c, top_k), tokens)


def _top_k(probs, k: int):
    """The k largest of the last axis, largest first, a tie to the lower
    index: `jax.lax.top_k`'s order, from a stable sort."""
    order = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return probs.gather(-1, order), order


def _route(x, router_logits, w_gate, w_up, w_down, top_k: int, cf: float):
    """Every batch row routed on its own. x: (B, S, D); router_logits:
    (B, S, E).  Returns (out (B, S, D), keep (B, S * top_k) bool in the
    sorted order, t_sorted (B, S * top_k): the token of each sorted
    pair)."""
    B, S, D = x.shape
    E = router_logits.shape[-1]
    dev = x.device
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, expert_idx = _top_k(probs, top_k)                 # (B,S,k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)               # renormalize

    flat_expert = expert_idx.reshape(B, -1)                      # (B,S*k)
    flat_token = torch.arange(S, device=dev).repeat_interleave(top_k)
    flat_gate = gate_vals.reshape(B, -1)

    order = torch.argsort(flat_expert, dim=-1, stable=True)
    e_sorted = flat_expert.gather(-1, order)
    t_sorted = flat_token[order]
    g_sorted = flat_gate.gather(-1, order)

    # position within each expert's bucket
    starts = torch.searchsorted(e_sorted, e_sorted, side="left")
    pos = torch.arange(S * top_k, device=dev) - starts
    C = _capacity(S, E, top_k, cf)
    keep = pos < C
    dest = torch.where(keep, e_sorted * C + pos,
                       torch.full_like(pos, E * C))              # overflow

    # pack tokens into (E*C+1, D) a row; the +1 row swallows dropped pairs
    rows = torch.arange(B, device=dev)[:, None]
    buf = torch.zeros((B, E * C + 1, D), dtype=x.dtype, device=dev)
    buf[rows, dest] = x[rows, t_sorted]
    buf = buf[:, :-1].reshape(B, E, C, D).transpose(0, 1).reshape(
        E, B * C, D)

    # batched expert FFN (swiglu), one product per expert
    cdt = x.dtype
    g = torch.bmm(buf, w_gate.to(cdt))
    u = torch.bmm(buf, w_up.to(cdt))
    out_buf = torch.bmm(F.silu(g) * u, w_down.to(cdt))
    out_buf = out_buf.reshape(E, B, C, D).transpose(0, 1).reshape(
        B, E * C, D)

    # back to the tokens with their gates
    contrib = out_buf[rows, torch.clamp(dest, max=E * C - 1)] * \
        g_sorted[..., None].to(cdt)
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros((), dtype=cdt, device=dev))
    # each token's pairs, in sorted order: the token's experts ascending
    by_token = torch.argsort(t_sorted, dim=-1, stable=True).reshape(
        B, S, top_k)
    out = torch.zeros((B, S, D), dtype=cdt, device=dev)
    for j in range(top_k):
        out = out + contrib[rows, by_token[..., j]]
    return out, keep, t_sorted


def _route_row(x, router_logits, w_gate, w_up, w_down, top_k: int,
               cf: float):
    """One batch row. x: (S, D); router_logits: (S, E). Returns (S, D)."""
    return _route(x[None], router_logits[None], w_gate, w_up, w_down,
                  top_k, cf)[0][0]


def apply_moe(cfg, p, x):
    """x: (B, S, D) -> (B, S, D).  Routed experts + optional shared block."""
    m = cfg.moe
    cdt = x.dtype
    router_logits = x @ p["router"].to(cdt)
    weights = (p["w_gate"], p["w_up"], p["w_down"])
    if isinstance(x, DTensor):
        # routing has data-dependent indexing that DTensor has no rule
        # for: each rank routes its batch rows, the experts gathered
        routed = batch_local(
            lambda xs, ls, *w: _route(xs, ls, *w, m.top_k,
                                      m.capacity_factor)[0],
            (x, router_logits), weights)
    else:
        routed = _route(x, router_logits, *weights, m.top_k,
                        m.capacity_factor)[0]
    routed = ashard(routed, "batch", "seq", "embed")
    if m.num_shared:
        sh = p["shared"]
        h = F.silu(x @ sh["w_gate"].to(cdt)) * (x @ sh["w_up"].to(cdt))
        shared_out = h @ sh["w_down"].to(cdt)
        sg = torch.sigmoid(x @ p["shared_gate"].to(cdt))
        routed = routed + sg * shared_out
    return routed


def aux_load_balance_loss(cfg, p, x):
    """Switch-style load-balance auxiliary loss (used by train loop)."""
    m = cfg.moe
    logits = x @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    def hard_of(pr):
        _, idx = _top_k(pr, m.top_k)
        return F.one_hot(idx, m.num_experts).sum(-2).float()  # (B,S,E)

    hard = (batch_local(hard_of, (probs,)) if isinstance(probs, DTensor)
            else hard_of(probs))
    frac_tokens = hard.mean((0, 1)) / m.top_k
    frac_probs = probs.mean((0, 1))
    return m.num_experts * torch.sum(frac_tokens * frac_probs)
