"""Differential depth-probing: per-layer costs from two shallow traces.

The port of `repro.launch.analytic` (pure functions: the port's own
copy).  The reference needs it because XLA's ``cost_analysis()`` counts
a scanned layer loop's body once.  The port's layer loop is Python, so
its dry run traces every layer of the full depth and its totals need no
extrapolation; it still traces the model at depth u and 2u, where u is
the family's repeating unit (1 layer for uniform stacks, one 8-block
group for xlstm, one 6-mamba + shared-attention group for zamba2, one
encoder + decoder layer pair for whisper), and keeps

    per_unit = cost(2u) - cost(u)
    const    = cost(u) - per_unit          # embed/unembed/loss/opt edges
    total    = const + per_unit * n_units  (+ tail correction)

beside the full-depth count as a cross-check (`probe` in the record).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig


def probe_unit(cfg: ModelConfig) -> Tuple[ModelConfig, ModelConfig, float,
                                          float]:
    """Returns (cfg_u, cfg_2u, n_units, tail_units).

    total_cost = const + per_unit * (n_units + tail_units)."""
    if cfg.is_encdec:
        # unit = 1 encoder layer + 1 decoder layer
        u = dataclasses.replace(cfg, n_layers=1, enc_layers=1, dec_layers=1)
        u2 = dataclasses.replace(cfg, n_layers=2, enc_layers=2, dec_layers=2)
        return u, u2, float(cfg.enc_layers), 0.0
    if cfg.xlstm is not None:
        every = cfg.xlstm.slstm_every
        u = dataclasses.replace(cfg, n_layers=every)
        u2 = dataclasses.replace(cfg, n_layers=2 * every)
        return u, u2, float(cfg.n_layers // every), 0.0
    if cfg.ssm is not None and cfg.attn_every:
        per = cfg.attn_every
        g = cfg.n_layers // per
        tail = cfg.n_layers - g * per
        u = dataclasses.replace(cfg, n_layers=per)
        u2 = dataclasses.replace(cfg, n_layers=2 * per)
        # tail mamba layers cost ~ (1/(per+1)) of a group each
        return u, u2, float(g), tail / (per + 1.0)
    u = dataclasses.replace(cfg, n_layers=1)
    u2 = dataclasses.replace(cfg, n_layers=2)
    return u, u2, float(cfg.n_layers), 0.0


def extrapolate(cost_u: dict, cost_2u: dict, n_units: float,
                tail_units: float) -> dict:
    """Per-key linear extrapolation of probe costs to full depth."""
    out = {}
    mult = n_units + tail_units
    for k in cost_u:
        per = cost_2u.get(k, 0.0) - cost_u.get(k, 0.0)
        per = max(per, 0.0)
        const = max(cost_u.get(k, 0.0) - per, 0.0)
        out[k] = const + per * mult
    return out


def slstm_correction_flops(cfg: ModelConfig, shape) -> float:
    """sLSTM's recurrent (h_{t-1} @ R) matmul lives inside a T-step loop
    that the dry run does not trace (T up to 524288); its flops are
    exactly known and added analytically.  Per token per sLSTM layer:
    2 * H * Dh * 4Dh, x3 for train (fwd+bwd) x n_slstm_layers, over the
    shape's global tokens."""
    if cfg.xlstm is None:
        return 0.0
    from repro_torch.models.xlstm import slstm_dims
    H, Dh = slstm_dims(cfg)
    n_slstm = cfg.n_layers // cfg.xlstm.slstm_every
    per_tok = 2.0 * H * Dh * 4 * Dh
    if shape.kind == "train":
        tokens, mult = shape.tokens, 3.0     # fwd + 2x bwd
    elif shape.kind == "prefill":
        tokens, mult = shape.tokens, 1.0
    else:
        tokens, mult = shape.global_batch, 1.0
    return per_tok * tokens * mult * n_slstm
