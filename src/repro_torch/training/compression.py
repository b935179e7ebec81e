"""Gradient compression: the port of `repro.training.compression`.

int8 block quantization with error feedback: each gradient leaf is cut
into blocks of BLOCK values, each block scaled by max|block| / 127 and
rounded to int8 (half to even, as `jnp.round`), and the residual of the
rounding is fed back into the next step's gradient (EF-SGD).  The
reference uses it for the cross-pod all-reduce; on one card
`int8_roundtrip` is the wire format simulated inline, as the
reference's `make_train_step` does.  Trees are nested dicts or a
`ParamTree` (see `trees`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.training.trees import build, items, tree_map

BLOCK = 256


class EFState:
    """Error-feedback residual tree (float32, one leaf per param)."""

    def __init__(self, params):
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)


def _quant_block(g32):
    orig_shape = tuple(g32.shape)
    flat = g32.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, orig_shape, pad


def _dequant_block(q, scale, orig_shape, pad):
    deq = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        deq = deq[:-pad]
    return deq.reshape(orig_shape)


def quantize_tree(grads):
    """Every leaf as its (int8 blocks, float32 scales, shape, pad)."""
    return tree_map(lambda g: _quant_block(g.to(torch.float32)), grads)


def int8_roundtrip(grads):
    """Quantize -> dequantize each gradient leaf (the wire format), back
    in the leaf's dtype."""
    def rt(g):
        return _dequant_block(*_quant_block(g.to(torch.float32))).to(
            g.dtype)
    return tree_map(rt, grads)


def compress_with_feedback(grads, ef: EFState):
    """EF-SGD: g' = Q(g + residual); residual = (g + residual) - g'."""
    residual = dict(items(ef.residual))
    new_g, new_r = [], []
    for path, g in items(grads):
        tot = g.to(torch.float32) + residual[path]
        deq = _dequant_block(*_quant_block(tot))
        new_g.append((path, deq.to(g.dtype)))
        new_r.append((path, tot - deq))
    ef.residual = build(new_r)
    return build(new_g)
