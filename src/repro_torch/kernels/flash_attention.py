"""Causal GQA flash-attention forward.

The port of `repro.kernels.flash_attention.flash_attention`
(``csrc/flash_attention.cu``).  Layout as in the reference: q
(B, H, S, D), k and v (B, KV, S, D) with KV | H; query head h reads KV
head h // (H // KV).  The model reaches it through
`repro_torch.models.attention.self_attention` (``impl="flash"``, causal,
no window), where the reference runs the kernel's jnp twin `attn_flash`.

On CPU tensors `flash_attention` runs `flash_attention_plain` (the
reference's dense oracle, `kernels/ref.py`); on CUDA tensors it launches
the kernel or raises.  The kernel takes float32 or bfloat16, D in
{16, 32, 64, 128} and any S (a ragged last tile is masked).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

BQ = 64                  # query rows per block (csrc/flash_attention.cu)
BK = 64                  # keys per KV tile
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_Y = 65_535      # B * H blocks along the grid's y dimension

__all__ = ["flash_attention", "flash_attention_plain", "BQ", "BK"]


def flash_attention(q, k, v, *, bq: int = BQ, bk: int = BK) -> torch.Tensor:
    """Causal self-attention. q: (B,H,S,D); k,v: (B,KV,S,D). Returns
    (B,H,S,D) in q's dtype.  `bq`, `bk` are the tile sizes; the kernel is
    built for 64 x 64 and refuses others (the plain version has no
    tiles)."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, KV, S, D) = ({B}, KV, {S}, {D})")
    if KV == 0 or H % KV:
        raise ValueError(f"KV = {KV} kv heads must divide H = {H}")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    if (bq, bk) != (BQ, BK):
        raise ValueError(f"the kernel is built for {BQ} x {BK} tiles, not "
                         f"bq={bq}, bk={bk}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes "
                        f"{DTYPES}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} > {MAX_GRID_Y}")
    _build.require("q", q, q.dtype, (B, H, S, D), dev)
    _build.require("k", k, q.dtype, (B, KV, S, D), dev)
    _build.require("v", v, q.dtype, (B, KV, S, D), dev)
    o = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_launch",
                         [_build.P] * 4 + [_build.I] * 6
                         + [_build.F, _build.P])
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, S, D, int(q.dtype == torch.bfloat16), D ** -0.5,
                 _build.stream_of(dev))
    _build.check("flash_attention", err)
    _build.launches["flash_attention"] += 1
    return o
