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
{16, 32, 64, 128} and any S (a ragged last tile is masked).  A head dim
below 128 outside that set is zero-padded on the last axis to the next
one and launched with the real D ** -0.5 as its scale: the zero columns
add exact zeros to every score and give zero output columns, which are
sliced off, so the answer is the unpadded one.  D > 128 raises.  Its two
bodies pick their own tiles: bfloat16 runs both products on the tensor
cores (wgmma, TMA-fed) in 128 x 128 tiles, float32 runs on the CUDA cores
in 64 x 64 tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

#: (query rows per block, keys per KV tile) of each body
#: (csrc/flash_attention.cu)
TILES = {torch.float32: (64, 64), torch.bfloat16: (128, 128)}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GRID_Y = 65_535      # blocks along a grid's y dimension

__all__ = ["flash_attention", "flash_attention_plain", "TILES"]


def flash_attention(q, k, v, *, bq=None, bk=None) -> torch.Tensor:
    """Causal self-attention. q: (B,H,S,D); k,v: (B,KV,S,D). Returns
    (B,H,S,D) in q's dtype.  `bq`, `bk` name tile sizes: None means the
    kernel's own (`TILES`), and the kernel refuses any other value (the
    plain version has no tiles and ignores them)."""
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
    if q.dtype not in TILES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes "
                        f"{tuple(TILES)}")
    if (bq, bk) != (None, None):
        tq, tk = TILES[q.dtype]
        raise ValueError(f"the kernel uses its own {tq} x {tk} tiles at "
                         f"{q.dtype}: pass bq=None, bk=None, not bq={bq}, "
                         f"bk={bk}")
    if not 1 <= D <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {D} outside [1, {HEAD_DIMS[-1]}]: the "
                         f"kernel's bodies take D in {HEAD_DIMS}, and a "
                         "smaller D is padded to the next of them")
    # the grid's y dimension: B * H (float32 body) or the query tiles
    # (bfloat16 body)
    grid_y = B * H if q.dtype == torch.float32 else -(-S // TILES[q.dtype][0])
    if grid_y > MAX_GRID_Y:
        raise ValueError(f"{grid_y} blocks along the grid's y dimension > "
                         f"{MAX_GRID_Y}")
    _build.require("q", q, q.dtype, (B, H, S, D), dev)
    _build.require("k", k, q.dtype, (B, KV, S, D), dev)
    _build.require("v", v, q.dtype, (B, KV, S, D), dev)
    Dp = next(d for d in HEAD_DIMS if d >= D)
    if Dp != D:         # zero columns: exact zeros in every score
        q, k, v = (torch.nn.functional.pad(x, (0, Dp - D)) for x in (q, k, v))
    o = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_launch",
                         [_build.P] * 4 + [_build.I] * 6
                         + [_build.F, _build.P])
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, S, Dp, int(q.dtype == torch.bfloat16), D ** -0.5,
                 _build.stream_of(dev))
    _build.check("flash_attention", err)
    _build.launches["flash_attention"] += 1
    return o if Dp == D else o[..., :D].contiguous()
