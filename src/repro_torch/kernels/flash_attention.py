"""Causal GQA flash attention: the forward and its backward.

The forward is the port of `repro.kernels.flash_attention.flash_attention`
(``csrc/flash_attention.cu``).  Layout as in the reference: q
(B, H, S, D), k and v (B, KV, S, D) with KV | H; query head h reads KV
head h // (H // KV).  The model reaches it through
`repro_torch.models.attention.self_attention` (``impl="flash"``, causal,
no window), where the reference runs the kernel's jnp twin `attn_flash`.

On CPU tensors each wrapper runs its plain version (the forward the
reference's dense oracle, `kernels/ref.py`); on CUDA tensors it launches
the kernel or raises.  The kernel takes float32 or bfloat16, any head
dim and any S (a ragged last tile is masked).  Its bodies take D in
`HEAD_DIMS`: {16, 32, 64, 128, 256} in both dtypes.  A head dim below
the largest outside that set runs the body of the next one, with the
real D ** -0.5 as its scale, and zero columns up to the body's width:
they add exact zeros to every score and give output columns that are
dropped, so the answer is the unpadded one.  On the TMA-fed bodies
(bfloat16, and float32 at D = 256) with D a whole number of 16-byte
units (bfloat16: D % 8 == 0, h2o-danube's 120, and 160 or 192 on the
D = 256 body; float32: D % 4 == 0 above 128) the kernel reads the
operands in place and TMA zero-fills those columns in shared memory,
and the output is written at its real width: no copy
(`_forward_route`).  Any other such D gets zero-padded copies, sliced
back after.  The bodies pick their own tiles (`TILES`): bfloat16 runs
both products on the tensor cores (wgmma, TMA-fed) in persistent
blocks, one an SM, that take (batch x head, query tile) items heaviest
first from a counter, 128 query rows x 128 keys (192 x 128 at D = 64,
128 x 80 at D = 256), and store the output from shared memory with
TMA; float32 runs on the CUDA cores, in 64 x 64 tiles up to D = 128
(`f32body`), and above it on `f32wide`: the same persistent schedule
over 64-row items, Q resident, 32-key K and V tiles through a TMA ring
of two, O in registers.  Both dtypes at every D > 256 run the cluster
forward: D is cut into 256-column slices, a cluster of C blocks takes
each work item in each of G walks (`cluster_walks`: G = ceil(slices /
8), C = ceil(slices / G); one walk up to D = 2048), block r of walk g
runs its dtype's D = 256 body and owns slice r + C g, its S sums over its
slices r, r + C, .. below D, and the blocks add their partial S through
distributed shared memory in rank order before the softmax, so that each
forms the same P and then O for its owned columns (in place when D % 8
== 0 at bfloat16, D % 4 == 0 at float32, else zero-padded to the next
such width).  A walk is a launch of its own; above 2048 S is recomputed
once a walk.
`flash_attention_fwd` is the same forward that also returns each row's
log-sum-exp.

`flash_attention_bwd` is the gradient of that forward from (q, k, v, o,
lse, dO); it has no TPU counterpart (the reference differentiates
`attn_flash` with XLA).  bfloat16 at D in `BWD_HEAD_DIMS` (16, 32, 64,
128 and 256) runs FA2's five products on the tensor cores, float32 at D
in `BWD_F32_HEAD_DIMS` (16, 32, 64, 128 and 256) on the CUDA cores in
float32 `fmaf` (`f32bwd`, and `f32widebwd` at 256; TF32 would miss the
float32 contract) (`_backward_route`: other D <= 128 zero-padded as the
forward, the gradients sliced back, since the zero columns change no
score and give zero gradient columns; 128 < D < 256 read in place by
the D = 256 body when D is a whole number of 16-byte units, D % 8 == 0
at bfloat16 and D % 4 == 0 at float32, else zero-padded to 256):
persistent blocks, one per SM, take (batch x KV head, key tile) items in a list
order fixed by the shape; each computes dk and dv in registers and, per
64-query step, a share of dq, which bulk reduce-adds from shared memory
add to a float32 accumulator in ascending key-tile order, held by a
counter per (batch x head, query tile) in device memory (the last key
tile rounds the sum into dq).  Items of 128 keys at bfloat16 up to D =
128, where a writer thread adds the shares; of 64 keys at D = 256, where
the two consumers split D and stage their halves of a share in the
step's Q and dO tiles once those are read, and the producer adds it
before loading the slot again; of 64 keys at float32 (32 keys and
32-query steps at D = 256), where one group of 128 threads computes S, P
and dv and another dP, dS and dk, all 256 the share, which the producer
warp adds while the next step's Q and dO load (`BWD_TILES`,
`BWD_F32_TILES`, `BWD_F32_WIDE_TILES`).  Both dtypes at every D > 256
run the cluster backward, in the forward's slices, clusters and walks
(`cluster_walks`): block r of walk g runs its dtype's D = 256 body and
owns slice r + C g, its S and dP sum over its other slices below D
first (above 2048 only: recomputed once a walk) and then the owned one,
and the blocks add their partial S and dP through distributed shared
memory in rank order before the softmax, so that each forms the same P
and dS and then its owned columns' dv, dk and dq share (in place when D
% 8 == 0 at bfloat16, D % 4 == 0 at float32, else zero-padded to the
next such width; the accumulator and its counters the D = 256 body's
once a slice, one region each).  Every gradient is summed in an order
fixed by the shape, so two runs give the same bits.  Its launches count under
``flash_attention_bwd``.

Layout: the public functions keep the reference's (B, H, S, D), and on
the card every body reads its operands in place: the last axis
contiguous, the start and the other strides multiples of 16 bytes for
the bfloat16 tensor-core bodies, the float32 backward bodies, the
float32 forward at D = 256 and the cluster forward (TMA), of one element
for the others
(the transposed views of the model's (B, S, H, D) tensors are the case
that matters); any other layout raises, nothing is copied to make it
fit.  The outputs (o, dq, dk, dv)
take their input's layout (`torch.empty_like`), so a (B, S, H, D) tensor
seen as (B, H, S, D) gets its result in (B, S, H, D) memory.  lse stays a
contiguous float32 (B, H, S).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

#: the forward bodies' head dims by dtype: float32's and bfloat16's
#: {16, 32, 64, 128} (csrc/flash_attention.cu: f32body, bf16body::Fwd<D>),
#: and each dtype's wide body at 256 (bf16body::Fwd<256> on the tensor
#: cores, f32wide on the CUDA cores); a narrower head dim runs the body of
#: the next one (`_pad`), a wider one the cluster forward
HEAD_DIMS = {torch.float32: (16, 32, 64, 128, 256),
             torch.bfloat16: (16, 32, 64, 128, 256)}
#: the tensor-core backward's head dims (bfloat16; bf16bwd up to 128,
#: widebwd at 256)
BWD_HEAD_DIMS = (16, 32, 64, 128, 256)
#: (keys per work item, queries per step) of each tensor-core backward
#: body, by its head dim
BWD_TILES = {d: (64, 64) if d == 256 else (128, 64) for d in BWD_HEAD_DIMS}
#: the float32 backward bodies' head dims (f32bwd up to 128, f32widebwd at
#: 256) and their (keys per work item, queries per step)
BWD_F32_HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_F32_TILES = (64, 64)
BWD_F32_WIDE_TILES = (32, 32)
#: the cluster forward's and backward's slices (every head dim above 256):
#: CLUSTER_WIDTH columns each, at most CLUSTER_BLOCKS blocks (the portable
#: cluster size) a cluster, in as many walks as that needs
CLUSTER_WIDTH = 256
CLUSTER_BLOCKS = 8
#: (query rows per block or work item, keys per KV tile) of each body, by
#: dtype and the body's head dim
TILES = {torch.float32: {d: (64, 32) if d == 256 else (64, 64)
                         for d in HEAD_DIMS[torch.float32]},
         torch.bfloat16: {d: (192 if d == 64 else 128, 80 if d == 256
                              else 128)
                          for d in HEAD_DIMS[torch.bfloat16]}}
MAX_GRID_Y = 65_535      # blocks along a grid's y dimension (f32body's)
BWD_QT = 64              # queries per step (and per dq counter) of the
                         # persistent backward bodies (32 on f32widebwd)

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_plain", "TILES"]


def _shapes(q, k, v):
    """(B, H, KV, S, D), after checking k and v against q."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, KV, S, D) = ({B}, KV, {S}, {D})")
    if KV == 0 or H % KV:
        raise ValueError(f"KV = {KV} kv heads must divide H = {H}")
    return B, H, KV, S, D


def _on_card(name, q):
    """Raise unless q is a CUDA tensor the kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if q.dtype not in TILES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes "
                        f"{tuple(TILES)}")
    if q.shape[-1] < 1:
        raise ValueError(f"head dim {q.shape[-1]} < 1")


def _pad(D, dims=HEAD_DIMS[torch.bfloat16]):
    """The body's head dim that head dim D <= max(dims) runs at."""
    return next(d for d in dims if d >= D)


def _in_place(dtype, D, body):
    """Whether a TMA-fed body of head dim `body` reads head dim D < body
    in place: its rows whole 16-byte units (D % 8 == 0 at bfloat16, any
    bfloat16 body; D % 4 == 0 at float32, the D = 256 bodies)."""
    if dtype == torch.bfloat16:
        return D % 8 == 0
    return body == 256 and D % 4 == 0


def cluster_walks(width):
    """(C, G) of the cluster routes for operands `width` > 256 wide, as
    ``clusterbwd::walks`` takes them: n = ceil(width / 256) slices, G =
    ceil(n / CLUSTER_BLOCKS) walks, C = ceil(n / G) blocks a cluster; in
    walk g block r owns slice r + C g."""
    n = -(-width // CLUSTER_WIDTH)
    if n < 2:
        raise ValueError(f"width {width} <= {CLUSTER_WIDTH}: no cluster")
    G = -(-n // CLUSTER_BLOCKS)
    return -(-n // G), G


def _cluster_width(dtype, D):
    """The operands' width on the cluster routes (256 < D): D when a row
    is whole 16-byte units (D % 8 == 0 at bfloat16, D % 4 == 0 at
    float32), else the next such width, D zero-padded to it."""
    unit = 8 if dtype == torch.bfloat16 else 4
    return -(-D // unit) * unit


def _forward_route(dtype, D):
    """How the forward runs head dim D at `dtype`: (route, body head
    dim), route "in place" (the operands as they are, the body's columns
    past D zero-filled by TMA when D < body), "padded" (zero-padded copies
    of q, k, v, and the output sliced back) or "cluster" (every D > 256:
    the cluster forward, clusters of `Fwd<256>` or `f32wide` blocks in
    `cluster_walks`, its width `_cluster_width`'s)."""
    dims = HEAD_DIMS[dtype]
    if D > dims[-1]:
        return "cluster", _cluster_width(dtype, D)
    body = _pad(D, dims)
    if body == D or _in_place(dtype, D, body):
        return "in place", body
    return "padded", body


def _backward_route(dtype, D):
    """How the backward runs head dim D at `dtype`: (route, body head
    dim), route "in place" (the operands as they are; at 128 < D < 256
    the D = 256 body's columns past D zero-filled by TMA), "padded"
    (zero-padded copies of q, k, v, o and dO, the gradients sliced back)
    or "cluster" (every D > 256: the cluster backward, its width
    `_cluster_width`'s: D when a row is whole 16-byte units, else the next
    such width, D zero-padded to it).  The bodies of the first two:
    bfloat16's `bf16bwd` (D <= 128) and `widebwd` (D = 256) on the tensor
    cores, float32's `f32bwd` (D <= 128) and `f32widebwd` (D = 256) on the
    CUDA cores; of the cluster route, clusters of `widebwd` or
    `f32widebwd` blocks in `cluster_walks`."""
    dims = BWD_HEAD_DIMS if dtype == torch.bfloat16 else BWD_F32_HEAD_DIMS
    if D > dims[-1]:
        return "cluster", _cluster_width(dtype, D)
    body = _pad(D, dims)
    if body == D or (body == 256 and _in_place(dtype, D, body)):
        return "in place", body
    return "padded", body


def _bwd_schedule(B, KV, S, D, device, dtype=torch.bfloat16) -> dict:
    """How the backward's persistent body schedules B x KV heads of S rows
    at head dim D on `device` (bfloat16 D <= 256 on the tensor cores,
    float32 D <= 256 on `f32bwd` and `f32widebwd`, both dtypes above on
    the cluster backward), as its launcher decides it
    (``flash_attention_bwd_info``): keys of a work item, queries of a
    step, the work items, the grid of persistent blocks, its clusters, the
    blocks a cluster, C (1 but on the cluster route), and the walks, G
    (launches of that grid: 1 but above 2048)."""
    route, body = _backward_route(dtype, D)
    info = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = _build.function("flash_attention", "flash_attention_bwd_info",
                              [_build.I] * 5 + [_build.P])(
            B, KV, S, D if route == "in place" else body,
            int(dtype == torch.bfloat16), info)
    _build.check("flash_attention", err)
    return dict(keys=info[0], queries=info[1], items=info[2], grid=info[3],
                clusters=info[4], C=info[5], G=info[6])


def _align(q, D, dims=HEAD_DIMS[torch.bfloat16], f32_dims=()):
    """The byte multiple the kernels need of an operand's start and
    strides: 16 for the bfloat16 tensor-core bodies of head dims `dims`
    and the float32 bodies of head dims `f32_dims` (TMA maps, paired or
    float4 stores), one element for the others."""
    tma = dims if q.dtype == torch.bfloat16 else f32_dims
    return 16 if D in tma else q.element_size()


def _bwd_acc_columns(dtype, width):
    """The columns of the cluster backward's dq accumulator for operands
    `width` wide: 256 a slice, the last slice's as wide as its columns
    (rounded up to 64 at bfloat16, whose tiles are 64-column parts)."""
    return -(-width // 64) * 64 if dtype == torch.bfloat16 else width


def _fwd_align(q, route, body):
    """The byte multiple the forward needs of an operand's start and
    strides on `route` at `body`'s head dim: 16 on the TMA-fed bodies (the
    bfloat16 tensor-core bodies, float32 at D = 256, the cluster forward),
    one element on `f32body`."""
    if route == "cluster":
        return 16
    return _align(q, body, f32_dims=(256,))


def _bwd_align(q, route, body):
    """The byte multiple the backward needs of an operand's start and
    strides: 16, every backward body being TMA-fed."""
    if route == "cluster":
        return 16
    return _align(q, body, BWD_HEAD_DIMS, BWD_F32_HEAD_DIMS)


def _strides(*ts):
    """The kernels' stride array: (batch, head, row) element strides of
    each (B, heads, S, D) tensor in turn, a dim of size 1 given the
    stride D (never stepped, and a multiple of 16 bytes wherever the
    kernels' maps need one)."""
    vals = [t.stride(i) if t.shape[i] > 1 else t.shape[-1]
            for t in ts for i in range(3)]
    return (_build.L * len(vals))(*vals)


def flash_attention(q, k, v, *, bq=None, bk=None) -> torch.Tensor:
    """Causal self-attention. q: (B,H,S,D); k,v: (B,KV,S,D). Returns
    (B,H,S,D) in q's dtype.  `bq`, `bk` name tile sizes: None means the
    kernel's own (`TILES`), and the kernel refuses any other value (the
    plain version has no tiles and ignores them)."""
    _shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _on_card("flash_attention", q)
    if (bq, bk) != (None, None):
        dims = HEAD_DIMS[q.dtype]
        tq, tk = TILES[q.dtype][_pad(min(q.shape[-1], dims[-1]), dims)]
        raise ValueError(f"the kernel uses its own {tq} x {tk} tiles at "
                         f"{q.dtype}: pass bq=None, bk=None, not bq={bq}, "
                         f"bk={bk}")
    return _forward(q, k, v, with_lse=False)[0]


def flash_attention_fwd(q, k, v):
    """The forward of `flash_attention` that also returns each row's
    natural log-sum-exp: (out (B, H, S, D) in q's dtype, lse (B, H, S)
    float32), the inputs of `flash_attention_bwd`.  One launch, counted
    under ``flash_attention``."""
    _shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, return_lse=True)
    _on_card("flash_attention_fwd", q)
    return _forward(q, k, v, with_lse=True)


def _fwd_schedule(B, H, S, D, device, dtype=torch.bfloat16) -> dict:
    """How a persistent forward body schedules B x H heads of S rows at
    head dim D on `device` (bfloat16 D <= 256 on the tensor cores,
    float32 128 < D <= 256 on `f32wide`, both dtypes above on the cluster
    forward), as its launcher decides it (``flash_attention_fwd_info``):
    query rows and keys of a work item's tiles, the work items, the grid
    of persistent blocks, its clusters, the blocks a cluster, C (1 but on
    the cluster route), and the walks, G (launches of that grid: 1 but
    above 2048)."""
    route, body = _forward_route(dtype, D)
    if dtype == torch.float32 and body <= 128:
        raise ValueError(f"D = {D} at {dtype} runs a body with one block "
                         "a query tile, not a persistent schedule")
    info = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = _build.function("flash_attention", "flash_attention_fwd_info",
                              [_build.I] * 5 + [_build.P])(
            B, H, S, body, int(dtype == torch.bfloat16), info)
    _build.check("flash_attention", err)
    return dict(rows=info[0], keys=info[1], items=info[2], grid=info[3],
                clusters=info[4], C=info[5], G=info[6])


def _forward(q, k, v, *, with_lse):
    """Check and launch the forward on CUDA tensors; (out, lse or None)."""
    B, H, KV, S, D = _shapes(q, k, v)
    dev = q.device
    route, Dp = _forward_route(q.dtype, D)
    # the grid of f32body (float32 up to 128) has B * H blocks along y;
    # the other bodies' is one persistent block per SM (or cluster)
    if q.dtype == torch.float32 and Dp <= 128 and B * H > MAX_GRID_Y:
        raise ValueError(f"{B * H} blocks along the grid's y dimension > "
                         f"{MAX_GRID_Y}")
    if Dp > D and route in ("padded", "cluster"):
        # zero columns: exact zeros in every score
        q, k, v = (torch.nn.functional.pad(x, (0, Dp - D)) for x in (q, k, v))
    width = q.shape[-1]     # the operands' (D in place; the body's padded)
    align = _fwd_align(q, route, Dp)
    _build.require("q", q, q.dtype, (B, H, S, width), dev, align=align)
    _build.require("k", k, q.dtype, (B, KV, S, width), dev, align=align)
    _build.require("v", v, q.dtype, (B, KV, S, width), dev, align=align)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    lse_ptr = lse.data_ptr() if with_lse else None
    bf16 = int(q.dtype == torch.bfloat16)
    o = torch.empty_like(q)         # q's layout: the model's, read in place
    strides = _strides(q, k, v, o)
    fn = _build.function("flash_attention", "flash_attention_launch",
                         [_build.P] * 6 + [_build.I] * 7
                         + [_build.F, _build.P])
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse_ptr, strides, B, H, KV, S, Dp, width, bf16, D ** -0.5,
                 _build.stream_of(dev))
    _build.check("flash_attention", err)
    _build.launches["flash_attention"] += 1
    return (o if width == D else o[..., :D].contiguous()), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """dq, dk, dv of causal GQA attention by dense float32 math (float64
    for float64 inputs), from the forward's o and lse (P = exp(s D^-0.5 -
    lse)); each in its input's dtype.  O(S^2) memory: for tests and the
    smoke's comparisons."""
    B, H, KV, S, D = _shapes(q, k, v)
    G = H // KV
    f32 = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = D ** -0.5
    qg = q.reshape(B, KV, G, S, D).to(f32)
    dog = do.reshape(B, KV, G, S, D).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(s.masked_fill(~mask, -1e30) - lse.reshape(B, KV, G, S, 1))
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    delta = (dog * o.reshape(B, KV, G, S, D).to(f32)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q, k, v, o, lse, do):
    """Gradients (dq (B, H, S, D), dk, dv (B, KV, S, D), in q's dtype) of
    causal attention with output o and log-sum-exp lse
    (`flash_attention_fwd`'s) under the cotangent do (B, H, S, D).  CPU
    tensors run `flash_attention_bwd_plain`; CUDA tensors launch the
    kernel (one count under ``flash_attention_bwd``) or raise."""
    B, H, KV, S, D = _shapes(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, H, S, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, H, S, D)}")
    if tuple(lse.shape) != (B, H, S):
        raise ValueError(f"lse has shape {tuple(lse.shape)}, expected "
                         f"{(B, H, S)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    _on_card("flash_attention_bwd", q)
    dev = q.device
    bf16 = q.dtype == torch.bfloat16
    route, Dp = _backward_route(q.dtype, D)
    _build.require("lse", lse, torch.float32, (B, H, S), dev)
    if Dp > D and route in ("padded", "cluster"):
        # zero columns: no score changes, zero gradient columns
        q, k, v, o, do = (torch.nn.functional.pad(x, (0, Dp - D))
                          for x in (q, k, v, o, do))
    width = q.shape[-1]     # the operands' (D in place; the body's padded)
    align = _bwd_align(q, route, Dp)
    for name, t in (("q", q), ("o", o), ("do", do)):
        _build.require(name, t, q.dtype, (B, H, S, width), dev, align=align)
    _build.require("k", k, q.dtype, (B, KV, S, width), dev, align=align)
    _build.require("v", v, q.dtype, (B, KV, S, width), dev, align=align)
    dq = torch.empty_like(q)        # each in its input's layout
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    if route == "cluster":
        # per 256-column slice, the D = 256 body's accumulator (a qt x 256
        # tile for each (batch x head, query tile), the last slice's only
        # as wide as its columns, in 64-column parts at bfloat16) and
        # counters (C G regions: the walks' slices past the width count
        # too); then each walk's work-item counter
        C, G = cluster_walks(width)
        qt = BWD_QT if bf16 else BWD_F32_WIDE_TILES[1]
        nq = B * H * -(-S // qt)
        ws = torch.empty((nq * qt * _bwd_acc_columns(q.dtype, width),),
                         dtype=torch.float32, device=dev)
        sem = torch.empty((C * G * nq + G,), dtype=torch.int32, device=dev)
    else:
        # dq's float32 accumulator (a qt x Dp tile for each (batch x head,
        # query tile)), its counters and the work-item counter
        qt = BWD_F32_WIDE_TILES[1] if not bf16 and Dp == 256 else BWD_QT
        nq = B * H * -(-S // qt)
        ws = torch.empty((nq * qt * Dp,), dtype=torch.float32, device=dev)
        sem = torch.empty((nq + 1,), dtype=torch.int32, device=dev)
    fn = _build.function("flash_attention", "flash_attention_bwd_launch",
                         [_build.P] * 13 + [_build.I] * 6
                         + [_build.F, _build.P])
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(), ws.data_ptr(),
                 sem.data_ptr(),
                 _strides(q, k, v, o, do, dq, dk, dv), B, H, KV, S, width,
                 int(bf16), D ** -0.5, _build.stream_of(dev))
    _build.check("flash_attention", err)
    _build.launches["flash_attention_bwd"] += 1
    if width != D:
        dq, dk, dv = (x[..., :D].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv
