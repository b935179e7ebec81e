"""The flash-attention backward on the CPU (the wrappers' plain versions)
against the JAX package: `flash_attention_fwd`'s (out, lse) against the
reference's oracle `repro.kernels.ref.flash_attention_ref` and the
log-sum-exp of the same dense scores; `flash_attention_bwd_plain` and
`FlashAttentionFunction` against `jax.vjp` of that oracle and of
`repro.models.attention.attn_flash` (causal, chunked), with the same
cotangent.

Inputs are drawn with numpy and cast to each package's dtype.
Tolerances: the forward within 1e-5 (atol and rtol) in float32; each
gradient within 1e-5 x max|grad| in float32 and 2e-2 x max|grad| in
bfloat16 (the two sides sum in different orders, and at bfloat16 the
backward reads the forward's rounded output)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JRef
from repro.models import attention as JA
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as TA

DT = {"float32": (jnp.float32, torch.float32, 1e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
CHUNK = 16

# (H, KV): MHA, GQA, MQA; S: a multiple of the chunk, below one chunk,
# ragged (attn_flash then runs one chunk of S); D: the tensor-core
# body's smallest width's half, its smallest, danube's padded one, and
# the D = 256 body's: a narrower width read in place and its own
HEADS = [(4, 4), (4, 2), (4, 1)]
SEQS = [64, 12, 40]
DIMS = [8, 16, 120, 160, 256]


def _inputs(rng, B, H, KV, S, D):
    """q, k, v (B, H|KV, S, D) and a cotangent (B, H, S, D), float32."""
    return [rng.normal(size=(B, h, S, D)).astype(np.float32)
            for h in (H, KV, KV, H)]


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) \
        else x.float().numpy()


def _close_to_max(got, want, tol):
    """max|got - want| <= tol x max|want| for each pair."""
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        top = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= tol * top, (np.abs(g - w).max(), top)


def _lse_np(q, k):
    """Each row's natural log-sum-exp of the scaled, causally masked
    scores, in float64."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    s = np.einsum("bhqd,bhsd->bhqs", q.astype(np.float64),
                  np.repeat(k, G, axis=1).astype(np.float64)) * D ** -0.5
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("H,KV", HEADS)
def test_fwd_plain_matches_oracle_and_lse(rng, H, KV, S, D):
    q, k, v, _ = _inputs(rng, 2, H, KV, S, D)
    before = dict(_build.launches)
    o, lse = FA.flash_attention_fwd(*(torch.as_tensor(x) for x in (q, k, v)))
    assert _build.launches == before          # plain version: no launch
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert lse.shape == (2, H, S)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(JRef.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), _lse_np(q, k), atol=1e-5,
                               rtol=1e-5)


def _jax_grads(fn, arrs, jdt):
    """jax.vjp of fn at q, k, v with cotangent `ct` (all cast to jdt)."""
    q, k, v, ct = (jnp.asarray(a, jdt) for a in arrs)

    @jax.jit
    def grads(q, k, v, ct):
        out, vjp = jax.vjp(fn, q, k, v)
        return vjp(ct.astype(out.dtype))

    return grads(q, k, v, ct)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("H,KV", HEADS)
def test_bwd_plain_matches_jax_vjp(rng, H, KV, S, D, dtype):
    """dq, dk, dv of `flash_attention_bwd_plain` from the plain forward's
    (out, lse) against jax.vjp of the reference's dense oracle and of its
    chunked `attn_flash` ((B, S, H, D) layout)."""
    jdt, tdt, tol = DT[dtype]
    arrs = _inputs(rng, 2, H, KV, S, D)
    q, k, v, ct = (torch.as_tensor(a).to(tdt) for a in arrs)
    o, lse = FA.flash_attention_fwd(q, k, v)
    got = FA.flash_attention_bwd(q, k, v, o, lse, ct)
    assert [g.dtype for g in got] == [tdt] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    _close_to_max(got, _jax_grads(JRef.flash_attention_ref, arrs, jdt), tol)

    c = CHUNK if S % CHUNK == 0 else S
    pos = jnp.arange(S)

    def flash(qj, kj, vj):       # (B, H, S, D) <-> attn_flash's layout
        o_ = JA.attn_flash(*(x.transpose(0, 2, 1, 3) for x in (qj, kj, vj)),
                           pos, pos, causal=True, q_chunk=c, kv_chunk=c)
        return o_.transpose(0, 2, 1, 3)

    _close_to_max(got, _jax_grads(flash, arrs, jdt), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", HEADS)
def test_flash_function_matches_jax_attn_flash(rng, H, KV, dtype):
    """The slice as a whole: `FlashAttentionFunction` under autograd on
    (B, S, H, D) tensors (the training layout) against jax.vjp of the
    reference's `attn_flash`; only the inputs that require grad get one."""
    jdt, tdt, tol = DT[dtype]
    B, S, D = 2, 48, 16
    arrs = [a.transpose(0, 2, 1, 3).copy()
            for a in _inputs(rng, B, H, KV, S, D)]
    q, k, v, ct = (torch.as_tensor(a).to(tdt) for a in arrs)
    for t in (q, k, v):
        t.requires_grad_()
    out = TA.FlashAttentionFunction.apply(q, k, v)
    out.backward(ct)
    pos = jnp.arange(S)
    want = _jax_grads(lambda a, b, c: JA.attn_flash(
        a, b, c, pos, pos, causal=True, q_chunk=CHUNK, kv_chunk=CHUNK),
        arrs, jdt)
    _close_to_max([q.grad, k.grad, v.grad], want, tol)
    k2 = k.detach().clone()
    q2 = q.detach().clone().requires_grad_()
    TA.FlashAttentionFunction.apply(q2, k2, v.detach()).backward(ct)
    assert k2.grad is None
    _close_to_max([q2.grad], [q.grad], 0.0)


def test_bwd_checks_shapes_and_device():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="o has shape"):
        FA.flash_attention_bwd(q, k, k, q[:, :2], lse, q)
    with pytest.raises(ValueError, match="lse has shape"):
        FA.flash_attention_bwd(q, k, k, q, lse[..., :4], q)
    with pytest.raises(ValueError, match="divide"):
        k3 = torch.zeros((1, 3, 8, 16))
        FA.flash_attention_bwd(q, k3, k3, q, lse, q)
    m = [x.to("meta") for x in (q, k, k, q, lse, q)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        FA.flash_attention_bwd(*m)
    with pytest.raises(ValueError, match="cpu or cuda"):
        FA.flash_attention_fwd(*m[:3])


# ---------------------------------------------------------------------------
# the model's (B, S, H, D) layout, read in place
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", HEADS)
def test_fwd_bwd_on_model_layout_views(rng, H, KV, dtype):
    """`flash_attention_fwd` and `flash_attention_bwd` on the (B, H, S, D)
    views of (B, S, H, D) tensors give what they give on contiguous
    copies, and the backward's gradients match jax.vjp of the reference's
    oracle given the views."""
    jdt, tdt, tol = DT[dtype]
    B, S, D = 2, 40, 16
    arrs = _inputs(rng, B, H, KV, S, D)
    views = [torch.as_tensor(a.transpose(0, 2, 1, 3).copy()).to(tdt)
             .transpose(1, 2) for a in arrs]
    assert not views[0].is_contiguous()
    copies = [x.contiguous() for x in views]
    o, lse = FA.flash_attention_fwd(*views[:3])
    oc, lsec = FA.flash_attention_fwd(*copies[:3])
    torch.testing.assert_close(o, oc, atol=0, rtol=0)
    torch.testing.assert_close(lse, lsec, atol=0, rtol=0)
    got = FA.flash_attention_bwd(*views[:3], o, lse, views[3])
    want = FA.flash_attention_bwd(*copies[:3], oc, lsec, copies[3])
    _close_to_max(got, want, 1e-6)
    _close_to_max(got, _jax_grads(JRef.flash_attention_ref, arrs, jdt), tol)


def test_require_reads_strided_layouts():
    """`_build.require(..., align=)`, the check the flash wrappers make
    before reading a tensor in place: the transposed view of a (B, S, H,
    D) tensor and a slice of its heads pass; a last axis that is not
    contiguous, a row stride or a start off the byte multiple, and a
    broadcast (stride 0) raise; without `align` a view must be
    contiguous."""
    dev = torch.device("cpu")
    x = torch.zeros((2, 64, 8, 32), dtype=torch.bfloat16)
    view = x.transpose(1, 2)
    _build.require("q", view, torch.bfloat16, (2, 8, 64, 32), dev, align=16)
    _build.require("q", view[:, 2:6], torch.bfloat16, (2, 4, 64, 32), dev,
                   align=16)
    _build.require("q", x[:1, :, :1].transpose(1, 2), torch.bfloat16,
                   (1, 1, 64, 32), dev, align=16)
    with pytest.raises(ValueError, match="must be contiguous"):
        _build.require("q", view, torch.bfloat16, (2, 8, 64, 32), dev)
    bad = {"last axis": view.transpose(2, 3),
           "row stride": torch.zeros((2, 8, 64, 36),
                                     dtype=torch.bfloat16)[..., :32],
           "start": torch.zeros((2 * 8 * 64 * 32 + 4,),
                                dtype=torch.bfloat16)[4:].view(2, 8, 64, 32),
           "broadcast": torch.zeros((2, 1, 64, 32),
                                    dtype=torch.bfloat16).expand(2, 8, 64, 32)}
    for what, t in bad.items():
        with pytest.raises(ValueError, match="contiguous last axis"):
            _build.require(what, t, torch.bfloat16, tuple(t.shape), dev,
                           align=16)
    # one element: the CUDA-core bodies' multiple
    _build.require("q", bad["row stride"], torch.bfloat16, (2, 8, 64, 32),
                   dev, align=2)


# ---------------------------------------------------------------------------
# the tensor-core backward's work list and dq add order (a model of
# csrc/flash_attention.cu::bf16bwd)
# ---------------------------------------------------------------------------


def _cu_const(name):
    src = (Path(FA.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    body = src[src.index("namespace bf16bwd {"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))


def _steps(item, B, H, KV, S, KT, QT):
    """The kernel's walk of one work item: its (batch x head, query tile)
    steps in order (query tiles from the last one down to the diagonal,
    the group's heads inner)."""
    BKV, G, nQ = B * KV, H // KV, -(-S // QT)
    kt, bkv = divmod(item, BKV)
    b, kvh = divmod(bkv, KV)
    return [(b * H + kvh * G + s % G, nQ - 1 - s // G)
            for s in range(G * (nQ - kt * KT // QT))]


def _simulate(B, H, KV, S, blocks, KT, QT):
    """Run the work list on `blocks` persistent blocks, one step a tick,
    items handed out in list order as blocks free up; a step of key tile
    kt that is not its query tile's first add waits until the tile's
    counter reads kt.  Returns (adds per (bh, qi) in order, ticks, steps
    that waited a tick, the list distance of every wait)."""
    BKV, nQ = B * KV, -(-S // QT)
    n_items = BKV * -(-S // KT)
    nxt, count = 0, {}
    adds = {}
    cur = [None] * blocks              # (item, steps, position)
    ticks = waited = 0
    dist = set()
    while True:
        for i in range(blocks):
            if cur[i] is None and nxt < n_items:
                cur[i] = (nxt, _steps(nxt, B, H, KV, S, KT, QT), 0)
                nxt += 1
        if all(c is None for c in cur):
            return adds, ticks, waited, dist
        ticks += 1
        moved = False
        for i, c in enumerate(cur):
            if c is None:
                continue
            item, steps, pos = c
            kt = item // BKV
            bh, qi = steps[pos]
            if count.get((bh, qi), 0) < kt:
                waited += 1
                dist.add(BKV)          # the add before is item - BKV's
                continue
            count[(bh, qi)] = count.get((bh, qi), 0) + 1
            adds.setdefault((bh, qi), []).append(kt)
            moved = True
            cur[i] = None if pos + 1 == len(steps) else (item, steps, pos + 1)
        assert moved, "no block could move: a wait that never ends"


@pytest.mark.parametrize("B,H,KV,S,blocks", [
    (4, 32, 4, 2048, 132),       # yi-6b's shape on the H100's 132 SMs
    (1, 4, 4, 1, 132), (1, 8, 1, 257, 3), (2, 8, 2, 100, 132),
    (2, 16, 8, 1100, 132), (1, 4, 2, 700, 1), (3, 6, 3, 513, 7)])
def test_bwd_work_list_and_dq_add_order(B, H, KV, S, blocks):
    """Every (batch x head, 64-query tile) receives each key tile that has
    a causal pair with it exactly once, in ascending key-tile order (the
    first add key tile 0, the last the diagonal tile); every wait points
    at an item earlier in the list (so taken earlier, by a running block);
    no wait lasts for ever; and at yi-6b's shape the steps that wait are
    under 2 % of all steps."""
    KT, QT = _cu_const("KT"), _cu_const("QT")
    assert (KT, QT) == (128, 64)
    adds, ticks, waited, dist = _simulate(B, H, KV, S, blocks, KT, QT)
    nQ = -(-S // QT)
    assert sorted(adds) == [(bh, qi) for bh in range(B * H)
                            for qi in range(nQ)]
    for (bh, qi), kts in adds.items():
        causal = [kt for kt in range(-(-S // KT))
                  if kt * KT <= min(qi * QT + QT - 1, S - 1)]
        assert kts == causal, ((bh, qi), kts)
        assert kts[-1] == qi * QT // KT          # the diagonal adds last
    assert all(d > 0 for d in dist)
    n_steps = sum(len(v) for v in adds.values())
    if (B, H, KV, S, blocks) == (4, 32, 4, 2048, 132):
        assert waited < 0.02 * n_steps, (waited, n_steps, ticks)


@pytest.mark.parametrize("name", ["base", "no_handoff", "no_finish",
                                  "no_order", "no_turns"])
def test_bwd_ablate_patches_apply(name):
    """`launch.bwd_ablate`'s source variants still find the lines they
    patch in csrc/flash_attention.cu, and each changes only the
    tensor-core backward's namespace."""
    from repro_torch.launch import bwd_ablate as BA
    src = (Path(FA.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    out = BA.variant_source(name)
    a = src.index("namespace bf16bwd {")
    assert out[:a] == src[:a]
    assert out.endswith(src[src.index("}  // namespace bf16bwd"):])
    assert (out == src) == (name == "base")
