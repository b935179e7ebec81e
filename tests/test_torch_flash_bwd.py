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
# body's smallest width's half, its smallest, and danube's padded one
HEADS = [(4, 4), (4, 2), (4, 1)]
SEQS = [64, 12, 40]
DIMS = [8, 16, 120]


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
