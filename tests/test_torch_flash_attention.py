"""repro_torch.kernels.flash_attention on the CPU (its plain version)
against the JAX package's Pallas kernel in interpret mode and its
oracle `ref.flash_attention_ref`.

Inputs are drawn with numpy and cast to each package's dtype (bfloat16
rounds the same float32 values to nearest even on both sides).
Tolerances: 2e-5 at float32 and 2e-2 at bfloat16, as the JAX suite's
kernel test (`tests/test_kernels.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JRef
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as TRef
from repro_torch.models.attention import attn_flash

DT = {"float32": (jnp.float32, torch.float32, 2e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(rng, B, H, KV, S, D):
    return (rng.normal(size=(B, H, S, D)).astype(np.float32),
            rng.normal(size=(B, KV, S, D)).astype(np.float32),
            rng.normal(size=(B, KV, S, D)).astype(np.float32))


def _both(arrs, dtype):
    jdt, tdt, _ = DT[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.as_tensor(a).to(tdt) for a in arrs])


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 2, 2, 64, 16),      # MHA
    (2, 4, 2, 128, 32),     # GQA 2:1
    (1, 8, 1, 128, 16),     # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_and_oracle(rng, B, H, KV, S, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(rng, B, H, KV, S, D), dtype)
    before = dict(_build.launches)
    o = FA.flash_attention(tq, tk, tv)
    assert _build.launches == before          # plain version: no launch
    assert o.dtype == tq.dtype and o.shape == (B, H, S, D)
    tol = DT[dtype][2]
    _close(o, JO.flash_attention(jq, jk, jv, bq=32, bk=32), tol)
    _close(o, JRef.flash_attention_ref(jq, jk, jv), tol)


@pytest.mark.parametrize("bq,bk", [(16, 64), (64, 16), (128, 128)])
def test_block_shape_sweep(rng, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(rng, 1, 4, 2, 128, 32),
                                       "float32")
    o = FA.flash_attention(tq, tk, tv, bq=bq, bk=bk)
    _close(o, JO.flash_attention(jq, jk, jv, bq=bq, bk=bk), 2e-5)


@pytest.mark.parametrize("S", [1, 33, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_sequence_matches_oracle(rng, S, dtype):
    """Any S (the Pallas kernel needs tiles that divide S; its oracle and
    the CUDA kernel do not)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(rng, 2, 4, 2, S, 64), dtype)
    _close(FA.flash_attention(tq, tk, tv),
           JRef.flash_attention_ref(jq, jk, jv), DT[dtype][2])


def _emulate_bf16_body(q, k, v, bk=128):
    """The CUDA kernel's bfloat16 arithmetic in plain float32: online
    softmax over 128-key tiles, P rounded to bfloat16 before P.V, the
    denominator summed from the unrounded P."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(G, dim=1) for x in (k, v))
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * D ** -0.5
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        s = s.masked_fill(kpos > qpos, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("B,H,KV,S,D", [(1, 8, 1, 256, 128),
                                        (1, 4, 2, 130, 64)])
def test_bf16_body_arithmetic_within_tolerance(rng, B, H, KV, S, D):
    """Rounding P to bfloat16 before P.V (the tensor-core product) keeps
    the kernel within the 2e-2 bfloat16 tolerance of the JAX oracle."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(rng, B, H, KV, S, D),
                                       "bfloat16")
    got = _emulate_bf16_body(tq, tk, tv).float().numpy()
    want = np.asarray(JRef.flash_attention_ref(jq, jk, jv), np.float32)
    err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2,
                               err_msg=f"max|emulation - oracle| = {err:.3e}")


def test_plain_version_is_the_oracle(rng):
    q, k, v = (torch.as_tensor(a) for a in _inputs(rng, 1, 4, 1, 48, 16))
    assert torch.equal(FA.flash_attention_plain(q, k, v),
                       TRef.flash_attention_ref(q, k, v))


def test_matches_model_chunked_attention(rng):
    """The kernel's layout (B, H, S, D) and the model's (B, S, H, D):
    transposed, the wrapper equals the model's chunked online softmax."""
    B, H, KV, S, D = 2, 4, 2, 128, 16
    q, k, v = (torch.as_tensor(a) for a in _inputs(rng, B, H, KV, S, D))
    pos = torch.arange(S)
    o_model = attn_flash(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), pos, pos, causal=True,
                         q_chunk=32, kv_chunk=32)
    o_kernel = FA.flash_attention(q, k, v).transpose(1, 2)
    torch.testing.assert_close(o_model, o_kernel, atol=2e-5, rtol=0)


def test_wrapper_refuses_bad_shapes():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="must divide"):
        FA.flash_attention(q, torch.zeros((1, 3, 8, 16)),
                           torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError, match="B, KV, S, D"):
        FA.flash_attention(q, torch.zeros((1, 2, 9, 16)),
                           torch.zeros((1, 2, 9, 16)))


@pytest.mark.parametrize("D", [160, 192, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_head_dims_match_pallas_kernel(rng, D, dtype):
    """Head dims above 128 (on the card the D = 256 tensor-core body at
    bfloat16, the CUDA-core wide body at float32): the plain version
    against the reference kernel in interpret mode and its oracle."""
    B, H, KV, S = 1, 4, 2, 96
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(rng, B, H, KV, S, D), dtype)
    o = FA.flash_attention(tq, tk, tv)
    assert o.dtype == tq.dtype and o.shape == (B, H, S, D)
    tol = DT[dtype][2]
    _close(o, JO.flash_attention(jq, jk, jv, bq=32, bk=32), tol)
    _close(o, JRef.flash_attention_ref(jq, jk, jv), tol)


@pytest.mark.parametrize("D,bf16,fp32", [
    (16, ("in place", 16), ("in place", 16)),
    (8, ("in place", 16), ("padded", 16)),
    (12, ("padded", 16), ("padded", 16)),
    (40, ("in place", 64), ("padded", 64)),
    (64, ("in place", 64), ("in place", 64)),
    (72, ("in place", 128), ("padded", 128)),
    (96, ("in place", 128), ("padded", 128)),
    (100, ("padded", 128), ("padded", 128)),
    (120, ("in place", 128), ("padded", 128)),
    (128, ("in place", 128), ("in place", 128)),
    (130, ("padded", 256), ("padded", 256)),
    (160, ("in place", 256), ("in place", 256)),
    (192, ("in place", 256), ("in place", 256)),
    (256, ("in place", 256), ("in place", 256)),
    (512, ("cluster", 512), ("cluster", 512))])
def test_forward_route_by_head_dim(D, bf16, fp32):
    """The forward's route for each head dim: the bodies' own D in place;
    a narrower bfloat16 D whose rows are whole 16-byte units (D % 8 == 0,
    danube's 120; 160 and 192 on the D = 256 body), and a float32 D above
    128 whose rows are whole 16-byte units (D % 4 == 0), in place on the
    next body, TMA zero-filling the rest; other narrower D (every float32
    D below 128 among them) through zero-padded copies; D above 256 (up
    to 2048) the cluster forward."""
    assert FA._forward_route(torch.bfloat16, D) == bf16
    assert FA._forward_route(torch.float32, D) == fp32


_VARIANTS = ["base", "no_store", "no_exp", "stages3", "two_consumers",
             "no_turns", "legacy", "runtime_width", "wide_bk64",
             "wide_o_regs", "wide_no_turns", "wide_one_stage", "f32_body256",
             "f32w_no_exp", "f32w_no_s", "f32w_no_pv", "f32w_one_stage",
             "cl_no_xch", "cl_one_slice"]


@pytest.mark.parametrize("name", _VARIANTS)
def test_fwd_ablate_patches_apply(name):
    """`launch.fwd_ablate`'s variants still find the lines they patch in
    csrc/flash_attention.cu, each exactly once: every variant differs from
    the source but base, and the runtime_width variant only stops choosing
    width 120's own body."""
    from repro_torch.launch import fwd_ablate as FWA
    assert set(FWA.PATCHES) == set(_VARIANTS)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = FWA.variant_source(name)
    assert (out == src) == (name == "base")
    assert ("flash_fwd_bf16_kernel<128, 120>;" in out) == \
        (name != "runtime_width")
    for old, new in FWA.PATCHES[name]:
        assert src.count(old) == 1 and new in out


@pytest.mark.parametrize("preset,shape", [
    ("yi", (4, 32, 4, 2048, 128)), ("zamba2", (4, 32, 32, 2048, 64)),
    ("danube", (4, 32, 8, 2048, 120)), ("whisper", (4, 16, 16, 2048, 64))])
def test_fwd_ablate_shape_presets(preset, shape):
    """`launch.fwd_ablate`'s --shape presets are the models' prefill
    shapes at batch 4 x 2048 tokens: (B, H, KV, S, D) from each config."""
    from repro_torch.configs import get_config
    from repro_torch.launch import fwd_ablate as FWA
    arch = {"yi": "yi-6b", "zamba2": "zamba2-1.2b",
            "danube": "h2o-danube-3-4b", "whisper": "whisper-medium"}[preset]
    cfg = get_config(arch)
    assert FWA.parse_shape(preset) == shape == (
        4, cfg.n_heads, cfg.n_kv_heads, 2048, cfg.head_dim)
    assert FWA.parse_shape("1,2,2,64,16") == (1, 2, 2, 64, 16)
    with pytest.raises(ValueError):
        FWA.parse_shape("1,2,2")


def _wide_body_split(text):
    """(the source less `Fwd<256>` and the D = 256 kernel and launcher,
    those three)."""
    a = text.index("struct Fwd<256> {")
    b = text.index("\n};\n", a)
    c = text.index("// The wide body (Fwd<256>")
    d = text.index("\n}\n", text.index("int launch_wide("))
    return text[:a] + text[b:c] + text[d:], text[a:b] + text[c:d]


@pytest.mark.parametrize("name,old,new", [
    ("wide_bk64", "static constexpr int BK = 80;",
     "static constexpr int BK = 64;"),
    ("wide_o_regs", "tma_store(&to, qa",
     "*reinterpret_cast<__nv_bfloat162*>(op + row * lo.s + col)"),
    ("wide_no_turns", "bar_sync(1 + w);", None)])
def test_fwd_ablate_wide_variants_touch_only_the_wide_body(name, old, new):
    """The D = 256 body's variants change `bf16body::Fwd<256>`, its kernel
    or its launcher and nothing else: 64-key tiles, O written from
    registers in place of the staged TMA store, or no turns."""
    from repro_torch.launch import fwd_ablate as FWA
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = FWA.variant_source(name)
    rest, wide = _wide_body_split(out)
    assert rest == _wide_body_split(src)[0]
    assert old in _wide_body_split(src)[1] and old not in wide
    assert new is None or new in wide


def test_fwd_ablate_wide_preset():
    """`launch.fwd_ablate`'s wide presets: yi's batch and GQA group of 4
    at head dim 256, run by the D = 256 tensor-core body in place, and the
    same in float32 (wide_f32, the float32 D = 256 body); the default
    shapes stay the four model presets."""
    from repro_torch.launch import fwd_ablate as FWA
    assert FWA.parse_shape("wide") == (4, 8, 2, 2048, 256)
    assert FWA.parse_shape("wide_f32") == (4, 8, 2, 2048, 256)
    assert FA._forward_route(torch.bfloat16, 256) == ("in place", 256)
    assert FWA.MODEL_PRESETS == ("yi", "zamba2", "danube", "whisper")
    assert set(FWA.PRESETS) == {*FWA.MODEL_PRESETS, "wide", "wide_f32",
                                "d512", "d512_f32", "d2304", "d2304_f32"}
    assert FWA.FLOAT32_PRESETS == ("wide_f32", "d512_f32", "d2304_f32")
    assert [FWA.dtype_of(s) for s in ("wide", "wide_f32", "yi")] == [
        "bfloat16", "float32", "bfloat16"]
