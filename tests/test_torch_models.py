"""repro_torch.configs / models against the JAX package on the CPU.

Layers take the same numpy inputs in both packages (float32, atol
1e-5).  The model runs a reduced yi-6b (MQA: one KV head), a GQA
variant (2 KV heads), a sliding-window variant and one with a padded
vocabulary, with the reference's `init_params` weights carried over by
`params_from_jax`.

Model tolerance: logits atol 1e-3 (the JAX suite's own between its two
attention paths, `tests/test_serve.py`); caches atol 1e-3 + rtol 1e-4
(their entries reach tens).  At float32 this model's attention scores
reach hundreds, so the softmax magnifies summation-order rounding well
past float32's step, in each package alike: 1e-4 does not hold between
two correct implementations here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, list_archs
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

VARIANTS = {"mqa": {}, "gqa": {"n_kv_heads": 2}, "swa": {"swa_window": 32},
            "padded": {"vocab": 250}}
LOGITS = dict(atol=1e-3, rtol=0)
CACHE = dict(atol=1e-3, rtol=1e-4)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(t, j, atol, rtol=0):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_lists_only_ported_archs():
    """The port runs every arch of the reference's registry, in order."""
    assert list_archs() == j_list_archs()
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# (arch, reduced) for every arch; yi-6b's cases keep their ids
ARCH_CASES = [pytest.param(a, r, id=str(r) if a == "yi-6b" else f"{a}-{r}")
              for a in j_list_archs() for r in (False, True)]


@pytest.mark.parametrize("arch,reduced", ARCH_CASES)
def test_config_fields_equal_reference(arch, reduced):
    t, j = get_config(arch), j_get_config(arch)
    if reduced:
        t, j = t.reduced(), j.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.padded_vocab == j.padded_vocab


@pytest.mark.parametrize("arch,reduced", ARCH_CASES)
def test_param_count_equals_reference(arch, reduced):
    t, j = get_config(arch), j_get_config(arch)
    if reduced:
        t, j = t.reduced(), j.reduced()
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    if arch == "yi-6b" and not reduced:
        assert 6.0e9 < t.param_count() < 6.1e9


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_layer_norm(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    s = rng.normal(size=64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(s)), JL.rms_norm(x, s), 1e-5)
    _close(TL.layer_norm(_t(x), _t(s), _t(b)), JL.layer_norm(x, s, b), 1e-5)


def test_rms_norm_rounding_order_at_bfloat16(rng):
    """Normalize in float32, cast, then scale in bfloat16: the same bits
    as the reference wherever the float32 normalize agrees."""
    x = rng.normal(size=(4, 64)).astype(np.float32)
    s = rng.normal(size=64).astype(np.float32)
    t = TL.rms_norm(_t(x).bfloat16(), _t(s))
    j = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s))
    assert t.dtype == torch.bfloat16
    _close(t, j, 2e-2)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_apply_rope(rng, theta):
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = np.arange(3, 15)
    _close(TL.apply_rope(_t(x), _t(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp(rng, act):
    jcfg = dataclasses.replace(j_get_config("yi-6b").reduced(), act=act)
    tcfg = dataclasses.replace(get_config("yi-6b").reduced(), act=act)
    specs = TL.mlp_specs(tcfg, 64, 128)
    p = {k: (rng.normal(size=s.shape) / 8).astype(np.float32)
         for k, s in specs.items()}
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    _close(TL.apply_mlp(tcfg, {k: _t(v) for k, v in p.items()}, _t(x)),
           JL.apply_mlp(jcfg, p, x), 1e-5)


def _qkv(rng, B=2, S=64, H=4, KV=2, D=16):
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, KV, D)).astype(np.float32),
            rng.normal(size=(B, S, KV, D)).astype(np.float32))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 24)])
def test_attn_full(rng, causal, window):
    q, k, v = _qkv(rng)
    pos = np.arange(64)
    _close(TA.attn_full(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                        causal=causal, window=window),
           JA.attn_full(q, k, v, pos, pos, causal=causal, window=window),
           1e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_attn_flash(rng, window):
    q, k, v = _qkv(rng)
    pos = np.arange(64)
    kw = dict(causal=True, window=window, q_chunk=16, kv_chunk=32)
    _close(TA.attn_flash(_t(q), _t(k), _t(v), _t(pos), _t(pos), **kw),
           JA.attn_flash(q, k, v, jnp.asarray(pos), jnp.asarray(pos), **kw),
           1e-5)


@pytest.mark.parametrize("window", [0, 24, 40])
def test_attn_triangular(rng, window):
    """The lower-triangular block loop, with and without a window (24 <
    chunk 32: left-of-window blocks skipped; 40: a window spanning two
    chunks)."""
    q, k, v = _qkv(rng, S=96)
    pos = np.arange(96)
    _close(TA.attn_triangular(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                              window=window, chunk=32),
           JA.attn_triangular(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                              window=window, chunk=32), 1e-5)


@pytest.mark.parametrize("variant", ["mqa", "swa"])
def test_self_attention_triangular_impl(rng, variant):
    kw = VARIANTS[variant]
    tcfg = dataclasses.replace(get_config("yi-6b").reduced(), **kw)
    jcfg = dataclasses.replace(j_get_config("yi-6b").reduced(), **kw)
    q, k, v = _qkv(rng)
    pos = np.arange(64)
    _close(TA.self_attention(tcfg, _t(q), _t(k), _t(v), _t(pos), _t(pos),
                             impl="triangular"),
           JA.self_attention(jcfg, q, k, v, jnp.asarray(pos),
                             jnp.asarray(pos), impl="triangular"), 1e-5)


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, 0, None), (False, 0, 5), (True, 3, 7), (False, 4, 0)])
def test_mask(causal, window, kv_len):
    qp, kp = np.arange(2, 11), np.arange(12)
    assert np.array_equal(
        TA._mask(_t(qp), _t(kp), causal, window, kv_len).numpy(),
        np.asarray(JA._mask(jnp.asarray(qp), jnp.asarray(kp), causal,
                            window, kv_len)))


def test_cross_attention(rng):
    cfg = get_config("whisper-medium").reduced()
    q = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    ek, ev = (rng.normal(size=(2, 11, 4, 16)).astype(np.float32)
              for _ in range(2))
    _close(TA.cross_attention(cfg, _t(q), _t(ek), _t(ev)),
           JA.cross_attention(j_get_config("whisper-medium").reduced(), q,
                              ek, ev), 1e-5)


@pytest.mark.parametrize("window,S,takes", [
    (0, 2048, True), (0, 1, True), (4096, 2048, True), (4096, 4096, True),
    (4096, 4097, False), (32, 64, False), (32, 32, True)])
def test_flash_kernel_takes_unless_the_window_masks(window, S, takes):
    """The kernel computes the windowed function wherever the window
    masks nothing (S <= window): the dense windowed mask is then the
    causal one."""
    cfg = dataclasses.replace(get_config("yi-6b"), swa_window=window)
    assert TA.flash_kernel_takes(cfg, S) is takes
    n = min(S, 48)
    pos = torch.arange(n)
    masks_nothing = torch.equal(TA._mask(pos, pos, True, window),
                                TA._mask(pos, pos, True, 0))
    if n == S:
        assert masks_nothing is takes


# ---------------------------------------------------------------------------
# the model, with carried weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    """(port cfg, port params, JAX cfg, JAX params) for one variant."""
    kw = VARIANTS[request.param]
    jcfg = dataclasses.replace(j_get_config("yi-6b").reduced(), **kw)
    tcfg = dataclasses.replace(get_config("yi-6b").reduced(), **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return tcfg, tp, jcfg, jp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def test_forward_logits(pair):
    tcfg, tp, jcfg, jp = pair
    toks = _tokens(tcfg, 2, 24)
    with torch.inference_mode():
        t, _ = TM.forward_logits(tcfg, tp, _t(toks))
    j, _ = JM.forward_logits(jcfg, jp, jnp.asarray(toks))
    assert t.shape == (2, 24, tcfg.padded_vocab)
    _close(t, j, **LOGITS)


def test_prefill_then_two_decode_steps(pair):
    """S = 64 > attn_chunk = 32: both packages take the chunked flash
    path in prefill."""
    tcfg, tp, jcfg, jp = pair
    S = 64
    assert S > tcfg.attn_chunk
    toks = _tokens(tcfg, 2, S + 2, seed=1)
    with torch.inference_mode():
        tl, tc = TM.prefill(tcfg, tp, {"tokens": _t(toks[:, :S])},
                            max_len=S + 8)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                        max_len=S + 8)
    _close(tl, jl, **LOGITS)
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        _close(tc[name], jc[name], **CACHE)
    for i in range(2):
        with torch.inference_mode():
            tl, tc = TM.decode_step(tcfg, tp, _t(toks[:, S + i]), S + i, tc)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, S + i]),
                                jnp.int32(S + i), jc)
        _close(tl, jl, **LOGITS)


def test_padded_vocab_masked(pair):
    tcfg, tp, _, _ = pair
    with torch.inference_mode():
        logits, _ = TM.prefill(tcfg, tp, {"tokens": _t(_tokens(tcfg, 1, 8))})
    assert logits.shape == (1, tcfg.padded_vocab)
    assert bool((logits[:, tcfg.vocab:] == -1e30).all())
    assert bool((logits[:, :tcfg.vocab] > -1e29).all())


def test_params_from_jax_checks_keys_and_shapes(pair):
    tcfg, _, _, jp = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    del tree["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        params_from_jax(tcfg, tree, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["extra"] = {"w": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(tcfg, tree, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["stack"]["attn"]["wq"] = tree["stack"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(tcfg, tree, device="cpu")


def test_init_params_distribution():
    """Same spec tree and init rules as the reference: ones for norms,
    truncated normal at 1/sqrt(fan_in) (|w| <= 2 / sqrt(fan_in))."""
    cfg = get_config("yi-6b").reduced()
    p = TM.init_params(cfg, 0, device="cpu")
    assert isinstance(p, torch.nn.Module)
    assert sum(x.numel() for x in p.parameters()) == cfg.param_count()
    assert not any(x.requires_grad for x in p.parameters())
    assert bool((p["stack"]["ln1"]["scale"] == 1).all())
    w = p["stack"]["mlp"]["w_gate"]          # (L, d_model, d_ff): fan_in 64
    assert float(w.abs().max()) <= 2 / np.sqrt(64) + 1e-7
    # the standard normal truncated at +-2 has std 0.8796
    assert abs(float(w.std()) * np.sqrt(64) - 0.8796) < 0.02
    again = TM.init_params(cfg, 0, device="cpu")
    assert torch.equal(again["embed"]["tokens"], p["embed"]["tokens"])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config("yi-6b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_cache(cfg, 1, 8)
