"""repro_torch.models.ssm (Mamba2 SSD) against the JAX package on the
CPU: the same numpy inputs, float32, atol 1e-5 unless a test says
otherwise.  The parameter inits "mamba_a" and "dt_bias" cannot share
the reference's bits (`torch.Generator` is not `jax.random`): they are
checked by range and distribution."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.layers import ParamSpec, init_from_specs

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def _ssd_inputs(rng, B=2, T=37, H=3, P=4, N=5):
    return (rng.normal(size=(B, T, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.5, size=(B, T, H)).astype(np.float32),
            -rng.uniform(0.5, 4.0, size=H).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32))


def test_segsum(rng):
    a = rng.normal(size=(2, 3, 7)).astype(np.float32)
    t, j = TS._segsum(_t(a)).numpy(), np.asarray(JS._segsum(a))
    assert np.array_equal(np.isinf(t), np.isinf(j))
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], atol=ATOL)


@pytest.mark.parametrize("T,chunk", [(37, 16), (48, 16), (5, 16), (1, 16),
                                     (33, 8)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(rng, T, chunk, with_state):
    """T not divisible by the chunk pads with dt = 0 (exact); with a
    carried state as in decode and continuation."""
    x, dt, A, Bm, Cm = _ssd_inputs(rng, T=T)
    S0 = rng.normal(size=(2, 3, 5, 4)).astype(np.float32) if with_state \
        else None
    ty, tS = TS.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                            None if S0 is None else _t(S0))
    jy, jS = JS.ssd_chunked(x, dt, A, Bm, Cm, chunk, S0)
    assert ty.shape == (2, T, 3, 4) and tS.shape == (2, 3, 5, 4)
    _close(ty, jy)
    _close(tS, jS)


def test_ssd_chunked_is_chunk_invariant(rng):
    """One chunk, several chunks and a token at a time give the same y
    and state (the recurrence), within float32 rounding."""
    x, dt, A, Bm, Cm = (_t(a) for a in _ssd_inputs(rng, T=24))
    y1, S1 = TS.ssd_chunked(x, dt, A, Bm, Cm, 24)
    y2, S2 = TS.ssd_chunked(x, dt, A, Bm, Cm, 5)
    y3, S3 = TS.ssd_chunked(x, dt, A, Bm, Cm, 1)
    for y, S in ((y2, S2), (y3, S3)):
        torch.testing.assert_close(y, y1, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(S, S1, atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def block():
    """A reduced zamba2 config and numpy weights for one Mamba2 block."""
    jcfg = j_get_config("zamba2-1.2b").reduced()
    tcfg = get_config("zamba2-1.2b").reduced()
    rng = np.random.default_rng(7)
    specs = JS.ssm_specs(jcfg)
    p = {}
    for k, s in specs.items():
        if s.init == "mamba_a":
            p[k] = np.log(rng.uniform(1, 16, s.shape)).astype(np.float32)
        elif s.init == "dt_bias":
            p[k] = np.log(np.expm1(rng.uniform(1e-3, 1e-1, s.shape))).astype(
                np.float32)
        else:
            p[k] = (rng.normal(size=s.shape) / 4).astype(np.float32)
    return tcfg, jcfg, p


def test_conv1d_with_state(rng, block):
    tcfg, jcfg, p = block
    d_inner, H, P, N = TS.ssm_dims(tcfg)
    xbc = rng.normal(size=(2, 9, d_inner + 2 * N)).astype(np.float32)
    st = rng.normal(size=(2, tcfg.ssm.conv - 1, d_inner + 2 * N)).astype(
        np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    for state in (None, st):
        to, ts = TS._conv1d(tcfg, tp, _t(xbc), None if state is None
                            else _t(state))
        jo, js = JS._conv1d(jcfg, p, xbc, state)
        _close(to, jo)
        _close(ts, js)


@pytest.mark.parametrize("T", [37, 16, 1])
def test_apply_ssm_then_decode(rng, block, T):
    """A prompt of T tokens (37: not a multiple of the chunk 16), then
    two one-token decode steps from its conv and SSM states."""
    tcfg, jcfg, p = block
    tp = {k: _t(v) for k, v in p.items()}
    x = rng.normal(size=(2, T + 2, tcfg.d_model)).astype(np.float32)
    to, tst = TS.apply_ssm(tcfg, tp, _t(x[:, :T]))
    jo, jst = JS.apply_ssm(jcfg, p, x[:, :T])
    _close(to, jo)
    assert tst["ssm"].dtype == torch.float32
    assert tuple(tst["ssm"].shape) == jst["ssm"].shape
    for i in range(2):
        _close(tst["conv"], jst["conv"])
        _close(tst["ssm"], jst["ssm"])
        to, tst = TS.decode_ssm(tcfg, tp, _t(x[:, T + i]), tst)
        jo, jst = JS.decode_ssm(jcfg, p, x[:, T + i], jst)
        _close(to, jo)


def test_init_ssm_state_and_specs(block):
    tcfg, jcfg, _ = block
    t = TS.init_ssm_state(tcfg, 3, "float32", device="cpu")
    j = JS.init_ssm_state(jcfg, 3, jnp.float32)
    specs = TS.ssm_state_specs(tcfg, 3, torch.bfloat16)
    for k in ("conv", "ssm"):
        assert tuple(t[k].shape) == j[k].shape == specs[k].shape
        assert not bool(t[k].any())
    assert specs["ssm"].dtype == torch.float32          # the state stays f32
    assert specs["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("init,lo,hi", [
    ("mamba_a", np.log(1.0), np.log(16.0)),
    ("dt_bias", np.log(np.expm1(1e-3)), np.log(np.expm1(1e-1)))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_inits_by_range_and_distribution(init, lo, hi, dtype):
    """A_log = log u, u ~ U[1, 16]; dt_bias = softplus^-1(u), u ~
    U[1e-3, 1e-1] (the reference's rules, `repro.models.layers:59-66`):
    the values lie in the range, and u = exp(A_log) or softplus(dt_bias)
    is uniform there (a Kolmogorov-Smirnov distance under 0.02 at 20,000
    draws, where uniform draws stay under 0.012 with probability 0.999;
    the bfloat16 rounding moves u by at most 0.4 %)."""
    spec = {"w": ParamSpec((20_000,), (None,), init)}
    gen = torch.Generator().manual_seed(0)
    w = init_from_specs(spec, gen, dtype, device="cpu")["w"].float()
    assert w.dtype == torch.float32
    tol = 0.0 if dtype == "float32" else 0.004 * max(abs(lo), abs(hi))
    assert float(w.min()) >= lo - tol - 1e-6
    assert float(w.max()) <= hi + tol + 1e-6
    if init == "mamba_a":
        u, a, b = np.exp(w.numpy().astype(np.float64)), 1.0, 16.0
    else:
        u, a, b = np.log1p(np.exp(w.numpy().astype(np.float64))), 1e-3, 1e-1
    u = np.sort(u)
    cdf = np.clip((u - a) / (b - a), 0, 1)
    n = u.size
    ks = max(np.max(np.arange(1, n + 1) / n - cdf),
             np.max(cdf - np.arange(n) / n))
    assert ks < 0.02, ks
    # the reference's draw by the same rule: the same mean
    jw = np.asarray(JL.init_from_specs(
        {"w": JL.ParamSpec((20_000,), (None,), init)},
        jax.random.PRNGKey(0))["w"])
    assert abs(float(np.mean(jw)) - float(w.mean())) < 0.05 * (hi - lo)


def test_zamba2_params_draw_the_ssm_inits():
    cfg = get_config("zamba2-1.2b").reduced()
    p = TM.init_params(cfg, 0, device="cpu")
    a = p["stack"]["groups"]["mamba"]["ssm"]["A_log"]
    dt = p["stack"]["groups"]["mamba"]["ssm"]["dt_bias"]
    assert float(a.min()) >= 0 and float(a.max()) <= np.log(16) + 1e-6
    assert float(dt.max()) <= np.log(np.expm1(0.1)) + 1e-6
    assert sum(x.numel() for x in p.parameters()) == cfg.param_count()
