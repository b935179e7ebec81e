"""repro_torch.models.xlstm against the JAX package on the CPU: the same
numpy inputs and weights, float32, atol 1e-5, plus rtol 1e-5 for the
chunked mLSTM's outputs and states (they reach ~10 and C hundreds, so
float32's step there exceeds 1e-6).  The chunked mLSTM carries a
log-space stabilizer m across chunks; it starts at -1e30 in both
packages, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(t, j, atol=ATOL, rtol=0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=rtol)


def _state_close(t, j, rtol=0):
    for k in j:
        _close(t[k], j[k], rtol=rtol)


def _mlstm_inputs(rng, B=2, T=37, H=3, Dqk=4, Dv=6):
    return (rng.normal(size=(B, T, H, Dqk)).astype(np.float32),
            rng.normal(size=(B, T, H, Dqk)).astype(np.float32),
            rng.normal(size=(B, T, H, Dv)).astype(np.float32),
            rng.normal(size=(B, T, H)).astype(np.float32),
            np.log(rng.uniform(0.5, 0.99, (B, T, H))).astype(np.float32))


@pytest.mark.parametrize("T,chunk", [(37, 16), (32, 16), (5, 16), (1, 16)])
def test_mlstm_chunked(rng, T, chunk):
    """From the zero state, then one more chunk from its final state (the
    stabilizer m carried).  37 is not a multiple of 16: the padding has
    logi = -1e30 and logf = 0."""
    q, k, v, li, lf = _mlstm_inputs(rng, T=T + 9)
    a = slice(0, T)
    th, ts = TX._mlstm_chunked(*(_t(x[:, a]) for x in (q, k, v, li, lf)),
                               chunk)
    jh, js = JX._mlstm_chunked(*(x[:, a] for x in (q, k, v, li, lf)), chunk)
    _close(th, jh, rtol=1e-5)
    _state_close(ts, js, rtol=1e-5)
    b = slice(T, T + 9)
    th, ts = TX._mlstm_chunked(*(_t(x[:, b]) for x in (q, k, v, li, lf)),
                               chunk, ts)
    jh, js = JX._mlstm_chunked(*(x[:, b] for x in (q, k, v, li, lf)), chunk,
                               js)
    _close(th, jh, rtol=1e-5)
    _state_close(ts, js, rtol=1e-5)


def test_mlstm_initial_stabilizer():
    cfg = get_config("xlstm-1.3b").reduced()
    t = TX.init_mlstm_state(cfg, 2, device="cpu")
    j = JX.init_mlstm_state(j_get_config("xlstm-1.3b").reduced(), 2)
    for k in ("C", "n", "m"):
        assert np.array_equal(t[k].numpy(), np.asarray(j[k]))
    assert bool((t["m"] == np.float32(-1e30)).all())


@pytest.fixture(scope="module")
def cfgs():
    return (get_config("xlstm-1.3b").reduced(),
            j_get_config("xlstm-1.3b").reduced())


def _block_params(rng, specs):
    return {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2] if len(
        s.shape) > 1 else 4)).astype(np.float32) for k, s in specs.items()}


def test_apply_mlstm_then_decode(rng, cfgs):
    tcfg, jcfg = cfgs
    p = _block_params(rng, JX.mlstm_specs(jcfg))
    tp = {k: _t(v) for k, v in p.items()}
    x = rng.normal(size=(2, 35, tcfg.d_model)).astype(np.float32)
    to, ts = TX.apply_mlstm(tcfg, tp, _t(x[:, :33]))
    jo, js = JX.apply_mlstm(jcfg, p, x[:, :33])
    _close(to, jo, rtol=1e-5)
    for i in (33, 34):
        _state_close(ts, js, rtol=1e-5)
        to, ts = TX.apply_mlstm(tcfg, tp, _t(x[:, i:i + 1]), ts)
        jo, js = JX.apply_mlstm(jcfg, p, x[:, i:i + 1], js)
        _close(to, jo, rtol=1e-5)


def test_slstm_cell(rng, cfgs):
    tcfg, jcfg = cfgs
    p = _block_params(rng, JX.slstm_specs(jcfg))
    H, Dh = TX.slstm_dims(tcfg)
    xg = rng.normal(size=(2, H, 4 * Dh)).astype(np.float32)
    st = tuple(rng.normal(size=(2, H, Dh)).astype(np.float32)
               for _ in range(4))
    st = (st[0], np.abs(st[1]) + 0.5, st[2], st[3])
    t = TX._slstm_cell({"r_h": _t(p["r_h"]), "bias": _t(p["bias"])}, _t(xg),
                       tuple(map(_t, st)))
    j = JX._slstm_cell(p, xg, st)
    for a, b in zip(t, j):
        _close(a, b)


def test_apply_slstm(rng, cfgs):
    """The sequential loop over 40 steps from the zero state, then 3
    more from its state."""
    tcfg, jcfg = cfgs
    p = _block_params(rng, JX.slstm_specs(jcfg))
    tp = {k: _t(v) for k, v in p.items()}
    x = rng.normal(size=(2, 43, tcfg.d_model)).astype(np.float32)
    to, ts = TX.apply_slstm(tcfg, tp, _t(x[:, :40]))
    jo, js = JX.apply_slstm(jcfg, p, x[:, :40])
    _close(to, jo)
    _state_close(ts, js)
    to, ts = TX.apply_slstm(tcfg, tp, _t(x[:, 40:]), ts)
    jo, js = JX.apply_slstm(jcfg, p, x[:, 40:], js)
    _close(to, jo)
    _state_close(ts, js)


def test_group_layout_and_state_specs(cfgs):
    tcfg, jcfg = cfgs
    assert TT.xlstm_group_layout(tcfg) == JT.xlstm_group_layout(jcfg)
    assert TT.xlstm_group_layout(get_config("xlstm-1.3b")) == (6, 7)
    t = TT.xlstm_init_state(tcfg, 3, device="cpu")
    j = JT.xlstm_init_state(jcfg, 3)
    for grp in ("mlstm", "slstm"):
        for k in j[grp]:
            assert np.array_equal(t[grp][k].numpy(), np.asarray(j[grp][k]))
    specs = TT.xlstm_state_specs(tcfg, 3)
    assert specs["mlstm"]["C"].shape == tuple(t["mlstm"]["C"].shape)


def test_rms_gate(rng):
    h, z = (rng.normal(size=(2, 5, 16)).astype(np.float32) for _ in range(2))
    s = rng.normal(size=16).astype(np.float32)
    _close(TX.rms_gate(_t(h), _t(z), _t(s)),
           JX.rms_gate(jnp.asarray(h), jnp.asarray(z), jnp.asarray(s)))
