"""repro_torch.models.moe against the JAX package on the CPU.

The same numpy inputs and weights go through both packages' routing.
Beside the outputs (atol 1e-5, float32), the port's kept and dropped
(token, expert) pairs are held to the reference's, recomputed here
with the reference's own jnp steps (`repro.models.moe._route_row`,
lines top_k .. keep): a forced tie among router logits and a capacity
overflow included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.convert import params_from_jax

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _ref_kept(router_logits, top_k, cf):
    """The reference's sorted (token, expert, keep) for one row, by its
    own steps."""
    S, E = router_logits.shape
    probs = jax.nn.softmax(jnp.asarray(router_logits, jnp.float32), -1)
    _, expert_idx = jax.lax.top_k(probs, top_k)
    flat_expert = expert_idx.reshape(-1)
    flat_token = jnp.repeat(jnp.arange(S), top_k)
    order = jnp.argsort(flat_expert)
    e_sorted, t_sorted = flat_expert[order], flat_token[order]
    pos = jnp.arange(S * top_k) - jnp.searchsorted(e_sorted, e_sorted,
                                                   side="left")
    keep = pos < JMoE._capacity(S, E, top_k, cf)
    return np.asarray(t_sorted), np.asarray(e_sorted), np.asarray(keep)


def _weights(rng, E, D, F):
    return [(rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
            for s in ((E, D, F), (E, D, F), (E, F, D))]


def _logits_with_ties(rng, S, E):
    lg = rng.normal(size=(S, E)).astype(np.float32)
    lg[::3, 1] = lg[::3, 3] = lg[::3].max(-1) + 1.0   # a tie for 1st place
    lg[1::3, 0] = lg[1::3, 2] = lg[1::3].min(-1) + 0.0  # ties lower down
    lg[2::5] = 0.5                                      # all experts tied
    return lg


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_route_row_keeps_the_references_pairs(rng, cf, top_k):
    """cf 0.25 overflows most buckets; 8.0 drops nothing."""
    S, E, D, F = 24, 6, 16, 8
    x = rng.normal(size=(S, D)).astype(np.float32)
    lg = _logits_with_ties(rng, S, E)
    w = _weights(rng, E, D, F)
    j = JMoE._route_row(jnp.asarray(x), jnp.asarray(lg), *w, top_k, cf)
    t = TMoE._route_row(_t(x), _t(lg), *map(_t, w), top_k, cf)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    _, keep, t_sorted = TMoE._route(_t(x)[None], _t(lg)[None],
                                    *map(_t, w), top_k, cf)
    rt, _, rkeep = _ref_kept(lg, top_k, cf)
    assert np.array_equal(t_sorted[0].numpy(), rt)
    assert np.array_equal(keep[0].numpy(), rkeep)
    if cf == 0.25:
        assert not rkeep.all()
    if cf == 8.0:
        assert rkeep.all()


def test_top_k_breaks_ties_to_the_lower_expert():
    probs = torch.tensor([[0.2, 0.3, 0.2, 0.3], [0.25] * 4,
                          [0.1, 0.4, 0.4, 0.1]])
    vals, idx = TMoE._top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    assert np.array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 3, 0], [0, 1, 2], [1, 2, 0]]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
@pytest.mark.parametrize("cf", [0.1, 1.25])
def test_apply_moe_and_aux_loss(rng, arch, cf):
    """Batched routing (rows independent), the shared expert and its
    sigmoid gate (qwen2-moe), and the load-balance loss."""
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf))
        for c in (j_get_config(arch).reduced(), get_config(arch).reduced()))
    specs = JMoE.moe_specs(jcfg)
    p = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(
            np.float32), specs,
        is_leaf=lambda s: hasattr(s, "init"))
    x = rng.normal(size=(3, 20, jcfg.d_model)).astype(np.float32)
    tp = jax.tree_util.tree_map(_t, p)
    np.testing.assert_allclose(TMoE.apply_moe(tcfg, tp, _t(x)).numpy(),
                               np.asarray(JMoE.apply_moe(jcfg, p, x)),
                               atol=ATOL)
    np.testing.assert_allclose(
        float(TMoE.aux_load_balance_loss(tcfg, tp, _t(x))),
        float(JMoE.aux_load_balance_loss(jcfg, p, x)), rtol=1e-6)
    # a row routed alone is the same row routed in the batch (up to the
    # products' blocking, which depends on the batch)
    one = TMoE.apply_moe(tcfg, tp, _t(x[1:2]))
    np.testing.assert_allclose(
        one.numpy(), TMoE.apply_moe(tcfg, tp, _t(x))[1:2].numpy(),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("tokens,E,k,cf", [
    (2048, 60, 4, 1.25), (1, 60, 4, 1.25), (2048, 8, 2, 1.25),
    (32, 4, 2, 0.1), (5, 4, 2, 100.0)])
def test_capacity(tokens, E, k, cf):
    assert TMoE._capacity(tokens, E, k, cf) == JMoE._capacity(tokens, E,
                                                              k, cf)


def test_decode_capacity_is_one():
    """At decode S = 1, so every bucket holds one pair."""
    m = get_config("qwen2-moe-a2.7b").moe
    assert TMoE._capacity(1, m.num_experts, m.top_k,
                          m.capacity_factor) == 1


def test_moe_capacity_drops_counted():
    """Tiny capacity must change outputs (drops) but never NaN; the port
    drops the reference's pairs, so its logits match at both capacities
    (mirrors tests/test_models_smoke.py::test_moe_capacity_drops_counted
    with the port's prefill)."""
    jbase = j_get_config("qwen2-moe-a2.7b").reduced()
    tbase = get_config("qwen2-moe-a2.7b").reduced()

    def cfgs(cf):
        return tuple(dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
            for c in (jbase, tbase))

    jp = JM.init_params(jbase, jax.random.PRNGKey(0))
    tp = params_from_jax(tbase, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    toks = np.random.default_rng(1).integers(0, tbase.vocab, (2, 32))
    out = {}
    for cf in (0.1, float(tbase.moe.num_experts)):
        jc, tc = cfgs(cf)
        with torch.inference_mode():
            tl, _ = TM.forward_logits(tc, tp, _t(toks))
        jl, _ = JM.forward_logits(jc, jp, jnp.asarray(toks))
        assert np.isfinite(tl.numpy()).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3)
        out[cf] = tl.numpy()
    assert np.abs(out[0.1] - out[float(tbase.moe.num_experts)]).max() > 1e-6
