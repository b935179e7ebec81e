"""The port's training math against the JAX package on the CPU:
`forward_train` and `cross_entropy`, remat, AdamW, the cosine schedule,
int8 compression with error feedback, and `FlashAttentionFunction`.

Every arch runs at its reduced config (d_model 64, attn_chunk 32) at
S = 64, a multiple of attn_chunk above it, so both packages take the
chunked `attn_flash` path; batch 2, z_weight 1e-3 and the default
aux_weight 0.01 (MoE archs add their load-balance loss).

Gradient tolerance: every leaf within GRAD_TOL = 1e-4 of that leaf's
largest reference gradient.  The weights are the reference's
`init_params` tree with each attention's wq and wk rescaled from the
reference's fan-in (its head count) to d_model's, carried over with
`params_from_jax`.  Under the reference's own init the attention of
random weights is nearly a hard max (scores in the hundreds), so the
rounding differences of two correct float32 implementations, which sum
in different orders, move the gradients by far more than 1e-3 of a
leaf's largest (`chip_smoke.py` phase 8 prints such a gap on the card:
two plain attention paths of yi-6b's width, 2 layers).  The reference's
init is still checked, by the loss (LOSS_TOL relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import model as JM
from repro.training import compression as JC
from repro.training.optimizer import AdamW as JAdamW
from repro.training.optimizer import cosine_schedule as j_cosine
from repro.training.optimizer import global_norm as j_global_norm
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import ParamTree, take
from repro_torch.training import compression as TC
from repro_torch.training.optimizer import AdamW, cosine_schedule, global_norm
from repro_torch.training.trees import items

ARCHS = j_list_archs()
S = 64
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


def temper(tree, parent=""):
    """The reference's init tree as numpy, each attention's wq and wk
    ((..., d_model, heads, head_dim), under an "attn" key) scaled from
    1/sqrt(heads) to 1/sqrt(d_model)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = temper(v, k)
        else:
            v = np.asarray(v)
            if "attn" in parent and k in ("wq", "wk"):
                v = (v * np.sqrt(v.shape[-2] / v.shape[-3])).astype(v.dtype)
            out[k] = v
    return out


def carried(arch, seed, tempered=True):
    """(reference cfg, port cfg, reference tree, trainable ParamTree)."""
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jc, jax.random.PRNGKey(seed)))
    if tempered:
        tree = temper(tree)
    tp = params_from_jax(tc, tree, device="cpu")
    tp.requires_grad_(True)
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, tree), tp


def batches(cfg, seed, B=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    if cfg.is_encdec:
        fr = rng.normal(size=(B, cfg.n_frames, cfg.d_model)).astype(
            np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.as_tensor(fr)
    return jb, tb


def jax_leaves(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_grads(cfg, tp, tb, **kw):
    total, metrics = TM.forward_train(cfg, tp, tb, **kw)
    paths, leaves = zip(*items(tp))
    grads = torch.autograd.grad(total, leaves)
    return total, metrics, dict(zip(paths, grads))


# ---------------------------------------------------------------------------
# forward_train
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_grads_match_reference(arch):
    jc, tc, jp, tp = carried(arch, seed=1)
    jb, tb = batches(tc, seed=1)
    (jt, jm), jg = jax.value_and_grad(
        lambda p: JM.forward_train(jc, p, jb, z_weight=1e-3),
        has_aux=True)(jp)
    tt, tm, tg = port_grads(tc, tp, tb, z_weight=1e-3)
    np.testing.assert_allclose(tt.item(), float(jt), rtol=LOSS_TOL)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(tm["aux_loss"].item(), float(jm["aux_loss"]),
                               rtol=LOSS_TOL, atol=1e-7)
    assert tm["tokens"] == int(jm["tokens"]) == 2 * (S - 1)
    if tc.moe is not None:
        assert tm["aux_loss"].item() > 0
    ref = jax_leaves(jg)
    assert set(ref) == set(tg)
    for path, g in tg.items():
        r = ref[path]
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= GRAD_TOL * scale, (path, err / scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_at_reference_init(arch):
    jc, tc, jp, tp = carried(arch, seed=2, tempered=False)
    jb, tb = batches(tc, seed=2)
    jt, jm = JM.forward_train(jc, jp, jb)
    with torch.no_grad():
        tt, tm = TM.forward_train(tc, tp, tb)
    np.testing.assert_allclose(tt.item(), float(jt), rtol=LOSS_TOL)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_on_the_cpu(arch):
    """cfg.remat checkpoints each layer's body: the same loss and grads,
    bit for bit."""
    import dataclasses
    _, tc, _, tp = carried(arch, seed=3)
    _, tb = batches(tc, seed=3)
    runs = [port_grads(dataclasses.replace(tc, remat=r), tp, tb,
                       z_weight=1e-3) for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for path, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][path]), path


def test_z_loss_and_aux_weights():
    _, tc, _, tp = carried("qwen2-moe-a2.7b", seed=4)
    _, tb = batches(tc, seed=4)
    with torch.no_grad():
        base, m = TM.forward_train(tc, tp, tb, aux_weight=0.0)
        with_z, _ = TM.forward_train(tc, tp, tb, aux_weight=0.0,
                                     z_weight=0.5)
        with_aux, _ = TM.forward_train(tc, tp, tb, aux_weight=0.25)
        logits, _ = TM.forward_logits(tc, tp, tb["tokens"])
        _, logz = TM.cross_entropy(tc, logits[:, :-1], tb["tokens"][:, 1:])
    assert torch.equal(base, m["loss"])
    torch.testing.assert_close(with_z - base,
                               0.5 * logz[:, :-1].square().mean())
    torch.testing.assert_close(with_aux - base, 0.25 * m["aux_loss"])


@pytest.mark.parametrize("vocab", [256, 250])
def test_cross_entropy_matches_reference(rng, vocab):
    import dataclasses
    jc = dataclasses.replace(j_get_config("yi-6b").reduced(), vocab=vocab)
    tc = dataclasses.replace(get_config("yi-6b").reduced(), vocab=vocab)
    logits = rng.normal(size=(2, 7, tc.padded_vocab)).astype(np.float32) * 4
    tgt = rng.integers(0, vocab, (2, 7)).astype(np.int32)
    jl, jz = JM.cross_entropy(jc, jnp.asarray(logits), jnp.asarray(tgt))
    tl, tz = TM.cross_entropy(tc, torch.as_tensor(logits).bfloat16(),
                              torch.as_tensor(tgt))
    jl2, jz2 = JM.cross_entropy(jc, jnp.asarray(logits, jnp.bfloat16),
                                jnp.asarray(tgt))
    assert tl.dtype == tz.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl2), rtol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz2), rtol=1e-6)
    tl32, _ = TM.cross_entropy(tc, torch.as_tensor(logits),
                               torch.as_tensor(tgt))
    np.testing.assert_allclose(tl32.item(), float(jl), rtol=1e-6)


def test_param_tree_trains_through_layer_views():
    """requires_grad_(True) makes every leaf trainable; the gradient of a
    layer's `take` view lands in that layer's slice of the stacked
    Parameter."""
    tree = ParamTree({"stack": {"w": torch.ones(3, 2, 2)},
                      "b": torch.ones(2)})
    assert not any(p.requires_grad for p in tree.parameters())
    tree.requires_grad_(True)
    assert all(p.requires_grad for p in tree.parameters())
    loss = sum((take(tree["stack"], i)["w"] * (i + 1)).sum()
               for i in range(3)) + tree["b"].sum()
    loss.backward()
    g = tree["stack"]["w"].grad
    assert [float(g[i].mean()) for i in range(3)] == [1.0, 2.0, 3.0]


# ---------------------------------------------------------------------------
# FlashAttentionFunction (its forward is the kernel's plain version here)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S_,chunk", [(64, 16), (48, 64), (40, 16)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_function_backward_matches_attn_flash(rng, S_, chunk, H, KV,
                                                    dtype, tol):
    """Output and dq, dk, dv against autograd of the chunked `attn_flash`
    (one chunk where S is not a multiple): S a multiple of the chunk, S
    below it, S ragged."""
    B, D = 2, 16
    arrs = [rng.normal(size=(B, S_, h, D)).astype(np.float32)
            for h in (H, KV, KV)]
    w = torch.as_tensor(rng.normal(size=(B, S_, H, D)).astype(np.float32))

    def run(fn):
        ins = [torch.as_tensor(a).to(dtype).requires_grad_() for a in arrs]
        o = fn(*ins)
        (o.float() * w).sum().backward()
        return o.detach(), [t.grad for t in ins]

    c = chunk if S_ % chunk == 0 else S_
    pos = torch.arange(S_)
    ok, gk = run(lambda q, k, v: TA.FlashAttentionFunction.apply(
        q, k, v, chunk))
    of, gf = run(lambda q, k, v: TA.attn_flash(
        q, k, v, pos, pos, causal=True, q_chunk=c, kv_chunk=c))
    assert ok.dtype == dtype
    torch.testing.assert_close(ok.float(), of.float(), atol=tol, rtol=tol)
    for a, b in zip(gk, gf):
        assert a.dtype == dtype
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


def test_flash_function_grads_only_where_asked(rng):
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 32, h, 8)).astype(
        np.float32)) for h in (2, 1, 1))
    q.requires_grad_()
    o = TA.FlashAttentionFunction.apply(q, k, v, 16)
    o.sum().backward()
    assert q.grad is not None and k.grad is None and v.grad is None
    q2 = q.detach().clone().requires_grad_()
    TA.causal_plain(q2, k, v, 16).sum().backward()
    torch.testing.assert_close(q.grad, q2.grad)


def test_causal_plain_equals_attn_flash_bit_for_bit(rng):
    """The triangular loop skips only all-masked blocks, which add exact
    zeros in attn_flash: the same values."""
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 64, h, 16)).astype(
        np.float32) * 3) for h in (4, 2, 2))
    pos = torch.arange(64)
    a = TA.causal_plain(q, k, v, 16)
    b = TA.attn_flash(q, k, v, pos, pos, causal=True, q_chunk=16,
                      kv_chunk=16)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# AdamW, schedule, global norm
# ---------------------------------------------------------------------------


class TestAdamW:
    """The reference's `TestAdamW` cases on the port."""

    def test_quadratic_convergence(self):
        opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=0.0)
        params = ParamTree({"w": torch.tensor([5.0, -3.0])})
        state = opt.init(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"].detach()}        # d/dw w^2
            params, state = opt.update(grads, state, params)
        assert float(params["w"].abs().max()) < 1e-2

    def test_bf16_states_roundtrip(self):
        opt = AdamW(lr=1e-3, state_dtype="bfloat16")
        params = ParamTree({"w": torch.ones((8, 8))})
        state = opt.init(params)
        assert state.m["w"].dtype == torch.bfloat16
        params2, state2 = opt.update({"w": torch.ones((8, 8))}, state,
                                     params)
        assert state2.v["w"].dtype == torch.bfloat16
        assert bool(torch.isfinite(params2["w"]).all())

    def test_clipping_bounds_update(self):
        opt = AdamW(lr=1.0, clip_norm=1.0, weight_decay=0.0)
        params = ParamTree({"w": torch.zeros(4)})
        state = opt.init(params)
        _, s2 = opt.update({"w": torch.full((4,), 1e6)}, state, params)
        # post-clip first moment magnitude <= (1-b1)*clip
        assert float(s2.m["w"].abs().max()) <= 0.11

    def test_decay_only_matrices(self):
        opt = AdamW(lr=1e-2, weight_decay=1.0, clip_norm=0.0)
        params = ParamTree({"mat": torch.ones((4, 4)),
                            "vec": torch.ones((4,))})
        state = opt.init(params)
        zero = {"mat": torch.zeros((4, 4)), "vec": torch.zeros((4,))}
        p2, _ = opt.update(zero, state, params)
        assert float(p2["mat"][0, 0]) < 1.0     # decayed
        assert float(p2["vec"][0]) == 1.0       # not decayed

    def test_cosine_schedule_shape(self):
        sched = cosine_schedule(warmup=10, total=100)
        assert float(sched(0)) == 0.0
        assert abs(float(sched(10)) - 1.0) < 1e-5
        assert float(sched(100)) <= 0.11


def _opt_tree(rng):
    """A small tree with a stacked norm scale, a matrix, a vector and a
    3-D leaf (names sort differently from their insertion)."""
    shapes = {"stack": {"ln": (3, 8), "w": (3, 8, 5)}, "bias": (5,),
              "emb": (11, 8)}

    def draw(sp):
        return {k: draw(v) if isinstance(v, dict) else
                rng.normal(size=v).astype(np.float32) for k, v in sp.items()}
    return draw(shapes)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_three_updates_match_reference(rng, state_dtype):
    """Params and both moments after three updates with clipping, weight
    decay and the cosine schedule: every leaf within TOL x its largest
    reference entry.  The arithmetic is the same in float32, but the
    global norm's sums run in another order and the bias corrections'
    powers are taken by numpy on one side and by XLA on the other: a
    float32 step or two of each entry, which a moment's running sum of
    gradients of both signs carries over to its small entries (TOL
    1e-6); bfloat16 moments are held to one bfloat16 step (2^-8)."""
    p0 = _opt_tree(rng)
    gs = [jax.tree_util.tree_map(lambda a: a * (i + 1) * 3.0,
                                 _opt_tree(rng)) for i in range(3)]
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0,
              state_dtype=state_dtype)
    jopt = JAdamW(schedule=j_cosine(2, 10), **kw)
    topt = AdamW(schedule=cosine_schedule(2, 10), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = ParamTree(jax.tree_util.tree_map(torch.as_tensor, p0))
    ts = topt.init(tp)
    for g in gs:
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(jax.tree_util.tree_map(torch.as_tensor, g), ts,
                             tp)
    assert ts.step == int(js.step) == 3
    mtol = 1e-6 if state_dtype == "float32" else 2 ** -8
    for name, t, j, tol in (("p", tp, jp, 1e-6), ("m", ts.m, js.m, mtol),
                            ("v", ts.v, js.v, mtol)):
        ref = jax_leaves(j)
        for path, x in items(t):
            r = ref[path].astype(np.float32)
            assert x.dtype == torch.float32 or name != "p"
            err = np.abs(x.detach().float().numpy() - r).max()
            assert err <= tol * np.abs(r).max(), (name, path, err)


def test_cosine_schedule_matches_reference():
    js, ts = j_cosine(20, 100), cosine_schedule(20, 100)
    for step in (0, 1, 7, 20, 21, 55, 99, 100, 150):
        assert float(ts(step)) == float(js(jnp.int32(step))), step


def test_global_norm_matches_reference(rng):
    tree = _opt_tree(rng)
    j = float(j_global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    t = global_norm(jax.tree_util.tree_map(torch.as_tensor, tree))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.item(), j, rtol=1e-7)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [333, 256, 1024, 5])
def test_int8_roundtrip_bit_equal_to_reference(rng, n):
    """Both round half to even (`jnp.round`, `torch.round`): the same
    bits, ties included (whole-number multiples of a block's scale)."""
    g = (rng.normal(size=(n,)) * 10).astype(np.float32)
    g[: n // 3] = np.round(g[: n // 3])          # exact halves after scaling
    tree = {"g": g, "m": rng.normal(size=(3, 7)).astype(np.float32)}
    j = JC.int8_roundtrip(jax.tree_util.tree_map(jnp.asarray, tree))
    t = TC.int8_roundtrip(jax.tree_util.tree_map(torch.as_tensor, tree))
    for k in tree:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    jq = JC.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    tq = TC.quantize_tree(jax.tree_util.tree_map(torch.as_tensor, tree))
    for k in tree:
        np.testing.assert_array_equal(tq[k][0].numpy(), np.asarray(jq[k][0]))
        np.testing.assert_array_equal(tq[k][1].numpy(), np.asarray(jq[k][1]))
        assert tq[k][2:] == tuple(jq[k][2:])


def test_compress_with_feedback_bit_equal_to_reference(rng):
    shapes = {"a": (300,), "b": (4, 70)}
    zeros = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    jef = JC.EFState(jax.tree_util.tree_map(jnp.asarray, zeros))
    tef = TC.EFState(jax.tree_util.tree_map(torch.as_tensor, zeros))
    for _ in range(5):
        g = {k: (rng.normal(size=s) * 1e-3).astype(np.float32)
             for k, s in shapes.items()}
        jg = JC.compress_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, g), jef)
        tg = TC.compress_with_feedback(
            jax.tree_util.tree_map(torch.as_tensor, g), tef)
        for k in shapes:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(tef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))


@pytest.mark.parametrize("seed", range(5))
def test_int8_roundtrip_error_bounded(seed):
    g = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(333,)).astype(np.float32) * 10)
    out = TC.int8_roundtrip({"g": g})["g"]
    assert float((out - g).abs().max()) <= float(g.abs().max()) / 127.0 \
        * 0.51 + 1e-6


def test_error_feedback_unbiased_over_time():
    ef = TC.EFState({"w": torch.zeros(64)})
    true_g = torch.as_tensor(np.random.default_rng(0).normal(
        size=64).astype(np.float32) * 1e-3)
    acc = torch.zeros(64)
    for _ in range(64):
        acc = acc + TC.compress_with_feedback({"w": true_g}, ef)["w"]
    rel = float((acc - 64 * true_g).norm() / (64 * true_g).norm())
    assert rel < 0.05, rel


def test_compression_ratio():
    g = torch.as_tensor(np.random.default_rng(1).normal(
        size=1024).astype(np.float32))
    q, scale, _, _ = TC._quant_block(g)
    assert q.dtype == torch.int8
    assert q.numel() + scale.numel() * 4 < 0.3 * g.numel() * 4
