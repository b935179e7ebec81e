"""Every arch of the registry against the JAX package on the CPU.

Each arch runs at its reduced config (`cfg.reduced()`: d_model 64, 4
heads, attn_chunk 32, at most 4 layers; 2 + 2 for whisper) with the
reference's `init_params` weights carried over by `params_from_jax`,
and the same numpy tokens (and, for whisper, frames): `prefill` at
S = 64 > attn_chunk (both packages take the chunked path), then two
`decode_step`s.  Logits and every cache leaf (KV caches, SSM conv and
state, mLSTM C / n / m, sLSTM c / n / m / h, whisper's cross K/V) are
held to the reference's within `test_torch_models.py`'s tolerances:
logits atol 1e-3, caches atol 1e-3 + rtol 1e-4 (see there why not
1e-4), with one widening: a cache leaf's atol is at least
CACHE_SCALE x max|leaf|.  The attention K/V of the reduced dense and
MoE stacks need it.  With the reference's init the attention of random
weights is nearly a hard max, so the rounding in a layer's input grows
10-20 times a layer, in both packages at float32: layer 0's K/V agree
to 1e-5, layer 3's (entries up to 28) to 3.4e-3, while the logits agree
to 1.3e-4.  The port writes caches in place, so each step's leaves are
copied out before the next."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

ARCHS = j_list_archs()
LOGITS = dict(atol=1e-3, rtol=0)
CACHE = dict(atol=1e-3, rtol=1e-4)
CACHE_SCALE = 2e-4
S = 64


def _numpy_tree(tree):
    """A cache (either package's) as nested dicts of float32 numpy."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().float().numpy().copy()
    return np.asarray(tree, np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _inputs(cfg, B=2, n=S + 2, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    frames = None
    if cfg.is_encdec:
        frames = rng.normal(size=(B, cfg.n_frames, cfg.d_model)).astype(
            np.float32)
    return toks, frames


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Both packages' logits and caches after prefill and each of two
    decode steps, for one arch."""
    arch = request.param
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    toks, frames = _inputs(tcfg)
    jb, tb = {"tokens": jnp.asarray(toks[:, :S])}, \
        {"tokens": torch.as_tensor(toks[:, :S])}
    if frames is not None:
        jb["frames"], tb["frames"] = jnp.asarray(frames), \
            torch.as_tensor(frames)
    out = {"arch": arch, "tcfg": tcfg, "jcfg": jcfg, "tp": tp, "jp": jp,
           "toks": toks, "frames": frames, "logits": [], "caches": []}
    jl, jc = JM.prefill(jcfg, jp, jb, max_len=S + 8)
    with torch.inference_mode():
        tl, tc = TM.prefill(tcfg, tp, tb, max_len=S + 8)
    out["logits"].append((tl.numpy().copy(), np.asarray(jl)))
    out["caches"].append((_numpy_tree(tc), _numpy_tree(jc)))
    for i in range(2):
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, S + i]),
                                jnp.int32(S + i), jc)
        with torch.inference_mode():
            tl, tc = TM.decode_step(tcfg, tp, torch.as_tensor(toks[:, S + i]),
                                    S + i, tc)
        out["logits"].append((tl.numpy().copy(), np.asarray(jl)))
        out["caches"].append((_numpy_tree(tc), _numpy_tree(jc)))
    return out


def test_prefill_logits(run):
    t, j = run["logits"][0]
    assert t.shape == (2, run["tcfg"].padded_vocab)
    np.testing.assert_allclose(t, j, **LOGITS)


@pytest.mark.parametrize("step", [1, 2])
def test_decode_step_logits(run, step):
    t, j = run["logits"][step]
    np.testing.assert_allclose(t, j, **LOGITS)


@pytest.mark.parametrize("step", [0, 1, 2], ids=["prefill", "decode1",
                                                 "decode2"])
def test_every_cache_leaf(run, step):
    t, j = run["caches"][step]
    tl, jl = dict(_leaves(t)), dict(_leaves(j))
    assert tl.keys() == jl.keys()
    for name in jl:
        if jl[name] is None:
            assert tl[name] is None, name
            continue
        assert tl[name].shape == jl[name].shape, name
        atol = max(CACHE["atol"], CACHE_SCALE * np.abs(jl[name]).max())
        np.testing.assert_allclose(tl[name], jl[name], atol=atol,
                                   rtol=CACHE["rtol"],
                                   err_msg=f"{run['arch']}: {name}")


def test_cache_specs_equal_reference(run):
    """`init_cache` has the reference's leaves, shapes and dtypes (and
    the reference's zeros, m of the mLSTM included)."""
    tcfg, jcfg = run["tcfg"], run["jcfg"]
    t = TM.init_cache(tcfg, 3, 40, device="cpu")
    j = JM.init_cache(jcfg, 3, 40)
    tl, jl = dict(_leaves(t)), dict(_leaves(j))
    assert tl.keys() == jl.keys()
    for name, leaf in jl.items():
        if leaf is None:
            assert tl[name] is None
            continue
        assert tuple(tl[name].shape) == leaf.shape, name
        assert str(tl[name].dtype).split(".")[-1] == str(leaf.dtype), name
        assert not bool(tl[name].any()), name


def test_forward_logits(run):
    tcfg, jcfg = run["tcfg"], run["jcfg"]
    toks, frames = run["toks"][:, :40], run["frames"]
    with torch.inference_mode():
        t, taux = TM.forward_logits(
            tcfg, run["tp"], torch.as_tensor(toks),
            frames=None if frames is None else torch.as_tensor(frames))
    j, jaux = JM.forward_logits(jcfg, run["jp"], jnp.asarray(toks),
                                frames=None if frames is None
                                else jnp.asarray(frames))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **LOGITS)
    # the MoE load-balance loss (0 for every other family)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_main_on_cpu_serves_every_arch(arch, capsys):
    """`launch.serve` on the CPU for every id, the port's own random
    weights (the SSM's A_log / dt_bias inits included).  The prompt is a
    multiple of the reduced window (32), which both packages' ring-buffer
    fill requires once the prompt reaches the window."""
    gen = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "64", "--gen", "3"])
    assert gen.shape == (2, 3)
    assert ((gen >= 0) & (gen < get_config(arch).reduced().vocab)).all()
    assert f"arch={arch}" in capsys.readouterr().out
