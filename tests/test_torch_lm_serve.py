"""repro_torch.launch.serve: greedy generation on the CPU.

* prefill + decode reproduce the port's own teacher-forced logits (atol
  1e-3, the JAX suite's serving-equivalence tolerance,
  `tests/test_serve.py`);
* `generate` gives the same greedy tokens as a greedy loop over the
  reference's `prefill` / `decode_step` with the same carried weights;
* `main` runs the reduced config on the CPU when asked and refuses the
  default device without a card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

VARIANTS = {"mqa": {}, "gqa": {"n_kv_heads": 2}}


@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_then_decode_matches_forward(variant, S):
    cfg = dataclasses.replace(get_config("yi-6b").reduced(),
                              **VARIANTS[variant])
    params = TM.init_params(cfg, 1, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(S).integers(
        0, cfg.vocab, (2, S + 2)))
    with torch.inference_mode():
        full, _ = TM.forward_logits(cfg, params, toks, impl="full")
        full = TM._mask_padded_vocab(cfg, full)
        pl, cache = TM.prefill(cfg, params, {"tokens": toks[:, :S]},
                               max_len=S + 8)
        torch.testing.assert_close(pl, full[:, S - 1], atol=1e-3, rtol=0)
        for i in range(2):
            logits, cache = TM.decode_step(cfg, params, toks[:, S + i],
                                           S + i, cache)
            torch.testing.assert_close(logits, full[:, S + i], atol=1e-3,
                                       rtol=0)


def _jax_greedy(cfg, params, prompts, gen):
    """The reference's serve loop (`repro.launch.serve.main`) without
    its mesh and jit."""
    S = prompts.shape[1]
    logits, cache = JM.prefill(cfg, params, {"tokens": jnp.asarray(prompts)},
                               max_len=S + gen)
    toks = jnp.argmax(logits, -1)
    out = [np.asarray(toks)]
    for i in range(gen - 1):
        logits, cache = JM.decode_step(cfg, params, toks, jnp.int32(S + i),
                                       cache)
        toks = jnp.argmax(logits, -1)
        out.append(np.asarray(toks))
    return np.stack(out, 1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_matches_reference_greedy_loop(variant):
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(j_get_config("yi-6b").reduced(), **kw)
    tcfg = dataclasses.replace(get_config("yi-6b").reduced(), **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, tcfg.vocab, (3, 40)).astype(np.int32)
    timings = {}
    got = serve.generate(tcfg, tp, torch.as_tensor(prompts), 8,
                         timings=timings)
    assert got.shape == (3, 8)
    assert set(timings) == {"prefill_s", "decode_s"}
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_greedy(jcfg, jp, prompts, 8))


def test_main_on_cpu_returns_tokens(capsys):
    gen = serve.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--gen", "5"])
    assert isinstance(gen, np.ndarray) and gen.shape == (2, 5)
    assert np.issubdtype(gen.dtype, np.integer)
    assert ((gen >= 0) & (gen < get_config("yi-6b").reduced().vocab)).all()
    out = capsys.readouterr().out
    assert "[serve] prefill" in out and "[serve] decode" in out


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "yi-6b", "--reduced"])


def test_main_refuses_unported_arch():
    """Every id of the reference's registry is ported; an id neither
    package knows raises."""
    with pytest.raises(KeyError, match="unknown arch"):
        serve.main(["--arch", "no-such-arch", "--reduced", "--device",
                    "cpu"])
