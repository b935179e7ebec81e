"""The port's train step and trainer (`training.train_loop`,
`launch.train`) against the JAX package on the CPU.

Steps run from the same weights (the reference's init with each
attention's wq and wk at 1/sqrt(d_model), as in
`test_torch_training.py`, which says why) on the same `SyntheticTokens`
batches.  Tolerances: losses and grad norms 1e-5 relative; params within
PARAM_TOL = 0.02 x lr of the reference's after the steps.  AdamW moves
an entry by about lr a step whatever its gradient's size, and an entry
whose gradient is near zero has g / (sqrt(v) + eps) moved by a large
part of that under rounding-level changes of g.  From the reference's
own init the packages' gradients already differ beyond these bounds at
the first step (the nearly hard-max attention, in both; see
`test_torch_training.py`), so the trainers' runs from that init are
compared by their first loss only."""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.launch import train as JTrain
from repro.models import model as JM
from repro.training.optimizer import AdamW as JAdamW
from repro.training.optimizer import cosine_schedule as j_cosine
from repro.training.train_loop import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.launch import train as TTrain
from repro_torch.models.convert import params_from_jax
from repro_torch.training import checkpoint as CK
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_loop import make_train_step
from repro_torch.training.trees import items

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
PARAM_TOL = 0.02 * LR
RTOL = 1e-5


def _tempered(tree, parent=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _tempered(v, k)
        else:
            v = np.asarray(v)
            if "attn" in parent and k in ("wq", "wk"):
                v = (v * np.sqrt(v.shape[-2] / v.shape[-3])).astype(v.dtype)
            out[k] = v
    return out


def _pair(arch, seed, tempered=True, **over):
    jc = dataclasses.replace(j_get_config(arch).reduced(), **over)
    tc = dataclasses.replace(get_config(arch).reduced(), **over)
    tree = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jc, jax.random.PRNGKey(seed)))
    if tempered:
        tree = _tempered(tree)
    tp = params_from_jax(tc, tree, device="cpu")
    tp.requires_grad_(True)
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, tree), tp


def _leaves(tree):
    return {tuple(k.key for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run_both(arch, steps, *, seed=5, B=4, S=64, over=None, **step_kw):
    """`steps` train steps in each package; returns the metrics per step
    and both final param trees."""
    jc, tc, jp, tp = _pair(arch, seed, **(over or {}))
    src = JSyntheticTokens(JDataConfig(vocab=tc.vocab, seq_len=S,
                                       global_batch=B, seed=seed))
    jopt = JAdamW(lr=LR, state_dtype=jc.state_dtype,
                  schedule=j_cosine(2, 10))
    topt = AdamW(lr=LR, state_dtype=tc.state_dtype,
                 schedule=cosine_schedule(2, 10))
    jstep = jax.jit(j_make_train_step(jc, jopt, **step_kw))
    tstep = make_train_step(tc, topt, **step_kw)
    js, ts = jopt.init(jp), topt.init(tp)
    out = []
    for s in range(steps):
        b = src.batch(s)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(b)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.as_tensor(b)})
        out.append((jm, tm))
    assert ts.step == int(js.step) == steps
    return out, jp, tp


def _check(out, jp, tp):
    for jm, tm in out:
        for k in ("loss", "grad_norm", "aux_loss"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=RTOL, atol=1e-7, err_msg=k)
        assert tm["tokens"] == int(jm["tokens"])
    ref = _leaves(jp)
    for path, x in items(tp):
        err = np.abs(x.detach().float().numpy() - ref[path]).max()
        assert err <= PARAM_TOL, (path, err)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b"])
def test_three_steps_track_reference(arch):
    _check(*_run_both(arch, 3))


def test_accum_steps_track_reference():
    """accum_steps=2: float32 sums of the microbatch gradients over 2,
    the losses' mean, as the reference's scan."""
    _check(*_run_both("yi-6b", 2, accum_steps=2))


def test_accum_steps_equal_one_big_batch():
    _, tc, _, tp = _pair("yi-6b", 6)
    opt = AdamW(lr=0.0, clip_norm=0.0)         # lr 0: compare the grads
    b = {"tokens": torch.as_tensor(JSyntheticTokens(JDataConfig(
        vocab=tc.vocab, seq_len=16, global_batch=4)).batch(0))}
    _, _, m1 = make_train_step(tc, opt)(tp, opt.init(tp), b)
    _, _, m2 = make_train_step(tc, opt, accum_steps=2)(tp, opt.init(tp), b)
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=RTOL)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=RTOL)
    with pytest.raises(ValueError, match="multiple"):
        make_train_step(tc, opt, accum_steps=3)(tp, opt.init(tp), b)


def test_bf16_params_accumulate_in_float32():
    """bfloat16 params: microbatch gradients summed in float32 (the
    reference's f32 accumulator), params stay bfloat16."""
    out, jp, tp = _run_both("yi-6b", 1, over=dict(param_dtype="bfloat16"),
                            accum_steps=2)
    assert all(x.dtype == torch.bfloat16 for _, x in items(tp))
    jm, tm = out[0]
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-4)
    ref = _leaves(jp)
    for path, x in items(tp):       # within a bfloat16 step of each entry
        r = ref[path]
        err = np.abs(x.detach().float().numpy() - r)
        assert (err <= 2 ** -8 * np.abs(r) + PARAM_TOL).all(), path


def test_compress_grads_track_reference():
    _check(*_run_both("yi-6b", 2, compress_grads=True))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _argv(*extra):
    return ["--arch", "yi-6b", "--reduced", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--log-every", "1", *extra]


def test_batches_bit_equal_to_reference():
    for arch in ("yi-6b", "whisper-medium"):
        argv = _argv("--seed", "3")
        argv[1] = arch
        targs = TTrain.parse_args(argv)
        jargs = argparse.Namespace(batch=2, seq=32, seed=3)
        jcfg = j_get_config(arch).reduced()
        tget = TTrain.build_batch_fn(TTrain.config_of(targs), targs, "cpu")
        jget = JTrain.build_batch_fn(jcfg, jargs)
        for step in (0, 5):
            tb, jb = tget(step), jget(step)
            assert set(tb) == set(jb)
            for k in jb:
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))


def test_first_loss_matches_reference_main(capsys):
    """Both trainers from the reference's init (`init_params(PRNGKey(
    seed))`): the same first loss; every loss finite."""
    argv = ["--arch", "yi-6b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "32", "--seed", "1", "--log-every", "1"]
    jl = JTrain.main(argv)
    targs = TTrain.parse_args(argv + ["--device", "cpu"])
    cfg = TTrain.config_of(targs)
    jc = j_get_config("yi-6b").reduced()
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init_params(jc, jax.random.PRNGKey(1)))
    hist = TTrain.run(cfg, params_from_jax(cfg, tree, device="cpu"), targs)
    np.testing.assert_allclose(hist["losses"][0], jl[0], rtol=RTOL)
    assert len(hist["losses"]) == len(jl) == 3
    assert np.isfinite(hist["losses"]).all()
    assert np.isfinite(hist["grad_norms"]).all()
    assert "[train] first loss" in capsys.readouterr().out


def test_run_is_the_train_step_loop():
    """`run` = make_train_step over the trainer's batches with AdamW(lr,
    cosine_schedule(20, steps)): the same losses, bit for bit."""
    targs = TTrain.parse_args(_argv("--steps", "3", "--seed", "2"))
    cfg = TTrain.config_of(targs)
    _, _, _, p1 = _pair("yi-6b", 2)
    _, _, _, p2 = _pair("yi-6b", 2)
    hist = TTrain.run(cfg, p1, targs)
    opt = AdamW(lr=targs.lr, schedule=cosine_schedule(20, 3))
    step = make_train_step(cfg, opt)
    get = TTrain.build_batch_fn(cfg, targs, "cpu")
    st = opt.init(p2)
    losses = []
    for s in range(3):
        p2, st, m = step(p2, st, get(s))
        losses.append(m["loss"].item())
    assert hist["losses"] == losses


@pytest.mark.parametrize("arch,extra", [
    ("whisper-medium", ()),
    ("qwen2-moe-a2.7b", ("--gee-embed-init", "--accum-steps", "2",
                         "--compress-grads")),
    ("zamba2-1.2b", ()), ("xlstm-1.3b", ())])
def test_main_runs_every_option(capsys, arch, extra):
    argv = _argv("--steps", "2", *extra)
    argv[1] = arch
    losses = TTrain.main(argv)
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "[train] first loss" in out
    assert ("GEE co-occurrence embedding init applied" in out) == \
        ("--gee-embed-init" in extra)


def test_gee_embed_init_sets_the_table(monkeypatch):
    """--gee-embed-init writes `gee_embedding_init`'s table, built from
    the first 4 batches' tokens over padded_vocab nodes, into the
    embedding before the first step."""
    from repro_torch.encoder import bridge
    seen = {}

    def fake(tokens, vocab, d_model, device):
        seen.update(n=tokens.shape[0], vocab=vocab, device=str(device))
        return np.full((vocab, d_model), 0.5, np.float32)

    monkeypatch.setattr(bridge, "gee_embedding_init", fake)
    targs = TTrain.parse_args(_argv("--steps", "0", "--gee-embed-init"))
    cfg = TTrain.config_of(targs)
    _, _, _, p = _pair("yi-6b", 0)
    hist = TTrain.run(cfg, p, targs)
    assert seen == dict(n=4 * 2 * 32, vocab=cfg.padded_vocab, device="cpu")
    assert bool((hist["params"]["embed"]["tokens"] == 0.5).all())


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        TTrain.main(["--arch", "yi-6b", "--reduced", "--steps", "1"])


def test_resume_after_a_lost_checkpoint(tmp_path, capsys):
    """9 steps with a checkpoint every 3; then the run is repeated after
    the last checkpoint is lost (as if the process died before writing
    it): it resumes from step 6 and its steps 6-8 equal the first run's
    (the same state and batches; CPU sums in a fixed order)."""
    d = str(tmp_path)
    argv = _argv("--steps", "9", "--ckpt-dir", d, "--ckpt-every", "3")
    first = TTrain.main(argv)
    assert CK.latest_step(d) == 9
    assert sorted(os.listdir(d)) == ["LATEST", "heartbeat_0",
                                     "step_000000003", "step_000000006",
                                     "step_000000009"]
    import shutil
    shutil.rmtree(os.path.join(d, "step_000000009"))
    assert CK.latest_step(d) is None          # LATEST names a lost dir
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("step_000000006")
    capsys.readouterr()
    again = TTrain.main(argv)
    assert "[train] resumed from step 6" in capsys.readouterr().out
    np.testing.assert_allclose(again, first[6:], rtol=1e-6)


@pytest.mark.slow
class TestCrashRecovery:
    def test_kill_mid_training_then_resume(self, tmp_path):
        """SIGKILL a port trainer subprocess mid-run; a fresh run must
        resume from the last complete checkpoint."""
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        env["OMP_NUM_THREADS"] = "2"
        base = [sys.executable, "-m", "repro_torch.launch.train",
                "--arch", "yi-6b", "--reduced", "--device", "cpu",
                "--batch", "2", "--seq", "32",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
                "--log-every", "1"]
        p = subprocess.Popen(base + ["--steps", "200"], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        deadline = time.time() + 300
        while time.time() < deadline:
            if (CK.latest_step(str(tmp_path)) or 0) >= 10:
                break
            time.sleep(0.5)
            if p.poll() is not None:
                break
        p.kill()
        p.wait()
        ck1 = CK.latest_step(str(tmp_path))
        assert ck1 is not None and ck1 >= 5
        r = subprocess.run(base + ["--steps", str(ck1 + 5)], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        assert f"resumed from step {ck1}" in r.stdout
