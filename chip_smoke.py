"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--steps 8] [--lm-batch 4]
                          [--lm-prompt 2048] [--lm-gen 16] [--lm-layers 32]
                          [--fam-layers N] [--train-layers 12]
                          [--train-steps 8]

1. builds every CUDA kernel of `src/repro_torch/kernels/csrc` with nvcc;
   It counts the HGMMA (wgmma) instructions in the flash library's SASS
   where the toolkit has `cuobjdump` (none fails the run) and requires
   ptxas to report no spills in the bfloat16 flash body;
2. holds each kernel against its plain PyTorch version on the card at
   small shapes (for gee_scatter also K = 256, one row holding 50,000
   contributions and rows whose donors mostly share a class, each
   bit-equal to a serial float32 sum in packed order; duplicate-heavy tie
   cases for top-k included, one at
   K = 16 whose ties straddle the select pass's tiles and blocks; for
   flash attention the JAX suite's MHA/GQA/MQA cases in float32 and
   bfloat16, ragged S, every D of the tensor-core body, yi's heads at
   S = 2049 and the prefill's shape at S = 2047), and requires two runs
   to give the same bits; and the widths outside the main path's bodies:
   gee_delta_renorm at K = 200, topk_fused at K = 300 and at k = 100,
   flash attention at D = 96 (zero-padded to 128) and at D = 160 and
   256 in both dtypes (the wide body for D > 128);
3. drives the GEE path at the scale of SNAP soc-LiveJournal1 (an SBM
   with n = 4,847,571 nodes, s = 68,993,773 edges, K = 16, 10% labeled):
   `Embedder(backend="cuda").fit`, then two `EmbeddingShard`s
   (`RowPartition(n, 2)`, backend "cuda") serving `--steps` steps of one
   200-edge delta through `apply_delta` and one 64-node top-k read
   (k = 10) through `topk_candidates` + `merge_topk`.  Kernel launch
   counts are zeroed just before and read just after;
4. holds each kernel against its plain version again at the main path's
   shapes and times kernel, plain version and one PyTorch library call
   with CUDA events (for top-k also its select and merge passes, each
   launched on its own; for gee_scatter also the kernel with every node
   labelled, as in a refine round, and one whole `CudaBackend.embed`;
   and the general bodies at one wide shape each: top-k with k = 100 on
   shard 0's rows, top-k at K = 300 and the delta kernel at K = 200 on
   262,144 random rows; each of these shapes, and the skew graph's
   scatter, also beside its library call);
5. self-checks: the shards' Z equals a fresh fit on the updated graph,
   and the fused answers equal the plain scan's on the same Zn;
5'. the plan cache and refinement on the same graph: a cuda fit with a
   persistent plan cache in a temporary directory (a miss, then the
   entry's store), a second `Embedder` on the graph (a disk hit, Z
   bit-equal to the miss's), then `Embedder.refine` (10 rounds, one
   `gee_scatter` launch per round plus the final embed).  Prints miss,
   store and hit seconds, the entry's bytes and seconds per round;
5a. the durable serving engine on the same graph (`ServingEngine`,
   2 shards, backend "cuda", a data directory in the temporary
   directory): generation 0 (compaction, snapshot, shard builds), then
   `start()` with a `MicroBatcher` and 8 ticks of the serving CLI's
   mix (eight 64-node reads of every kind, top-k with k = 10; a 200-edge
   insert; from tick 3 a deletion of an earlier insert; label reveals of
   n / 100 + 1 nodes at ticks 3 and 6), a check of the live Z against a
   torch-backend fit of the store's edges; then the IVF index:
   `enable_index()` (build seconds), ivf at nprobe = K bit-equal to the
   exact read, nprobe = 2's recall@10 and ms per 64-query read beside
   the exact read's, three 200-edge deltas with the index maintained
   (`update_index` ms and rows moved); `checkpoint()`, close and
   `ServingEngine.open`: the same (version, epoch, fingerprint), Z,
   held-back top-k answers, index centroids, cell sizes and nprobe = 2
   answers; last two more reopens with a persistent plan cache (a miss
   that stores the shards' plans, then a hit).  Launch counts are zeroed
   just before; all three GEE kernels must run.  Prints each step's
   time, each tick's write and read latencies and peak device memory;
5b. frees the GEE path's tensors and fits a skewed graph with
   LiveJournal's degree spread (`powerlaw(n, s, alpha=0.5)`: largest
   degree about 15,700, 10% labelled) on the cuda backend, held to the
   torch backend's fit; prints the plan's device bytes, the kernel's
   time and share of its bound, and peak device memory;
5c. the multi-process deployment on phase 5a's graph
   (`repro_torch.transport`): a durable `ServingEngine` with
   ``transport="socket"`` (4 shard worker processes: at 2 shards a build
   frame would exceed the codec's 512 MiB `MAX_FRAME`) and one WAL-tail
   replica worker, all on the card, against a non-durable in-process
   4-shard engine on the same compacted edges; --steps ticks of a 64-node
   top-k read, a 200-edge insert and another read through a
   `MicroBatcher` on each (reads try the replica first, pinned to the
   version, and fall back to the owners).  Every answer, every worker's
   Z slice and top-k candidates are bit-equal to the in-process
   engine's; the caught-up replica's pinned reads equal the owner's;
   every worker's `ping` reports a cuda device and launches of the
   three GEE kernels.  Then a shard worker killed before a write (which
   fails loudly after its WAL append), `ServingEngine.open` with fresh
   workers (the in-process engine's (version, epoch, fingerprint), Z
   within rtol 1e-5, top-k under `topk_equivalent`) and a
   `checkpoint()` of the reopened deployment.  Prints spawn + handshake,
   build (with frame bytes), bootstrap, ticket, reopen and checkpoint
   seconds, the replica's share of reads, and each process's device
   memory (the workers' pings; nvidia-smi's compute-apps list);
6. frees the skew phase's tensors and drives the LM serve path: yi-6b at
   full width (d_model 4096, 32 layers, GQA 32/4, float32 weights drawn
   on the card from --seed, bfloat16 compute) through
   `repro_torch.launch.serve.generate`: one prefill of --lm-batch
   prompts of --lm-prompt tokens, then --lm-gen greedy tokens.  Launch
   counts are zeroed just before and read just after: flash attention
   runs once per layer in prefill and never in decode.  One more
   prefill and decode step run under torch.profiler (device busy time
   by kernel).  Self-check, layer by layer on the same input: each
   block on the kernel path against the dense plain attention path, in
   prefill and in the first decode step, and `prefill`'s and
   `decode_step`'s logits against that run's (see LM_REL_TOL); then the
   flash kernel is held against its plain version and timed at the
   prefill's shape;
7. the LM families (`FAMILIES`): each of the other nine archs of the
   registry at full width, its weights drawn from --seed, through
   `generate` at --lm-batch prompts of --lm-prompt tokens (whisper also
   gets n_frames random frame embeddings): qwen2-moe-a2.7b at full
   depth with --lm-gen tokens (this phase's main path), the others with
   FAMILY_GEN (8) tokens at 12 layers at most (grok-1-314b 6, xLSTM one
   group of 8).  Launch counts are zeroed just before each arch's run and
   read just after: flash attention runs once per causal
   self-attention in prefill (zamba2: once per group; whisper: the
   decoder's layers; xLSTM: never).  One prefill and one decode step
   run under torch.profiler (device busy time, idle share).  Then the
   self-check of `family_self_check`, block by block on the same input,
   by the rule of step 6; last, the kernel at the families' other head
   dims (D = 64 for whisper and zamba2, D = 120 for danube) against its
   plain version, timed beside SDPA;
8. the LM training path (`train_path`), at --lm-batch x --lm-prompt:
   a. `FlashAttentionFunction` (the kernel's forward, a plain backward)
      at yi-6b's attention shape against autograd of the plain attention:
      output at the bfloat16 tolerance, dq, dk, dv within LM_REL_TOL x
      max|plain|; forward + backward timed beside the plain version and
      SDPA's;
   b. gradient parity at yi-6b's width, 2 layers: one step's gradients
      with the kernel's forward against those with the plain attention
      (`impl="triangular"`, attn_flash's values), same params and batch.
      At the reference's init wq, wk and wv must get a non-zero gradient
      (the gap is printed beside the dense path's); with wq and wk at
      1/sqrt(d_model) (`temper_attention`) every leaf must be within
      LM_REL_TOL x max|g_plain|;
   c. checkpoint and resume on that model: 4 AdamW steps, an atomic
      checkpoint in a temporary directory, a restore into a fresh tree
      (every leaf bit-equal), then steps 5-8 from both, losses within
      RESUME_TOL;
   d. the main path, `repro_torch.launch.train.run` (the trainer's loop):
      yi-6b at full width, --train-layers of its 32 layers (float32
      params and AdamW state need 16 B a parameter: 12 layers are 41.6
      GB, 32 would be 97), remat on, bfloat16 compute, --train-steps
      steps with --gee-embed-init, lr 3e-4 and the reference's cosine
      schedule, from random weights with wq and wk at 1/sqrt(d_model)
      (at the reference's init the gradient norm is about 3e10 and
      clipping leaves the 1-D final norm's update under a float32 step).
      Launch counts are zeroed just before and read just after: flash twice per layer per step (forward and remat), the
      scatter kernel at least 7 times in the embedding init (fit + 6
      refine rounds).  Every loss and grad norm finite, every leaf
      changed.  One more step runs under torch.profiler (device idle
      share);
   e. every arch's reduced config with remat: two train steps on the
      card against the same two on the CPU from the same weights (wq
      and wk tempered),
      losses within FAM_TRAIN_TOL; flash launched twice per causal
      self-attention per step.

Prints each phase's wall seconds, the card's name and power limit, a
``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero.  Without a card, or without the repository's
`src/repro_torch` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
# FP32 instructions a second: 67e12 counts an FMA as two operations
FP32_INSTR = FP32_FLOPS / 2
# H100 SXM dense bf16 on the tensor cores.  Attention on bf16 inputs is
# two matrix products per tile, work the card does at this rate (the
# library call below does): the least time for it is against this peak,
# whatever arithmetic a given kernel uses.
BF16_TC_FLOPS = 989e12
# LM self-check tolerance: max|diff| <= LM_REL_TOL * max|reference|,
# per layer on the same input (the bfloat16 tolerance of the JAX suite's
# kernel test).  Both paths compute attention in float32 from the same
# bfloat16 q, k, v and round the output to bfloat16 (relative step
# 2^-8 = 0.0039), so a block's outputs differ by a few such steps at
# most.  Free-running logits are not held to it: with the reference's
# init (wq's fan-in is its head count) the attention of random weights
# is nearly a hard max, so one flipped rounding grows layer by layer and
# two correct paths drift apart over 32 layers, at float32 too.
LM_REL_TOL = 2e-2
# Phase 7, the other LM families at full width: (arch, layers run; None:
# all).  FAMILY_MAIN is this phase's full-depth main path, generating
# --lm-gen tokens; the others generate FAMILY_GEN at no more than 12
# layers (a whole group for xLSTM: 8), so that the whole run stays near
# ten minutes beside phase 5c.  grok-1-314b runs 6: about 9.2 GiB a layer
# of bfloat16 weights (590 GiB in all) on one 80 GB card.
FAMILIES = (("qwen2-moe-a2.7b", None), ("yi-9b", 12),
            ("h2o-danube-3-4b", 12), ("chameleon-34b", 12),
            ("qwen1.5-110b", 12), ("grok-1-314b", 6), ("zamba2-1.2b", 12),
            ("whisper-medium", 12), ("xlstm-1.3b", 12))
FAMILY_MAIN = "qwen2-moe-a2.7b"
FAMILY_GEN = 8


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def topk_equivalent(idx_a, val_a, idx_b, val_b, atol=1e-5):
    """Tie-tolerant top-k agreement (the test suite's `topk_equivalent`):
    scores match everywhere; ids match wherever the slot is separated
    from both neighbours by more than atol."""
    val_a, val_b = np.asarray(val_a), np.asarray(val_b)
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    np.testing.assert_allclose(val_a, val_b, atol=atol)
    with np.errstate(invalid="ignore"):
        gap = (val_a[:, :-1] - val_a[:, 1:]) > atol
    no_tie = np.ones(idx_a.shape, bool)
    no_tie[:, 1:] &= gap
    no_tie[:, :-1] &= gap
    no_tie[:, -1] = False
    np.testing.assert_array_equal(idx_a[no_tie], idx_b[no_tie])


class Timer:
    """Milliseconds per call from CUDA events over `reps` calls, after
    `warm` calls that are not timed."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int, warm: int = 1,
                 queue_ahead: bool = False) -> float:
        """queue_ahead: hold the stream in a spin kernel while the host
        enqueues the calls, so that a launch shorter than its host-side
        set-up is timed on the device alone."""
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(100_000_000)        # tens of ms of spin
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_times(prof):
    """(device ms summed over kernels and copies, their count,
    [(name, (ms, count))] largest first) from a torch.profiler profile;
    one stream, so the sum is the device's busy time."""
    from torch.autograd import DeviceType
    agg = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = agg.get(e.name, (0.0, 0))
            agg[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return (sum(ms for ms, _ in agg.values()),
            sum(n for _, n in agg.values()),
            sorted(agg.items(), key=lambda kv: -kv[1][0]))


def ptxas_spills(log: str) -> dict:
    """{function: spill bytes stored + loaded} from `nvcc -Xptxas -v`;
    functions that ptxas did not report (already built) are absent."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[fn] = nums[1] + nums[2]   # stack frame, stores, loads
            fn = None
    return out


def count_hgmma(lib):
    """HGMMA instructions in a library's SASS, or None without
    `cuobjdump`."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        return None
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def expected_flash(cfg, S):
    """Flash launches of one prefill: one per causal self-attention
    (none for xLSTM, the shared block once per zamba2 group, the
    decoder's layers for whisper, none where a window masks)."""
    if cfg.xlstm is not None:
        return 0
    if cfg.is_encdec:
        return cfg.dec_layers
    if cfg.ssm is not None:
        return cfg.n_layers // cfg.attn_every
    if cfg.swa_window and S > cfg.swa_window:
        return 0
    return cfg.n_layers


def same(a, b) -> bool:
    return bool((a == b).all().item()) and a.shape == b.shape


# Phase 8, the LM training path.  Where two paths' gradients or steps
# are compared, every attention's wq and wk are first scaled from the
# reference init's 1/sqrt(heads) to 1/sqrt(d_model) (`temper_attention`,
# as the CPU tests do): under the reference's init attention scores
# reach the thousands, so one rounding step in a layer's output moves the
# next layer's scores by whole units and the gradients of two correct
# paths apart by tens of percent (the smoke prints that gap beside the
# one between two plain paths).  FAM_TRAIN_TOL holds each reduced
# family's two train steps on the card against the same two on the CPU
# (float32 both; the card's matrix products in full float32): the two
# sides differ by summation order, at float32's rounding level in the
# first step's forward (the CPU tests hold the packages to 1e-5 over
# three steps), and the first AdamW step moves a weight by up to lr
# whatever its gradient's size, so a gradient near zero whose sign
# rounds differently moves its weight 2 lr apart; 1e-4 of the loss
# leaves room for that.  RESUME_TOL holds the resumed run's
# losses against the uninterrupted run's: the state is restored bit for
# bit and the batches are the same, so only sums whose order varies
# from run to run on the card (an index backward that adds rows with
# atomics) could separate the two, by a few float32 steps an update.
FAM_TRAIN_TOL = 1e-4
RESUME_TOL = 1e-4


def temper_attention(torch, params):
    """Scale every attention's wq and wk ((..., d_model, heads,
    head_dim), under an "attn" key) from 1/sqrt(heads) to
    1/sqrt(d_model), in place."""
    from repro_torch.training.trees import items
    with torch.no_grad():
        for path, t in items(params):
            if (len(path) > 1 and "attn" in path[-2]
                    and path[-1] in ("wq", "wk")):
                t.mul_((t.shape[-2] / t.shape[-3]) ** 0.5)


def _fingerprints(torch, params):
    """(sum, sum of squares) in float64 of every leaf, to tell a leaf
    that changed from one that did not without a copy of the model."""
    from repro_torch.training.trees import items
    return {path: torch.stack([t.detach().double().sum(),
                               t.detach().double().square().sum()])
            for path, t in items(params)}


def train_path(torch, dev, args, timer, smi):
    """Phase 8 (the LM training path); see the module docstring.  Returns
    the additions to the flash and gee_scatter rows of the kernels
    line."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config, list_archs
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import _build
    from repro_torch.launch import train as TR
    from repro_torch.models import model as M
    from repro_torch.models.attention import (FlashAttentionFunction,
                                              causal_plain)
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.trees import build, flatten, items

    B, S = args.lm_batch, args.lm_prompt
    yi = get_config("yi-6b")
    flash_add, scatter_add = {}, {}

    def rel(got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        return err, err / max(ref.float().abs().max().item(), 1e-30)

    # -- 8a. FlashAttentionFunction at yi's shape: forward and gradients
    H, KV, D, C = yi.n_heads, yi.n_kv_heads, yi.head_dim, yi.attn_chunk
    gen_ = torch.Generator(device=dev).manual_seed(args.seed + 11)
    q, k, v = (torch.randn((B, S, h_, D), generator=gen_, device=dev,
                           dtype=torch.bfloat16) for h_ in (H, KV, KV))
    w = torch.randn((B, S, H, D), generator=gen_, device=dev)

    def fwd_bwd(fn):
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        o = fn(*ins)
        (o.float() * w).sum().backward()
        return o.detach(), [t.grad for t in ins]

    def fn_kernel(*t):
        return FlashAttentionFunction.apply(*t, C)

    def fn_plain(*t):
        return causal_plain(*t, C)

    def fn_library(*t):        # SDPA in its (B, H, S, D) layout
        return torch.nn.functional.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in t), is_causal=True,
            enable_gqa=True).transpose(1, 2)

    _build.reset_launches()
    o_k, g_k = fwd_bwd(fn_kernel)
    n_fn = _build.launches["flash_attention"]
    o_p, g_p = fwd_bwd(fn_plain)
    if n_fn != 1:
        raise AssertionError(f"FlashAttentionFunction launched the kernel "
                             f"{n_fn} times, expected 1")
    err_o = rel(o_k, o_p)
    errs_g = [rel(a, b) for a, b in zip(g_k, g_p)]
    print(f"FlashAttentionFunction at B={B} S={S} H={H} KV={KV} D={D} "
          f"bf16: output max|diff| {err_o[0]:.3e} vs plain; dq, dk, dv "
          f"max|diff| / max|plain| " + ", ".join(
              f"{r_:.3e}" for _, r_ in errs_g)
          + f" (bit-equal {[bool(torch.equal(a, b)) for a, b in zip(g_k, g_p)]})")
    if not torch.allclose(o_k.float(), o_p.float(), rtol=2e-2, atol=2e-2):
        raise AssertionError("FlashAttentionFunction output off")
    if any(not r_ <= LM_REL_TOL for _, r_ in errs_g):
        raise AssertionError("FlashAttentionFunction gradients off")
    del o_k, o_p, g_k, g_p
    flops = 4.0 * D * B * H * S * (S + 1) / 2       # causal pairs x 4 D
    # forward, then the backward's recompute and its four products
    flops_fb = 3.5 * flops
    # bfloat16 bytes: q, k, v and dO read, o, dq, dk and dv written
    nbytes = 2 * (5 * B * H * S * D + 6 * B * KV * S * D)
    flash_add.update(
        train_fn_ms=timer(lambda: fwd_bwd(fn_kernel), 3),
        train_fn_plain_ms=timer(lambda: fwd_bwd(fn_plain), 3),
        train_fn_library_ms=timer(lambda: fwd_bwd(fn_library), 5),
        train_fn_bound_ms=bound_ms(nbytes, flops_fb, BF16_TC_FLOPS)[0])
    print(f"FlashAttentionFunction forward + backward: "
          f"{flash_add['train_fn_ms']:.3f} ms (the backward plain), plain "
          f"{flash_add['train_fn_plain_ms']:.3f} ms, library (SDPA) "
          f"{flash_add['train_fn_library_ms']:.3f} ms, bound "
          f"{flash_add['train_fn_bound_ms']:.4f} ms")
    del q, k, v, w

    # -- 8b. gradient parity: the kernel's forward vs the plain one ------
    cfg2 = dataclasses.replace(yi, n_layers=2)
    p2 = M.init_params(cfg2, args.seed, device=dev)
    p2.requires_grad_(True)
    tok0 = SyntheticTokens(DataConfig(vocab=yi.vocab, seq_len=S,
                                      global_batch=B, seed=args.seed))
    batch = {"tokens": torch.as_tensor(tok0.batch(0), device=dev)}
    paths, leaves = zip(*items(p2))

    def grads(impl):
        loss, _ = M.forward_train(cfg2, p2, batch, impl=impl)
        return loss.item(), torch.autograd.grad(loss, leaves)

    def gaps(ga, gb):
        """(worst max|a - b| / max|b| over the leaves, its leaf)."""
        return max((rel(a, b)[1], "/".join(p_))
                   for p_, a, b in zip(paths, ga, gb))

    # the reference's init: wq's fan-in is its head count, so attention
    # scores reach the thousands and a bfloat16 step in a layer's output
    # moves the next layer's scores by whole units; printed beside the
    # gap between two plain paths (dense vs triangular), not held
    _build.reset_launches()
    loss_k, gk = grads("flash")
    n_par = _build.launches["flash_attention"]
    loss_t, gt = grads("triangular")        # attn_flash's values, plain
    if n_par != 2 * cfg2.n_layers:
        raise AssertionError(f"gradient parity: flash launched {n_par} "
                             f"times, expected {2 * cfg2.n_layers} (remat)")
    g_of = dict(zip(paths, gk))
    zero = [n_ for n_ in ("wq", "wk", "wv")
            if not g_of[("stack", "attn", n_)].abs().max().item() > 0]
    if zero:
        raise AssertionError(f"no gradient reached {zero}")
    ref_gap = gaps(gk, gt)
    del gk
    loss_f, gf = grads("full")
    plain_gap = gaps(gf, gt)
    del gf, gt
    print(f"gradient parity at the reference's init (printed, not held): "
          f"loss kernel {loss_k:.6f}, triangular {loss_t:.6f}, dense "
          f"{loss_f:.6f}; worst leaf kernel vs triangular "
          f"{ref_gap[0]:.3e} ({ref_gap[1]}), dense vs triangular "
          f"{plain_gap[0]:.3e} ({plain_gap[1]}); max|g| wq "
          f"{g_of[('stack', 'attn', 'wq')].abs().max().item():.3e}, wk "
          f"{g_of[('stack', 'attn', 'wk')].abs().max().item():.3e}, wv "
          f"{g_of[('stack', 'attn', 'wv')].abs().max().item():.3e}")
    del g_of
    # held: wq and wk at 1/sqrt(d_model), scores of order one
    temper_attention(torch, p2)
    loss_k, gk = grads("flash")
    loss_t, gt = grads("triangular")
    worst = gaps(gk, gt)
    print(f"gradient parity, yi-6b width, 2 layers, B={B} S={S}, wq and "
          f"wk at 1/sqrt(d_model): loss kernel {loss_k:.6f} / plain "
          f"{loss_t:.6f}; worst leaf {worst[1]} at {worst[0]:.3e} of "
          f"max|g_plain| (tol {LM_REL_TOL}); flash launches {n_par}")
    if not worst[0] <= LM_REL_TOL:
        raise AssertionError(f"gradient parity: {worst[1]} off")
    del gk, gt, leaves

    # -- 8c. checkpoint and resume (2 layers at full width) --------------
    targs = TR.parse_args(["--arch", "yi-6b", "--batch", str(B), "--seq",
                           str(S), "--seed", str(args.seed)])
    get_batch = TR.build_batch_fn(cfg2, targs, dev)
    opt = AdamW(lr=3e-4, state_dtype=cfg2.state_dtype,
                schedule=cosine_schedule(warmup=20, total=8))
    step_fn = make_train_step(cfg2, opt)
    st = opt.init(p2)
    for s_ in range(4):
        p2, st, _ = step_fn(p2, st, get_batch(s_))
    with tempfile.TemporaryDirectory() as d_:
        t0 = time.perf_counter()
        CK.save_checkpoint(d_, 4, (p2, st))
        save_s = time.perf_counter() - t0
        nbytes_ck = sum(f_.stat().st_size for f_ in Path(d_).rglob("*")
                        if f_.is_file())
        t0 = time.perf_counter()
        (rp, rst), rstep = CK.restore_checkpoint(d_, (p2, st))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    a_leaves, b_leaves = flatten((p2, st))[0], flatten((rp, rst))[0]
    if rstep != 4 or rst.step != st.step or len(a_leaves) != len(b_leaves):
        raise AssertionError("restored checkpoint: step or leaves off")
    unequal = [i for i, (a, b) in enumerate(zip(a_leaves, b_leaves))
               if not (a == b if not torch.is_tensor(a)
                       else a.dtype == b.dtype and torch.equal(a, b))]
    if unequal:
        raise AssertionError(f"restored leaves not bit-equal: {unequal}")
    del a_leaves, b_leaves
    rp.requires_grad_(True)
    straight, resumed = [], []
    for s_ in range(4, 8):
        p2, st, m_ = step_fn(p2, st, get_batch(s_))
        straight.append(m_["loss"].item())
    del p2, st
    for s_ in range(4, 8):
        rp, rst, m_ = step_fn(rp, rst, get_batch(s_))
        resumed.append(m_["loss"].item())
    del rp, rst
    gap = max(abs(a - b) / abs(a) for a, b in zip(straight, resumed))
    print(f"checkpoint at step 4 (2 layers, {nbytes_ck / 2**30:.2f} GiB): "
          f"save {save_s:.1f} s, restore {restore_s:.1f} s, every leaf "
          f"bit-equal; steps 5-8 resumed {resumed} vs uninterrupted "
          f"{straight}: max rel gap {gap:.3e} (tol {RESUME_TOL}); step 5 "
          f"bit-equal {resumed[0] == straight[0]}")
    if not gap <= RESUME_TOL:
        raise AssertionError("resumed run off the uninterrupted one")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8d. the main path: `launch.train.run` at full width ------------
    cfg = dataclasses.replace(yi, n_layers=args.train_layers)
    steps = args.train_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, args.seed, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    # the gradient norm at the reference's init (printed): clipping at 1
    # would scale every update to about its inverse
    params.requires_grad_(True)
    loss, _ = M.forward_train(cfg, params, TR.build_batch_fn(
        cfg, TR.parse_args(["--arch", "yi-6b", "--batch", str(B), "--seq",
                            str(S), "--seed", str(args.seed)]), dev)(0))
    ref_norm = torch.sqrt(sum(g_.float().square().sum() for g_ in
                              torch.autograd.grad(loss, list(
                                  params.parameters())))).item()
    del loss
    temper_attention(torch, params)
    before = _fingerprints(torch, params)
    targs = TR.parse_args([
        "--arch", "yi-6b", "--steps", str(steps), "--batch", str(B),
        "--seq", str(S), "--lr", "3e-4", "--gee-embed-init", "--seed",
        str(args.seed), "--log-every", "1"])
    _build.reset_launches()
    t0 = time.perf_counter()
    hist = TR.run(cfg, params, targs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    params = hist["params"]
    want = 2 * cfg.n_layers * steps
    if launches["flash_attention"] != want:
        raise AssertionError(f"train path: flash_attention launched "
                             f"{launches['flash_attention']} times, "
                             f"expected {want} (forward + remat, each "
                             "layer, each step)")
    if launches["gee_scatter"] < 6 + 1:
        raise AssertionError(f"train path: gee_scatter launched "
                             f"{launches['gee_scatter']} times in the "
                             "embedding init, expected fit + 6 rounds")
    if launches["topk_fused"] or launches["gee_delta_renorm"]:
        raise AssertionError(f"train path: a serving kernel ran: {launches}")
    bad = [i for i, (l_, g_) in enumerate(zip(hist["losses"],
                                              hist["grad_norms"]))
           if not (np.isfinite(l_) and np.isfinite(g_))]
    if bad or len(hist["losses"]) != steps:
        raise AssertionError(f"train path: steps {bad} not finite")
    after = _fingerprints(torch, params)
    same_ = ["/".join(p_) for p_ in before
             if torch.equal(before[p_], after[p_])]
    if same_:
        raise AssertionError(f"train path: leaves unchanged: {same_}")
    step_ms = [1e3 * s_ for s_ in hist["step_s"]]
    steady = float(np.median(step_ms[1:])) if steps > 1 else step_ms[0]
    # one more step under the profiler: device busy time, idle share
    opt = AdamW(lr=3e-4, state_dtype=cfg.state_dtype,
                schedule=cosine_schedule(warmup=20, total=steps))
    step_fn = make_train_step(cfg, opt)
    batch = TR.build_batch_fn(cfg, targs, dev)(steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, _, _ = step_fn(params, hist["opt_state"], batch)
        torch.cuda.synchronize()
    busy, n_dev, top = kernel_times(prof)
    idle = 1 - busy / steady
    # the leaves with the largest gradients, at the trained params, and
    # one AdamW update with them, timed alone
    loss, _ = M.forward_train(cfg, params, batch)
    paths_, leaves_ = zip(*items(params))
    g_ = torch.autograd.grad(loss, leaves_)
    norms = sorted(((x.float().norm().item(), "/".join(p_))
                    for p_, x in zip(paths_, g_)), reverse=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.update(build(zip(paths_, g_)), hist["opt_state"], params)
    torch.cuda.synchronize()
    adamw_ms = (time.perf_counter() - t0) * 1e3
    del loss, g_, leaves_
    print(f"train path: yi-6b width, {cfg.n_layers} of 32 layers (depth "
          f"CUT: float32 params + AdamW state at 16 B a parameter; wq, wk "
          f"at 1/sqrt(d_model); the gradient norm at the reference's "
          f"init, step 1: {ref_norm:.3e}), "
          f"{cfg.param_count():,} params, remat {cfg.remat}, compute "
          f"{cfg.compute_dtype}; B={B} S={S}, {steps} steps with "
          f"--gee-embed-init, lr 3e-4, cosine schedule; init {t_init:.2f} "
          f"s, set-up in run {run_s - sum(hist['step_s']):.2f} s")
    print(f"train path: step ms {[round(x, 1) for x in step_ms]}; steady "
          f"{steady:.1f} ms, {B * S / steady * 1e3:,.0f} tokens/s; losses "
          f"{[round(x, 4) for x in hist['losses']]}; grad norms "
          f"{[round(x, 3) for x in hist['grad_norms']]}; peak "
          f"{peak_gib:.2f} GiB; launches {launches}; card {smi}")
    print("train path: largest gradient norms after the run: " + ", ".join(
        f"{n_} {v_:.3e}" for v_, n_ in norms[:4])
        + f"; one AdamW update alone {adamw_ms:.1f} ms")
    print(f"profile train step: device busy {busy:.1f} ms in {n_dev} "
          f"kernels and copies, device idle share {idle:.3f}; by kernel: "
          + "; ".join(f"{n_[:60]} {ms_:.1f} ms x{c_}"
                      for n_, (ms_, c_) in top[:14]))
    flash_add["train_launches"] = launches["flash_attention"]
    scatter_add["train_launches"] = launches["gee_scatter"]
    del params, hist, prof, before, after, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8e. every family's reduced config: card vs CPU, two steps ------
    by_arch = {}
    worst = (0.0, "")
    for arch in list_archs():
        cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
        src = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=64,
                                         global_batch=2, seed=args.seed))
        rs = np.random.default_rng(args.seed)
        frames = (rs.normal(size=(2, cfg.n_frames, cfg.d_model)).astype(
            np.float32) if cfg.is_encdec else None)
        opt = AdamW(lr=1e-3)
        losses = {}
        for side in ("cpu", "cuda"):
            p_ = M.init_params(cfg, args.seed, device="cpu").to(side)
            temper_attention(torch, p_)
            p_.requires_grad_(True)
            st = opt.init(p_)
            fn = make_train_step(cfg, opt)
            _build.reset_launches()
            losses[side] = []
            for s_ in range(2):
                b_ = {"tokens": torch.as_tensor(src.batch(s_), device=side)}
                if frames is not None:
                    b_["frames"] = torch.as_tensor(frames, device=side)
                p_, st, m_ = fn(p_, st, b_)
                losses[side].append(m_["loss"].item())
            del p_, st
        n_ = _build.launches["flash_attention"]
        want = 2 * 2 * expected_flash(cfg, 64)
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        worst = max(worst, (gap, arch))
        by_arch[arch] = n_
        if n_ != want or not gap <= FAM_TRAIN_TOL:
            raise AssertionError(f"{arch} reduced train steps: card "
                                 f"{losses['cuda']} vs cpu {losses['cpu']}"
                                 f", flash {n_} (expected {want})")
    print(f"reduced families, 2 train steps with remat, card vs CPU from "
          f"the same weights (wq, wk at 1/sqrt(d_model)): worst loss gap {worst[0]:.3e} ({worst[1]}; "
          f"tol {FAM_TRAIN_TOL}); flash launches {by_arch}")
    flash_add["train_launches_by_arch"] = by_arch
    return flash_add, scatter_add


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--n", type=int, default=4_847_571)
    ap.add_argument("--s", type=int, default=68_993_773)
    ap.add_argument("--lm-batch", type=int, default=4)
    ap.add_argument("--lm-prompt", type=int, default=2048)
    ap.add_argument("--lm-gen", type=int, default=16)
    ap.add_argument("--lm-layers", type=int, default=32,
                    help="cut yi-6b's depth (32) only if the time limit "
                         "forces it")
    ap.add_argument("--fam-layers", type=int, default=None,
                    help="cut every family's depth to at most this many "
                         "layers (a short check run; default: FAMILIES)")
    ap.add_argument("--train-layers", type=int, default=12,
                    help="yi-6b layers in phase 8's training run (12 of "
                         "32: what float32 AdamW training holds on 80 GB)")
    ap.add_argument("--train-steps", type=int, default=8)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch not found beside this script; run it from "
             "the repository root")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    # the persistent plan cache is off unless a phase names its own
    # directory (the default one lives under HOME)
    os.environ["REPRO_PLAN_CACHE"] = "off"
    # plain versions that use matrix products stay in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.gee import edge_contributions
    from repro_torch.core.ref_python import gee_numpy
    from repro_torch.encoder import Embedder, EncoderConfig
    from repro_torch.encoder.plan import owned_contributions
    from repro_torch.configs import get_config
    from repro_torch.core.gee import make_w
    from repro_torch.graph import Graph, RowPartition, make_labels, sbm
    from repro_torch.graph.generators import powerlaw
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gee_scatter as GS
    from repro_torch.kernels import query_fused as QF
    from repro_torch.kernels.ops import pack_edges
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.serving import EmbeddingShard
    from repro_torch.serving import queries as Q

    dev = torch.device("cuda")
    timer = Timer(torch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    names = _build.build_all()
    print(f"built {names} in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.ptxas_log.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                print(f"ptxas[{name}]: {line.strip()}")
    if "flash_attention" in _build.ptxas_log:     # built in this run
        bf16 = {f: n for f, n in ptxas_spills(
            _build.ptxas_log["flash_attention"]).items()
            if "flash_fwd_bf16_kernel" in f}
        if len(bf16) != 4 or any(bf16.values()):
            raise AssertionError(f"ptxas spill bytes of the bfloat16 flash "
                                 f"bodies (one per D expected, all 0): "
                                 f"{bf16}")
        print("ptxas: the 4 bfloat16 flash bodies spill 0 bytes")
    hgmma = count_hgmma(_build.library_path("flash_attention"))
    if hgmma is None:
        print("cuobjdump not found: HGMMA count of the flash library not "
              "checked")
    else:
        print(f"flash library SASS: {hgmma} HGMMA instructions")
        if hgmma == 0:
            raise AssertionError("the flash library has no HGMMA (wgmma) "
                                 "instruction")

    # -- 2. small shapes: each kernel against its plain version -----------
    rng = np.random.default_rng(args.seed)

    def check_scatter(row_ptr, cls, val, T, tile_n, kdim, what,
                      serial=False):
        """Kernel twice (the same bits), against the plain version at rtol
        1e-5 / atol 1e-6; with `serial`, also bit-equal to a float32 sum
        in packed order on the host (the kernel's order of additions)."""
        kw = dict(num_tiles=T, tile_n=tile_n, kdim=kdim)
        Z1 = GS.gee_scatter(row_ptr, cls, val, **kw)
        Z2 = GS.gee_scatter(row_ptr, cls, val, **kw)
        Zp = GS.gee_scatter_plain(row_ptr, cls, val, **kw)
        torch.cuda.synchronize()
        if not same(Z1, Z2):
            raise AssertionError(f"gee_scatter {what}: runs differ")
        err = (Z1 - Zp).abs().max().item() if Z1.numel() else 0.0
        if not torch.allclose(Z1, Zp, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"gee_scatter {what}: max|err| {err}")
        if serial:
            rp = row_ptr.cpu().numpy()
            Zs = np.zeros((rp.shape[0] - 1, kdim), np.float32)
            np.add.at(Zs, (np.repeat(np.arange(rp.shape[0] - 1),
                                     np.diff(rp)), cls.cpu().numpy()),
                      val.cpu().numpy())
            if not np.array_equal(Z1.cpu().numpy(), Zs):
                raise AssertionError(f"gee_scatter {what}: not the serial "
                                     "sum's bits")
        return err

    def check_topk(Zr, q, qn, k, off, excl, norm, what):
        kw = dict(k=k, row_offset=off, exclude_self=excl, normalize=norm)
        a = QF.topk_fused(Zr, q, qn, **kw)
        b = QF.topk_fused(Zr, q, qn, **kw)
        p = QF.topk_fused_plain(Zr, q, qn, **kw)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            if not same(x, y):
                raise AssertionError(f"topk_fused {what}: runs differ")
        for x, y in zip(a, p):          # exact: same arithmetic, same ties
            if not same(x, y):
                raise AssertionError(f"topk_fused {what}: differs from "
                                     "its plain version")
        fin = torch.isfinite(a[0])
        return (a[0][fin] - p[0][fin]).abs().max().item() if fin.any() \
            else 0.0

    def check_delta(Z, rows, cls, val, what):
        a = QF.gee_delta_renorm(Z, rows, cls, val)
        b = QF.gee_delta_renorm(Z, rows, cls, val)
        p = QF.gee_delta_renorm_plain(Z, rows, cls, val)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            if not same(x, y):
                raise AssertionError(f"gee_delta_renorm {what}: runs "
                                     "differ")
        if not torch.allclose(a[0], p[0], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"gee_delta_renorm {what}: Z_new off")
        if not torch.allclose(a[1], p[1], rtol=0, atol=1e-6):
            raise AssertionError(f"gee_delta_renorm {what}: Zn off")
        # the kernel's Zn is exactly normalize_rows of its own Z_new
        if not same(a[1], QF.normalize_rows(a[0])):
            raise AssertionError(f"gee_delta_renorm {what}: Zn is not "
                                 "normalize_rows(Z_new) bit for bit")
        return max((a[0] - p[0]).abs().max().item(),
                   (a[1] - p[1]).abs().max().item()) if Z.numel() else 0.0

    def check_flash(q, k, v, what):
        """Kernel vs plain at the JAX suite's tolerance: 2e-5 at float32,
        2e-2 at bfloat16 (atol and rtol, `tests/test_kernels.py`)."""
        a = FA.flash_attention(q, k, v)
        b = FA.flash_attention(q, k, v)
        p = FA.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        if not same(a, b):
            raise AssertionError(f"flash_attention {what}: runs differ")
        if a.dtype != q.dtype:
            raise AssertionError(f"flash_attention {what}: dtype {a.dtype}")
        tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
        err = (a.float() - p.float()).abs().max().item()
        if not torch.allclose(a.float(), p.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention {what}: max|err| {err}")
        return err

    # scatter: skewed rows, one tile, tail tile, K = 256 (row sub-ranges),
    # one row holding 50,000 contributions; last, every donor labelled and
    # 90 % of each row's in one class (large groups, as in a refine round)
    for n_s, s_s, K_s, tile_n, giant, homophilous in (
            (300, 3000, 5, 64, 0, False), (50, 900, 8, 64, 0, False),
            (1000, 20000, 16, 256, 0, False),
            (3000, 20000, 256, 256, 0, False),
            (2000, 5000, 16, 256, 50_000, False),
            (3000, 100_000, 16, 256, 0, True)):
        dst = rng.permutation(np.concatenate([rng.zipf(1.5, 2 * s_s) % n_s,
                                              np.full(giant, n_s // 3)]))
        m_s = dst.shape[0]
        cls = rng.integers(0, K_s, m_s)
        val = rng.random(m_s, dtype=np.float32)
        if homophilous:
            cls = np.where(rng.random(m_s) < 0.9, dst % K_s, cls)
            val += np.float32(1e-3)
        else:
            val[rng.random(m_s) < 0.5] = 0
        dst = torch.as_tensor(dst.astype(np.int64), device=dev)
        cls = torch.as_tensor(cls, device=dev)
        row_ptr, clsb, valb, T = pack_edges(
            dst, cls, torch.as_tensor(val, device=dev), n_s, tile_n)
        check_scatter(row_ptr, clsb, valb, T, tile_n, K_s,
                      f"small n={n_s} K={K_s} giant={giant} "
                      f"homophilous={homophilous}", serial=True)
    # an Embedder on the card against the host oracle
    g_small, _ = sbm(2000, 6, 30000, seed=args.seed + 1)
    Y_small = make_labels(2000, 6, 0.3, np.random.default_rng(args.seed))
    Z_small = Embedder(EncoderConfig(K=6, tile_n=64),
                       backend="cuda").fit(g_small, Y_small).transform()
    ref_small = gee_numpy(g_small.u, g_small.v, g_small.w, Y_small, 6, 2000)
    if not np.allclose(Z_small, ref_small, atol=1e-5):
        raise AssertionError("cuda Embedder off the numpy oracle")
    # top-k: duplicate-heavy rows (ties everywhere), slices, k > m
    base = rng.normal(size=(40, 6)).astype(np.float32)
    Zd = torch.as_tensor(np.repeat(base, 4, axis=0), device=dev)
    Znd = QF.normalize_rows(Zd)
    qn = torch.as_tensor(rng.integers(0, 160, 12).astype(np.int32),
                         device=dev)
    qd = Znd[qn.long()].contiguous()
    for p in (1, 2, 4):
        bounds = np.linspace(0, 160, p + 1).astype(int)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            for norm in (False, True):
                src = (Zd if norm else Znd)[lo:hi].contiguous()
                check_topk(src, qd, qn, 9, int(lo), True, norm,
                           f"ties p={p} [{lo},{hi}) norm={norm}")
    check_topk(Znd, qd, qn, 9, 0, False, False, "exclude_self off")
    check_topk(Znd[:3].contiguous(), qd, qn, 8, 0, True, False, "k > m")
    # K = 16 (the register body): runs of 7 equal rows, so exact ties
    # straddle the 1,024-row tiles and the blocks' tile ranges
    base16 = rng.normal(size=(600_000 // 7 + 1, 16)).astype(np.float32)
    Zt = torch.as_tensor(np.repeat(base16, 7, axis=0)[:600_000], device=dev)
    qn16 = torch.as_tensor(np.concatenate([
        np.arange(1020, 1030), rng.integers(0, 600_000, 54)]).astype(
            np.int32), device=dev)
    qt = QF.normalize_rows(Zt)[qn16.long()].contiguous()
    for norm in (False, True):
        src = Zt if norm else QF.normalize_rows(Zt)
        check_topk(src, qt, qn16 + 5000, 10, 5000, True, norm,
                   f"K=16 ties across tiles norm={norm}")
    # delta: insert and delete
    Zs = torch.as_tensor(rng.random((300, 7), dtype=np.float32), device=dev)
    r = np.sort(rng.integers(0, 300, 500)).astype(np.int32)
    c = rng.integers(0, 7, 500).astype(np.int32)
    v = rng.random(500, dtype=np.float32)
    for sign in (1.0, -1.0):
        check_delta(Zs, torch.as_tensor(r, device=dev),
                    torch.as_tensor(c, device=dev),
                    torch.as_tensor(sign * v, device=dev),
                    f"small sign={sign}")
    # the widths outside the main path's bodies: the delta kernel's rows
    # in device memory (K > 128), top-k's general path (K > 256, k > 64)
    Zw = torch.as_tensor(rng.random((700, 200), dtype=np.float32),
                         device=dev)
    rw = np.sort(rng.integers(0, 700, 600)).astype(np.int32)
    check_delta(Zw, torch.as_tensor(rw, device=dev),
                torch.as_tensor(rng.integers(0, 4, 600).astype(np.int32),
                                device=dev),
                torch.as_tensor(rng.random(600, dtype=np.float32),
                                device=dev), "K=200")
    for Kw, mw, kw_ in ((300, 5000, 10), (16, 20000, 100), (300, 40, 100)):
        Zw = torch.as_tensor(np.repeat(rng.normal(size=(mw // 2, Kw)).astype(
            np.float32), 2, axis=0), device=dev)
        qnw = torch.as_tensor(rng.integers(0, mw, 64).astype(np.int32),
                              device=dev)
        qw = QF.normalize_rows(Zw)[qnw.long()].contiguous()
        for norm in (False, True):
            src = Zw if norm else QF.normalize_rows(Zw)
            check_topk(src, qw, qnw, kw_, 0, True, norm,
                       f"K={Kw} m={mw} k={kw_} norm={norm}")
    # flash attention: the JAX suite's cases, ragged S, D = 128; bfloat16
    # only: yi's heads one row past a 128-row tile, and the prefill's shape
    # with a ragged last tile
    lm = get_config("yi-6b")
    flash_cases = [(c_, dt) for c_ in (
        (1, 2, 2, 64, 16), (2, 4, 2, 128, 32), (1, 8, 1, 128, 16),
        (2, 4, 2, 100, 64), (1, 4, 4, 1, 32), (1, 8, 2, 200, 128),
        (1, 32, 4, 130, 128), (1, 8, 2, 200, 96),
        # the wide body (D > 128): ragged S and a ragged last D chunk
        (1, 4, 2, 100, 160), (2, 8, 2, 130, 256))
        for dt in (torch.float32, torch.bfloat16)]
    flash_cases += [((1, lm.n_heads, lm.n_kv_heads, 2049, lm.head_dim),
                     torch.bfloat16),
                    ((args.lm_batch, lm.n_heads, lm.n_kv_heads,
                      args.lm_prompt - 1, lm.head_dim), torch.bfloat16)]
    for (B_, H_, KV_, S_, D_), dt in flash_cases:
        qkv = [torch.as_tensor(rng.normal(size=(B_, h_, S_, D_)).astype(
            np.float32), device=dev).to(dt) for h_ in (H_, KV_, KV_)]
        check_flash(*qkv, f"B={B_} H={H_} KV={KV_} S={S_} D={D_} {dt}")
        del qkv
    print(f"small-shape kernel checks: ok ({len(flash_cases)} flash cases)")

    def gee_path():
        """Phases 3-5 (GEE); returns the three kernels' rows.  Its
        tensors are freed when it returns."""
        # -- 3. main path at LiveJournal scale ---------------------------------
        n, s, K, k, nq = args.n, args.s, 16, 10, 64
        t0 = time.perf_counter()
        g, truth = sbm(n, K, s, seed=args.seed)
        Y = make_labels(n, K, 0.10, np.random.default_rng(args.seed + 1),
                        true_labels=truth)
        t_data = time.perf_counter() - t0
        part = RowPartition(n, 2)
        step_rng = np.random.default_rng(args.seed + 2)
        deltas = [Graph(step_rng.integers(0, n, 200).astype(np.int32),
                        step_rng.integers(0, n, 200).astype(np.int32),
                        np.ones(200, np.float32), n) for _ in range(args.steps)]
        queries = [step_rng.integers(0, n, nq).astype(np.int32)
                   for _ in range(args.steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        _build.reset_launches()
        t0 = time.perf_counter()
        emb = Embedder(EncoderConfig(K=K), backend="cuda").fit(g, Y)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        shards = [EmbeddingShard(i, lo, hi, K=K, n=n, backend="cuda")
                  for i, (lo, hi) in enumerate(part.slices())]
        for sh in shards:
            sh.build(g, Y)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        answers, step_ms = [], []
        for d, nodes in zip(deltas, queries):
            t0 = time.perf_counter()
            for i, sub in part.route_graph(d):
                shards[i].apply_delta(sub)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = torch.empty((nq, K), dtype=torch.float32, device=dev)
            for i, idx in part.route_nodes(nodes):
                rows[torch.as_tensor(idx, device=dev)] = shards[i].rows(
                    nodes[idx])
            q = Q.normalize_rows(rows)
            parts = [sh.topk_candidates(q, nodes, k=k) for sh in shards]
            merged = Q.merge_topk([p_[0] for p_ in parts],
                                  [p_[1] for p_ in parts], k=k)
            t2 = time.perf_counter()
            answers.append((q, nodes, merged))
            step_ms.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"main path: data {t_data:.1f} s, fit {t_fit:.2f} s, shard "
              f"builds {t_build:.2f} s, peak device memory {peak_gib:.2f} GiB")
        print("steps (delta ms, top-k ms): "
              + ", ".join(f"({a:.2f}, {b:.2f})" for a, b in step_ms))
        print(f"launches on the main path: {launches}")
        for name in ("gee_scatter", "topk_fused", "gee_delta_renorm"):
            if launches[name] == 0:
                raise AssertionError(f"kernel {name} was never launched on "
                                     "the GEE path")
        Z_fit = emb.Z_
        if tuple(Z_fit.shape) != (n, K) or not bool(torch.isfinite(Z_fit).all()):
            raise AssertionError("fitted Z has the wrong shape or non-finite "
                                 "values")

        # -- 5. self-checks ----------------------------------------------------
        # (1) the shards' Z equals a fresh fit on the updated graph
        upd = Graph(np.concatenate([g.u] + [d.u for d in deltas]),
                    np.concatenate([g.v] + [d.v for d in deltas]),
                    np.concatenate([g.w] + [d.w for d in deltas]), n)
        rebuild = Embedder(EncoderConfig(K=K), backend="torch").fit(upd, Y).Z_
        z_err = 0.0
        for sh in shards:
            ref = rebuild[sh.lo:sh.hi]
            z_err = max(z_err, (sh.Z_owned - ref).abs().max().item())
            if not torch.allclose(sh.Z_owned, ref, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"shard {sh.shard_id}: max|Z_delta - "
                                     f"Z_rebuild| = {z_err}")
        del rebuild
        print(f"self-check 1: max|Z_delta - Z_rebuild| = {z_err:.3e} "
              "(rtol 1e-5, atol 1e-6)")
        # (2) fused answers equal the plain scan's on the same Zn (the last
        # step's Zn: earlier steps' Zn were replaced by later deltas)
        q, nodes, merged = answers[-1]
        plain = [Q.topk_cosine_q(sh._Zn, q, nodes, k=k, row_offset=sh.lo)
                 for sh in shards]
        pm = Q.merge_topk([p_[0] for p_ in plain], [p_[1] for p_ in plain],
                          k=k)
        topk_equivalent(merged[0], merged[1], pm[0], pm[1])
        bit_equal = bool(np.array_equal(merged[0], pm[0])
                         and np.array_equal(merged[1], pm[1]))
        if not bit_equal:
            raise AssertionError("fused and plain top-k differ in bits")
        if not np.isfinite(merged[1]).all() or merged[0].min() < 0:
            raise AssertionError("top-k answer holds unfilled slots")
        print(f"self-check 2: fused top-k == plain scan on the same Zn "
              f"(topk_equivalent, bit-equal={bit_equal})")

        # -- 4. kernels at the main path's shapes ------------------------------
        results = []
        # gee_scatter: the full fit's packed buffers
        plan, be, cfg = emb._plan, emb.backend, emb.config
        T, row_ptr = plan.data["T"], plan.data["row_ptr"]
        kw = dict(num_tiles=T, tile_n=cfg.tile_n, kdim=K)
        cls, val = be.resolve(plan, emb._Yj, emb.Wv_)
        err = check_scatter(row_ptr, cls, val, T, cfg.tile_n, K, "real")
        # every node labelled, as in a refine round (Y = the SBM's truth)
        Y_all = torch.as_tensor(truth, device=dev)
        cls_a, val_a = be.resolve(plan, Y_all, make_w(Y_all, K))
        check_scatter(row_ptr, cls_a, val_a, T, cfg.tile_n, K,
                      "all labelled")
        ms_all = timer(lambda: GS.gee_scatter(row_ptr, cls_a, val_a, **kw),
                       20)
        b_all = bound_ms(8 * cls_a.numel() + 8 * row_ptr.numel()
                         + T * cfg.tile_n * K * 4,
                         int((val_a != 0).sum().item()))[0]
        del cls_a, val_a

        u_t = torch.as_tensor(g.u, device=dev)
        v_t = torch.as_tensor(g.v, device=dev)
        w_t = torch.as_tensor(g.w, device=dev)

        def scatter_lib(dst_, cls_, val_):
            return lambda: torch.zeros((n, K), device=dev).index_put_(
                (dst_, cls_), val_, accumulate=True)

        lib_all = timer(scatter_lib(*edge_contributions(
            u_t, v_t, w_t, Y_all, make_w(Y_all, K))), 3)
        dst_l, cls_l, val_l = edge_contributions(u_t, v_t, w_t, emb._Yj,
                                                 emb.Wv_)
        del u_t, v_t, w_t
        run_scatter_lib = scatter_lib(dst_l, cls_l, val_l)

        S = cls.numel()
        nnz = int((val != 0).sum().item())
        z_bytes = T * cfg.tile_n * K * 4
        # class + value per contribution, one offset per row, Z once; the
        # padded layout's count also read a 4-byte row per contribution
        b, by = bound_ms(8 * S + 8 * row_ptr.numel() + z_bytes, nnz)
        b12 = bound_ms(12 * S + 4 * T + z_bytes, nnz)[0]
        ms = timer(lambda: GS.gee_scatter(row_ptr, cls, val, **kw), 20)
        results.append(dict(
            name="gee_scatter", route="cuda",
            source="src/repro_torch/kernels/csrc/gee_scatter.cu",
            replaces="src/repro/kernels/gee_scatter.py:84",
            launches=launches["gee_scatter"], max_abs_err=err, ms=ms,
            plain_ms=timer(lambda: GS.gee_scatter_plain(row_ptr, cls, val,
                                                        **kw), 3),
            bound_ms=b, bound_by=by, library_ms=timer(run_scatter_lib, 3),
            bound_share=b / ms, bound_share_12b=b12 / ms,
            ms_all_labelled=ms_all, all_labelled_bound_ms=b_all,
            all_labelled_library_ms=lib_all,
            embed_ms=timer(lambda: be.embed(plan, emb._Yj, emb.Wv_), 10),
            shape=f"T={T} S={S} nonzero={nnz} K={K}"))
        del cls, val, dst_l, cls_l, val_l

        # topk_fused: shard 0's cached Zn, the last step's queries
        sh = shards[0]
        Zn0 = sh._Zn
        qn = torch.as_tensor(nodes, device=dev)
        qc = q.contiguous()
        err = check_topk(Zn0, qc, qn, k, sh.lo, True, False, "real")
        check_topk(sh.Z_owned, qc, qn, k, sh.lo, True, True, "real normalize")
        m = Zn0.shape[0]
        b, by = bound_ms(m * K * 4 + nq * K * 4 + nq * 4 + nq * k * 8,
                         2.0 * nq * m * K)

        def run_select():
            return QF._topk_select(Zn0, qc, qn, None, k=k, row_offset=sh.lo,
                                   exclude_self=True, eps=QF.EPS)

        cand = run_select()
        ms = timer(lambda: QF.topk_fused(Zn0, qc, qn, k=k, row_offset=sh.lo),
                   20, queue_ahead=True)
        results.append(dict(
            name="topk_fused", route="cuda",
            source="src/repro_torch/kernels/csrc/query_fused.cu",
            replaces="src/repro/kernels/query_fused.py:88",
            launches=launches["topk_fused"], max_abs_err=err, ms=ms,
            plain_ms=timer(lambda: QF.topk_fused_plain(Zn0, qc, qn, k=k,
                                                       row_offset=sh.lo), 2),
            bound_ms=b, bound_by=by,
            library_ms=timer(lambda: torch.topk(qc @ Zn0.T, k, dim=1), 3),
            # each pass on its own, through the launchers the wrapper calls
            select_ms=timer(run_select, 20, queue_ahead=True),
            merge_ms=timer(lambda: QF._topk_merge(*cand, k=k), 20,
                           queue_ahead=True),
            bound_share=b / ms,
            # one FMUL and one FADD per term (no FFMA: common.cuh)
            issue_floor_ms=2.0 * nq * m * K / FP32_INSTR * 1e3,
            shape=f"m={m} nq={nq} k={k} K={K} select grid "
                  f"{cand[0].shape[1]} blocks"))
        del cand
        # the general path at one wide shape each: k = 100 on shard 0's
        # rows, and K = 300 on 262,144 random unit rows (k = 10)
        wide = {}
        check_topk(Zn0, qc, qn, 100, sh.lo, True, False, "real k=100")
        wide["wide_k100_ms"] = timer(lambda: QF.topk_fused(
            Zn0, qc, qn, k=100, row_offset=sh.lo), 5)
        wide["wide_k100_bound_ms"] = bound_ms(
            m * K * 4 + nq * K * 4 + nq * 4 + nq * 100 * 8,
            2.0 * nq * m * K)[0]
        wide["wide_k100_library_ms"] = timer(
            lambda: torch.topk(qc @ Zn0.T, 100, dim=1), 3)
        gen_ = torch.Generator(device=dev).manual_seed(args.seed)
        Zw = QF.normalize_rows(torch.randn((1 << 18, 300), generator=gen_,
                                           device=dev))
        qnw = torch.arange(0, 1 << 18, 4096, dtype=torch.int32, device=dev)
        qw = Zw[qnw.long()].contiguous()
        check_topk(Zw, qw, qnw, k, 0, True, False, "K=300 m=262144")
        wide["wide_K300_ms"] = timer(lambda: QF.topk_fused(Zw, qw, qnw, k=k),
                                     5)
        wide["wide_K300_bound_ms"] = bound_ms(
            Zw.numel() * 4 + qw.numel() * 4 + nq * 4 + nq * k * 8,
            2.0 * nq * Zw.numel())[0]
        wide["wide_K300_library_ms"] = timer(
            lambda: torch.topk(qw @ Zw.T, k, dim=1), 3)
        results[-1].update(wide)
        del Zw, qw

        # gee_delta_renorm: shard 0's Z and a fresh 200-edge delta
        d = Graph(step_rng.integers(0, n, 200).astype(np.int32),
                  step_rng.integers(0, n, 200).astype(np.int32),
                  np.ones(200, np.float32), n)
        rows, src, w = owned_contributions(d, d.w, sh.lo, sh.hi)
        Ysrc = sh.embedder.labels_[src]
        clsv = np.maximum(Ysrc, 0).astype(np.int32)
        valv = np.where(Ysrc >= 0, sh.embedder._Wv_host[src] * w,
                        np.float32(0)).astype(np.float32)
        order = np.argsort(rows, kind="stable")
        r_t = torch.as_tensor(rows[order], device=dev)
        c_t = torch.as_tensor(clsv[order], device=dev)
        v_t = torch.as_tensor(valv[order], device=dev)
        Z0 = sh.Z_owned
        err = check_delta(Z0, r_t, c_t, v_t, "real")

        def run_delta_lib():
            Zx = Z0.clone().index_put_((r_t.long(), c_t.long()), v_t,
                                       accumulate=True)
            torch.nn.functional.normalize(Zx, dim=1, eps=1e-9)

        nl = Z0.shape[0]
        b, by = bound_ms(3 * nl * K * 4 + r_t.shape[0] * 12, r_t.shape[0])
        results.append(dict(
            name="gee_delta_renorm", route="cuda",
            source="src/repro_torch/kernels/csrc/query_fused.cu",
            replaces="src/repro/kernels/query_fused.py:166",
            launches=launches["gee_delta_renorm"], max_abs_err=err,
            ms=timer(lambda: QF.gee_delta_renorm(Z0, r_t, c_t, v_t), 10),
            plain_ms=timer(lambda: QF.gee_delta_renorm_plain(Z0, r_t, c_t,
                                                             v_t), 3),
            bound_ms=b, bound_by=by, library_ms=timer(run_delta_lib, 3),
            shape=f"n_local={nl} m={r_t.shape[0]} K={K}"))
        # the rows-in-device-memory body at K = 200 on 262,144 rows, with
        # the same delta's contributions
        Zw = torch.rand((1 << 18, 200), generator=gen_, device=dev)
        keep = r_t < Zw.shape[0]
        rw_, cw_, vw_ = r_t[keep], c_t[keep] % 200, v_t[keep]
        check_delta(Zw, rw_, cw_, vw_, "K=200 n_local=262144")

        def run_delta_lib_wide():
            Zx = Zw.clone().index_put_((rw_.long(), cw_.long()), vw_,
                                       accumulate=True)
            torch.nn.functional.normalize(Zx, dim=1, eps=1e-9)

        results[-1].update(
            wide_K200_library_ms=timer(run_delta_lib_wide, 3),
            wide_K200_ms=timer(lambda: QF.gee_delta_renorm(Zw, rw_, cw_, vw_),
                               10),
            wide_K200_bound_ms=bound_ms(3 * Zw.numel() * 4
                                        + rw_.shape[0] * 12,
                                        rw_.shape[0])[0])
        del Zw
        return results, (g, truth, Y)

    def plan_cache_path(g, Y):
        """Phase 5': the persistent plan cache and refinement on the main
        graph.  Its tensors and its cache directory are gone when it
        returns; returns its times for the summary."""
        import tempfile
        from repro_torch.encoder.plan_cache import PlanDiskCache

        K = 16
        store_s = []

        class TimedCache(PlanDiskCache):
            def store(self, meta, host):
                t0 = time.perf_counter()
                ok = super().store(meta, host)
                store_s.append(time.perf_counter() - t0)
                return ok

        with tempfile.TemporaryDirectory(prefix="plans-") as tmp:
            cache = TimedCache(tmp)
            _build.reset_launches()
            fits = []
            for _ in range(2):               # a miss, then a disk hit
                t0 = time.perf_counter()
                e = Embedder(EncoderConfig(K=K), backend="cuda",
                             plan_cache=cache).fit(g, Y)
                torch.cuda.synchronize()
                fits.append((time.perf_counter() - t0, e))
            launches = dict(_build.launches)
            (t_miss, miss), (t_hit, hit) = fits
            [entry] = cache.entries()
            entry_bytes = entry.stat().st_size
            print(f"plan cache: miss fit {t_miss:.2f} s (store "
                  f"{store_s[0]:.2f} s, entry {entry_bytes / 2**30:.3f} GiB "
                  f"on disk), hit fit {t_hit:.2f} s; stats "
                  f"{miss.plan_stats} / {hit.plan_stats}; Z bit-equal "
                  f"{same(miss.Z_, hit.Z_)}; launches {launches}")
            if (miss.plan_stats["disk_stores"] != 1
                    or hit.plan_stats != {"built": 0, "hits": 0,
                                          "disk_hits": 1, "disk_stores": 0}):
                raise AssertionError("plan cache: expected one store, then "
                                     "one disk hit")
            if not same(miss.Z_, hit.Z_):
                raise AssertionError("plan cache: the hit's Z differs from "
                                     "the miss's")
            if launches["gee_scatter"] != 2:
                raise AssertionError("plan cache: gee_scatter not launched "
                                     "once per fit")
            del miss, fits
            # refinement on the hit's plan: one embed per round + a last
            iters = hit.config.refine_iters
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            hit.refine(seed=args.seed)
            torch.cuda.synchronize()
            t_refine = time.perf_counter() - t0
            r_launches = dict(_build.launches)
            labels = hit.labels_
            print(f"refine: {iters} rounds in {t_refine:.3f} s "
                  f"({t_refine / iters * 1e3:.1f} ms per round); launches "
                  f"{r_launches}; labels changed "
                  f"{int((labels != Y).sum()):,} of {g.n:,}")
            if r_launches["gee_scatter"] != iters + 1:
                raise AssertionError(f"refine launched gee_scatter "
                                     f"{r_launches['gee_scatter']} times, "
                                     f"expected {iters + 1}")
            if (not np.array_equal(labels[Y >= 0], Y[Y >= 0])
                    or labels.min() < 0 or labels.max() >= K
                    or not bool(torch.isfinite(hit.Z_).all())):
                raise AssertionError("refine: supervised labels moved, or "
                                     "labels / Z out of range")
            del hit
        gc.collect()
        torch.cuda.empty_cache()
        return dict(miss_s=t_miss, store_s=store_s[0], hit_s=t_hit,
                    entry_bytes=entry_bytes, refine_s=t_refine)

    def engine_path(g, truth, Y):
        """Phase 5a: the durable serving engine at LiveJournal scale on
        the main path's graph; returns its phase times for the summary.
        Its tensors and its data directory are gone when it returns."""
        import tempfile
        from repro_torch import obs
        from repro_torch.serving import GraphStore, MicroBatcher, ServingEngine

        n, K, k, nq = g.n, 16, 10, 64
        times = {}

        class TimedStore(GraphStore):
            """The engine's store, timing its compactions and
            snapshots (the engine's own spans cover the rebuilds)."""

            def compact(self):
                busy = bool(self.edge_log) or not self._coalesced
                t0 = time.perf_counter()
                out = super().compact()
                if busy:          # not the snapshot's no-op compaction
                    times.setdefault("compact_s", []).append(
                        time.perf_counter() - t0)
                return out

            def snapshot(self, prefix):
                t0 = time.perf_counter()
                super().snapshot(prefix)
                times.setdefault("snapshot_s", []).append(
                    time.perf_counter() - t0)

        def rebuild_s():
            return obs.registry().hist_summary(
                "repro_serving_rebuild_seconds")["sum"]

        obs.configure(enabled=True)
        obs.reset()
        tick_rng = np.random.default_rng(args.seed + 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        with tempfile.TemporaryDirectory(prefix="engine-") as tmp:
            data_dir = str(Path(tmp) / "deployment")
            t0 = time.perf_counter()
            store = TimedStore(g, Y, K)
            t_store = time.perf_counter() - t0
            t0 = time.perf_counter()
            engine = ServingEngine(store, num_shards=2, backend="cuda",
                                   data_dir=data_dir, device="cuda")
            torch.cuda.synchronize()
            t_boot = time.perf_counter() - t0
            snap_bytes = sum(f.stat().st_size
                             for f in Path(data_dir).iterdir())
            print(f"engine build: store (hash of {g.s:,} edges) "
                  f"{t_store:.2f} s; generation 0 {t_boot:.2f} s = "
                  f"compaction {times['compact_s'][0]:.2f} s + shard "
                  f"builds {rebuild_s():.2f} s + snapshot "
                  f"{times['snapshot_s'][0]:.2f} s ({snap_bytes / 2**20:.0f}"
                  f" MiB on disk) + routing and shard fingerprints "
                  f"{t_boot - times['compact_s'][0] - rebuild_s() - times['snapshot_s'][0]:.2f} s")
            batcher = engine.start(MicroBatcher(engine, topk=k))
            inserted, tick_ms = [], []
            for tick in range(8):
                tickets = []
                for _ in range(8):
                    kind = str(tick_rng.choice(["embed", "predict", "topk"]))
                    tickets.append(batcher.submit(
                        kind, tick_rng.integers(0, n, nq)))
                u = tick_rng.integers(0, n, 200).astype(np.int32)
                v = tick_rng.integers(0, n, 200).astype(np.int32)
                w = tick_rng.random(200).astype(np.float32) + 0.5
                tickets.append(batcher.submit("insert", (u, v, w)))
                inserted.append((u, v, w))
                if tick >= 2:
                    tickets.append(batcher.submit("delete", inserted.pop(0)))
                if tick in (2, 5):
                    nodes = tick_rng.integers(0, n, n // 100 + 1)
                    tickets.append(batcher.submit("labels",
                                                  (nodes, truth[nodes])))
                for t_ in tickets:
                    t_.result(timeout=600)
                by_kind = {}
                for t_ in tickets:
                    by_kind.setdefault(t_.kind, []).append(t_.latency * 1e3)
                tick_ms.append({k_: max(v_) for k_, v_ in by_kind.items()})
                print(f"engine tick {tick}: version {engine.version} epoch "
                      f"{engine.epoch}; ticket latency ms (max per kind): "
                      + ", ".join(f"{k_} {v_:.2f}" for k_, v_ in
                                  sorted(tick_ms[-1].items())))
            engine.stop()
            if engine.loop_error is not None:
                raise AssertionError(f"engine flush loop failed: "
                                     f"{engine.loop_error!r}")
            for kind, row in batcher.stats().items():
                print(f"engine batcher {kind}: requests {row['requests']}, "
                      f"batches {row['batches']}, mean batch "
                      f"{row['mean_batch']:.1f}, mean latency "
                      f"{row['mean_latency_ms']:.2f} ms, "
                      f"{row['items_per_s']:,.0f} items/s")
            # the live Z (delta-maintained) against a fresh fit
            live = store.edges()
            fresh = Embedder(EncoderConfig(K=K), backend="torch").fit(
                live, engine.Y_epoch).Z_
            z_err = 0.0
            for sh in engine.shards:
                ref = fresh[sh.lo:sh.hi]
                z_err = max(z_err, (sh.Z_owned - ref).abs().max().item())
                if not torch.allclose(sh.Z_owned, ref, rtol=1e-5, atol=1e-6):
                    raise AssertionError(f"engine shard {sh.shard_id}: "
                                         f"max|Z_live - Z_fit| = {z_err}")
            del fresh, live
            print(f"engine self-check: max|Z_live - Z_fit(store.edges(), "
                  f"Y_epoch)| = {z_err:.3e} (rtol 1e-5, atol 1e-6)")
            ivf = ivf_phase(engine, tick_rng)
            r0 = rebuild_s()
            t0 = time.perf_counter()
            info = engine.checkpoint()
            torch.cuda.synchronize()
            t_ckpt = time.perf_counter() - t0
            print(f"engine checkpoint: {t_ckpt:.2f} s = compaction "
                  f"{times['compact_s'][-1]:.2f} s ({info['edges_before']:,}"
                  f" -> {info['edges_after']:,} edges) + shard builds "
                  f"{rebuild_s() - r0:.2f} s + snapshot "
                  f"{times['snapshot_s'][-1]:.2f} s; generation "
                  f"{info['generation']}")
            held = tick_rng.integers(0, n, nq).astype(np.int32)
            pre = engine.query_topk(held, k=k)
            pre_ivf = engine.query_topk(held, k=k, mode="ivf", nprobe=2)
            cells = [sh.index.cell_sizes() for sh in engine.shards]
            cent = engine._index_centroids.copy()
            triple = (engine.version, engine.epoch, engine.fingerprint())
            Z_live = [sh.Z_owned.clone() for sh in engine.shards]
            engine.close()
            del engine, store
            gc.collect()
            r0 = rebuild_s()
            t0 = time.perf_counter()
            rec = ServingEngine.open(data_dir, backend="cuda", device="cuda")
            torch.cuda.synchronize()
            t_open = time.perf_counter() - t0
            rtriple = (rec.version, rec.epoch, rec.fingerprint())
            dz = max((sh.Z_owned - z).abs().max().item()
                     for sh, z in zip(rec.shards, Z_live))
            post = rec.query_topk(held, k=k)
            post_ivf = rec.query_topk(held, k=k, mode="ivf", nprobe=2)
            launches = dict(_build.launches)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            print(f"engine reopen: {t_open:.2f} s (shard builds "
                  f"{rebuild_s() - r0:.2f} s); {rtriple[:2]} vs live "
                  f"{triple[:2]}, fingerprint equal "
                  f"{rtriple[2] == triple[2]}; max|dZ| = {dz:.3e}; held-back "
                  f"top-k bit-equal "
                  f"{np.array_equal(pre[0], post[0]) and np.array_equal(pre[1], post[1])}")
            print(f"launches in the engine phase: {launches}; peak device "
                  f"memory {peak_gib:.2f} GiB")
            if rtriple != triple:
                raise AssertionError(f"reopened engine {rtriple} != live "
                                     f"{triple}")
            for sh, z in zip(rec.shards, Z_live):
                if not torch.allclose(sh.Z_owned, z, rtol=1e-5, atol=1e-6):
                    raise AssertionError("reopened Z differs from the live "
                                         f"one: max|dZ| = {dz}")
            if not (np.array_equal(pre[0], post[0])
                    and np.array_equal(pre[1], post[1])):
                raise AssertionError("held-back top-k answers differ after "
                                     "the reopen")
            index_kept = (
                rec.index_mode == "ivf"
                and np.array_equal(rec._index_centroids, cent)
                and all(np.array_equal(c, sh.index.cell_sizes())
                        for c, sh in zip(cells, rec.shards))
                and np.array_equal(pre_ivf[0], post_ivf[0])
                and np.array_equal(pre_ivf[1], post_ivf[1]))
            print(f"engine reopen: index restored (same centroids, cell "
                  f"sizes and nprobe = 2 answers) {index_kept}")
            if not index_kept:
                raise AssertionError("the reopen did not restore the IVF "
                                     "index")
            if rec.loop_error is not None:
                raise AssertionError(f"loop_error: {rec.loop_error!r}")
            for name in ("gee_scatter", "gee_delta_renorm", "topk_fused"):
                if launches[name] == 0:
                    raise AssertionError(f"kernel {name} was never launched "
                                         "in the engine phase")
            rec.close()
            del rec, Z_live
            gc.collect()
            # two more reopens with the shards' plans in a persistent
            # cache: a miss that stores them, then a hit
            cache_dir = str(Path(tmp) / "plans")
            opens = []
            for _ in range(2):
                r0 = rebuild_s()
                t0 = time.perf_counter()
                rec = ServingEngine.open(data_dir, backend="cuda",
                                         device="cuda", plan_cache=cache_dir)
                torch.cuda.synchronize()
                t_ = time.perf_counter() - t0
                plan = rec.stats()["plan_stats"]
                Zs = [sh.Z_owned.clone() for sh in rec.shards]
                opens.append((t_, rebuild_s() - r0, plan, Zs))
                rec.close()
                del rec
                gc.collect()
            (t_miss, b_miss, p_miss, Z_miss), (t_hit, b_hit, p_hit,
                                               Z_hit) = opens
            cache_bytes = sum(f.stat().st_size
                              for f in Path(cache_dir).iterdir())
            print(f"engine reopen with the plan cache: miss {t_miss:.2f} s "
                  f"(shard builds {b_miss:.2f} s, {p_miss}), hit "
                  f"{t_hit:.2f} s (shard builds {b_hit:.2f} s, {p_hit}); "
                  f"{cache_bytes / 2**30:.3f} GiB on disk; Z bit-equal "
                  f"{all(same(a, b) for a, b in zip(Z_miss, Z_hit))}")
            if p_miss["disk_stores"] != 2 or p_hit["disk_hits"] != 2:
                raise AssertionError("engine reopen: expected 2 stores, then "
                                     "2 disk hits")
            if not all(same(a, b) for a, b in zip(Z_miss, Z_hit)):
                raise AssertionError("engine reopen: the cache hit's Z "
                                     "differs")
            del opens, Z_miss, Z_hit
        gc.collect()
        torch.cuda.empty_cache()
        return dict(tick_ms=tick_ms, checkpoint_s=t_ckpt, reopen_s=t_open,
                    peak_gib=peak_gib, ivf=ivf,
                    reopen_cache_s=(t_miss, t_hit))

    def ivf_phase(engine, tick_rng):
        """The IVF index on the engine at LiveJournal scale: build time,
        ivf at nprobe = K bit-equal to exact, recall@10 and read time at
        nprobe = 2 beside the exact read's, and index maintenance under
        200-edge deltas.  Leaves the index on."""
        from repro_torch import obs
        n, K, k, nq = engine.n, engine.store.K, 10, 64
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.enable_index()
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        cells = [sh.index.cell_sizes() for sh in engine.shards]
        print(f"ivf build: {t_build:.2f} s; rows per cell, shard 0: "
              f"{cells[0].tolist()}")
        reads = [tick_rng.integers(0, n, nq).astype(np.int32)
                 for _ in range(6)]
        exact = [engine.query_topk(r, k=k) for r in reads]
        full = [engine.query_topk(r, k=k, mode="ivf", nprobe=K)
                for r in reads]
        bit_equal = all(np.array_equal(a[0], b[0])
                        and np.array_equal(a[1], b[1])
                        for a, b in zip(exact, full))
        print(f"ivf nprobe = K = {K}: bit-equal to the exact read "
              f"{bit_equal}")
        if not bit_equal:
            raise AssertionError("ivf at nprobe = K differs from the exact "
                                 "read")
        probe2 = [engine.query_topk(r, k=k, mode="ivf", nprobe=2)
                  for r in reads]
        recall = float(np.mean([
            len(set(a.tolist()) & set(b.tolist())) / k
            for e, p in zip(exact, probe2) for a, b in zip(e[0], p[0])]))

        def read_ms(**kw):
            out = []
            for r in reads:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.query_topk(r, k=k, **kw)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return out

        ex_ms = read_ms()
        iv_ms = read_ms(mode="ivf", nprobe=2)
        scanned = obs.registry().counter_value(
            "repro_index_rows_scanned_total")
        queries = obs.registry().counter_value("repro_index_queries_total")
        print(f"ivf nprobe = 2: recall@10 {recall:.4f}; ms per {nq}-query "
              f"read (6 reads, cells cached after the first): ivf "
              + ", ".join(f"{x:.2f}" for x in iv_ms) + "; exact "
              + ", ".join(f"{x:.2f}" for x in ex_ms)
              + f"; rows scanned per query over the phase "
              f"{scanned / max(queries * nq, 1):,.0f} of {n:,}")
        upd = []
        for _ in range(3):
            u = tick_rng.integers(0, n, 200).astype(np.int32)
            v = tick_rng.integers(0, n, 200).astype(np.int32)
            moved0 = engine._index_moved
            h0 = obs.registry().hist_summary("repro_index_update_seconds")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.apply_edge_delta(u, v, np.ones(200, np.float32))
            torch.cuda.synchronize()
            t_ = time.perf_counter() - t0
            h1 = obs.registry().hist_summary("repro_index_update_seconds")
            upd.append(((h1["sum"] - h0["sum"]) * 1e3, t_ * 1e3,
                        engine._index_moved - moved0))
        print("ivf maintenance per 200-edge delta (update_index ms over "
              "both shards, whole delta ms, rows moved): "
              + ", ".join(f"({a:.2f}, {b:.2f}, {c})" for a, b, c in upd))
        after = [engine.query_topk(r, k=k) for r in reads[:2]]
        again = [engine.query_topk(r, k=k, mode="ivf", nprobe=K)
                 for r in reads[:2]]
        if not all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(after, again)):
            raise AssertionError("ivf at nprobe = K differs from exact "
                                 "after the deltas")
        return dict(build_s=t_build, recall=recall, ivf_ms=iv_ms,
                    exact_ms=ex_ms, update=upd)

    def skew_path():
        """Phase 5b: a graph with LiveJournal's degree spread on the cuda
        backend, held to the torch backend; returns the scatter kernel's
        time and share of its bound there.  Its tensors are freed when it
        returns."""
        n, s, K = args.n, args.s, 16
        t0 = time.perf_counter()
        g = powerlaw(n, s, alpha=0.5, seed=args.seed + 3)
        Y = make_labels(n, K, 0.10, np.random.default_rng(args.seed + 4))
        t_data = time.perf_counter() - t0
        deg = np.bincount(g.u, minlength=n) + np.bincount(g.v, minlength=n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        emb = Embedder(EncoderConfig(K=K), backend="cuda").fit(g, Y)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        launches = dict(_build.launches)
        print(f"launches on the skew path: {launches}")
        if launches["gee_scatter"] != 1:
            raise AssertionError("the skew fit did not launch gee_scatter "
                                 "once")
        plan, cfg = emb._plan, emb.config
        T, row_ptr, tile_n = plan.data["T"], plan.data["row_ptr"], cfg.tile_n
        plan_bytes = sum(x.numel() * x.element_size()
                         for x in plan.data.values() if torch.is_tensor(x))
        largest = int((row_ptr[tile_n::tile_n]
                       - row_ptr[:-1:tile_n]).max().item())
        # the padded packing: every tile padded to the largest, 12 bytes a
        # slot
        padded = T * -(-largest // 512) * 512 * 12
        ref = Embedder(EncoderConfig(K=K), backend="torch").fit(g, Y).Z_
        z_err = (emb.Z_ - ref).abs().max().item()
        if not torch.allclose(emb.Z_, ref, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"skew phase: max|Z_cuda - Z_torch| = "
                                 f"{z_err}")
        del ref
        cls, val = emb.backend.resolve(plan, emb._Yj, emb.Wv_)
        kw = dict(num_tiles=T, tile_n=tile_n, kdim=K)
        ms = timer(lambda: GS.gee_scatter(row_ptr, cls, val, **kw), 20)
        S = cls.numel()
        b = bound_ms(8 * S + 8 * row_ptr.numel() + T * tile_n * K * 4,
                     int((val != 0).sum().item()))[0]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        dst_l, cls_l, val_l = edge_contributions(
            *(torch.as_tensor(a, device=dev) for a in (g.u, g.v, g.w)),
            emb._Yj, emb.Wv_)
        lib = timer(lambda: torch.zeros((n, K), device=dev).index_put_(
            (dst_l, cls_l), val_l, accumulate=True), 3)
        del dst_l, cls_l, val_l
        print(f"skew phase: powerlaw n={n} s={s} alpha=0.5, max degree "
              f"{int(deg.max())}, largest tile {largest} contributions; "
              f"data {t_data:.1f} s, cuda fit {t_fit:.2f} s; plan "
              f"{plan_bytes / 2**30:.3f} GiB on the device (padded to the "
              f"largest tile it would be {padded / 2**30:.1f} GiB); "
              f"max|Z_cuda - Z_torch| = {z_err:.3e} (rtol 1e-5, atol 1e-6); "
              f"gee_scatter {ms:.4f} ms, bound {b:.4f} ms, {b / ms:.3f} of "
              f"it, library (index_put_) {lib:.4f} ms; peak device memory "
              f"{peak_gib:.2f} GiB")
        return dict(skew_ms=ms, skew_bound_share=b / ms, skew_library_ms=lib)

    def compute_apps():
        """{pid: device MiB} of every process on the card
        (`nvidia-smi --query-compute-apps`)."""
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True).stdout
        apps = {}
        for line in out.splitlines():
            parts = [x.strip() for x in line.split(",")]
            if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
                apps[int(parts[0])] = int(parts[1])
        return apps

    def socket_path(g, truth, Y):
        """Phase 5c: the multi-process deployment at LiveJournal scale on
        the main path's graph.  A durable socket `ServingEngine` (4 shard
        workers, 1 WAL-tail replica) against a non-durable in-process
        engine on the same compacted store, through the same ticks; a
        shard worker killed mid-batch, a reopen with fresh workers and its
        checkpoint.  Every worker is shut down in a `finally`."""
        import tempfile
        from repro_torch import obs
        from repro_torch.graph.edges import Graph as G_
        from repro_torch.serving import GraphStore, MicroBatcher, ServingEngine
        from repro_torch.transport import MAX_FRAME, TransportError
        from repro_torch.transport import remote as R

        n, K, k, nq, P = g.n, 16, 10, 64, 4
        # the build RPC carries a shard's routed sub-multiset (12 bytes an
        # edge) and the labels (4 bytes a node) in one frame
        mid = n // 2
        half = int(((g.u < mid) | (g.v < mid)).sum())
        frame2 = 12 * half + 4 * n
        print(f"socket deployment: frame reckoning on the generated edges, "
              f"a build frame at 2 shards holds {half:,} edges, "
              f"{frame2 / 2**20:,.0f} MiB (MAX_FRAME "
              f"{MAX_FRAME / 2**20:.0f} MiB, over it: "
              f"{frame2 > MAX_FRAME}): {P} shard workers")
        builds = []
        real_build = R.RemoteShard.build

        def timed_build(self, graph_or_source, Y_):
            t0 = time.perf_counter()
            real_build(self, graph_or_source, Y_)
            builds.append((self.shard_id, graph_or_source.s,
                           time.perf_counter() - t0))

        R.RemoteShard.build = timed_build
        apps_peak = {}
        mem = {}

        def sample_apps():
            for pid, mib in compute_apps().items():
                apps_peak[pid] = max(apps_peak.get(pid, 0), mib)

        def note_memory(engine):
            """Each worker's own peak and reserved device bytes (ping)."""
            pings = [(f"shard {s.shard_id}", s.ping()) for s in engine.shards]
            pings += [("replica", r_.ping()) for r_ in engine._replicas]
            for role, pg in pings:
                dm = pg["device_memory"]
                if dm is None:               # not on a card: checked below
                    continue
                old = mem.get(role, (0, 0))
                mem[role] = (max(old[0], dm["max_allocated"]),
                             max(old[1], dm["reserved"]))
            return pings

        obs.configure(enabled=True)
        obs.reset()
        tick_rng = np.random.default_rng(args.seed + 9)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sock = oracle = rec = None
        tmp = tempfile.mkdtemp(prefix="socket-")
        try:
            data_dir = str(Path(tmp) / "deployment")
            store = GraphStore(g, Y, K)
            t0 = time.perf_counter()
            sock = ServingEngine(store, data_dir=data_dir, num_shards=P,
                                 backend="cuda", transport="socket",
                                 replicas=1, device="cuda")
            t_boot = time.perf_counter() - t0
            rep_proc = sock._replica_procs[0]
            print(f"socket boot: {t_boot:.2f} s (compaction, {P} shard "
                  f"builds, snapshot, replica spawn + bootstrap); spawn + "
                  f"handshake s per shard worker "
                  + ", ".join(f"{s.proc.ready_s:.2f}" for s in sock.shards)
                  + f"; replica spawn + bootstrap + handshake "
                  f"{rep_proc.ready_s:.2f} s")
            print("socket shard builds (shard, edges, frame MiB, s): "
                  + ", ".join(f"({i}, {s_:,}, {(12 * s_ + 4 * n) / 2**20:,.0f}"
                              f", {t_:.2f})" for i, s_, t_ in builds))
            if max(12 * s_ + 4 * n for _, s_, _ in builds) > MAX_FRAME:
                raise AssertionError("a build frame exceeds MAX_FRAME")
            sample_apps()
            # the in-process oracle: the same compacted edges, fingerprint
            # and labels, so the same (version, epoch, fingerprint) and Z
            base = store.base
            og = G_(base.u.copy(), base.v.copy(), base.w.copy(), n)
            og._fp = base.fingerprint()
            t0 = time.perf_counter()
            oracle = ServingEngine(GraphStore(og, Y.copy(), K), num_shards=P,
                                   backend="cuda", device="cuda")
            torch.cuda.synchronize()
            print(f"in-process oracle: {P} shard builds "
                  f"{time.perf_counter() - t0:.2f} s")
            del og
            if ((sock.version, sock.epoch, sock.fingerprint())
                    != (oracle.version, oracle.epoch, oracle.fingerprint())):
                raise AssertionError("socket and in-process engines start "
                                     "from different states")
            bats = [e.start(MicroBatcher(e, topk=k)) for e in (sock, oracle)]
            tick_ms, answers = [], []
            for tick in range(args.steps):
                reads = [tick_rng.integers(0, n, nq) for _ in range(2)]
                u = tick_rng.integers(0, n, 200).astype(np.int32)
                v = tick_rng.integers(0, n, 200).astype(np.int32)
                w = tick_rng.random(200).astype(np.float32) + 0.5
                row = []
                for bat in bats:
                    ts = [bat.submit("topk", reads[0]),
                          bat.submit("insert", (u, v, w)),
                          bat.submit("topk", reads[1])]
                    for t_ in ts:
                        t_.result(timeout=600)
                    row.append(ts)
                answers.append([[t_.result() for t_ in (ts[0], ts[2])]
                                for ts in row])
                tick_ms.append([max(t_.latency for t_ in ts if t_.kind == kd)
                                * 1e3 for ts in row
                                for kd in ("insert", "topk")])
                print(f"socket tick {tick}: ticket latency ms socket / "
                      f"in-process: insert {tick_ms[-1][0]:.2f} / "
                      f"{tick_ms[-1][2]:.2f}, top-k {tick_ms[-1][1]:.2f} / "
                      f"{tick_ms[-1][3]:.2f}")
            for e in (sock, oracle):
                e.stop()
                if e.loop_error is not None:
                    raise AssertionError(f"flush loop failed: "
                                         f"{e.loop_error!r}")
            sample_apps()
            served = {o: obs.registry().counter_value(
                "repro_transport_replica_reads_total", method="topk",
                outcome=o) for o in ("ok", "lag", "dead")}
            events = [r_.get("last_event") for r_ in
                      sock.health().get("replicas", [])]
            print(f"socket reads: replica served {served['ok']:.0f}, fell "
                  f"back to the owners on lag {served['lag']:.0f}, on a "
                  f"dead replica {served['dead']:.0f} (of "
                  f"{2 * args.steps}); last replica event {events}")
            same_answers = all(
                np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for (sa, oa) in answers for a, b in zip(sa, oa))
            z_equal = [bool(torch.equal(a.Z_owned, b.Z_owned))
                       for a, b in zip(sock.shards, oracle.shards)]
            # each worker's own candidates against the in-process shard's
            held = tick_rng.integers(0, n, nq).astype(np.int32)
            q = Q.normalize_rows(torch.as_tensor(oracle.query_embed(held),
                                                 device=dev))
            cand_equal = []
            for a, b in zip(sock.shards, oracle.shards):
                ca = a.topk_candidates(q, held, k=k)
                cb = b.topk_candidates(q, held, k=k)
                cand_equal.append(bool(np.array_equal(ca[0], cb[0])
                                       and np.array_equal(ca[1], cb[1])))
            print(f"socket == in-process: every top-k answer bit-equal "
                  f"{same_answers}; z_owned bit-equal per worker {z_equal}; "
                  f"topk_candidates bit-equal per worker {cand_equal}")
            if not (same_answers and all(z_equal) and all(cand_equal)):
                raise AssertionError("the socket deployment differs from the "
                                     "in-process engine")
            # the replica, caught up, answers as the owner at the pinned
            # version
            rep = sock._replicas[0]
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 300:
                st = rep.status()
                if st["version"] == sock.version:
                    break
                time.sleep(0.05)
            ri, rv = rep.topk(held, k=k, min_version=sock.version)
            oi, ov = oracle.query_topk(held, k=k)
            re_ = rep.embed(held, min_version=sock.version)
            rep_equal = bool(np.array_equal(ri, oi) and np.array_equal(rv, ov)
                             and np.array_equal(re_, oracle.query_embed(held)))
            print(f"replica at version {st['version']} (caught up in "
                  f"{time.perf_counter() - t0:.2f} s, {st['records_applied']} "
                  f"records applied): pinned top-k and embed bit-equal to the "
                  f"owner's {rep_equal}")
            if not rep_equal:
                raise AssertionError("the replica's pinned read differs from "
                                     "the owner's")
            pings = [pg for _, pg in note_memory(sock)]
            for pg in pings:
                print(f"worker ping: {pg['role']} "
                      f"{pg.get('shard_id', '')} pid {pg['pid']} device "
                      f"{pg['device']} backend {pg['backend']} launches "
                      f"{pg['launches']}")
                if not pg["device"].startswith("cuda"):
                    raise AssertionError(f"a worker is not on the card: {pg}")
                for name in ("gee_scatter", "gee_delta_renorm", "topk_fused"):
                    if pg["launches"][name] == 0:
                        raise AssertionError(f"{name} never launched in "
                                             f"{pg['role']} {pg['pid']}")
            # kill a shard worker mid-batch: the write fails loudly after
            # its WAL append, and a reopen recovers it
            u = tick_rng.integers(0, n, 200).astype(np.int32)
            v = tick_rng.integers(0, n, 200).astype(np.int32)
            w = tick_rng.random(200).astype(np.float32) + 0.5
            sock.shards[1].proc.kill()
            try:
                sock.apply_edge_delta(u, v, w)
            except TransportError as e:
                print(f"killed shard worker 1: the write failed loudly "
                      f"({type(e).__name__}: {e})")
            else:
                raise AssertionError("a write to a dead shard worker "
                                     "succeeded")
            oracle.apply_edge_delta(u, v, w)
            records = sock.wal.records_appended
            procs = list(sock._shard_procs) + list(sock._replica_procs)
            sock.close()
            sock = None
            codes = [p_.proc.returncode for p_ in procs]
            print(f"first deployment closed: worker exit codes {codes} "
                  f"(shard worker 1 killed)")
            if codes != [0, -9] + [0] * (len(codes) - 2):
                raise AssertionError(f"a worker did not exit cleanly: "
                                     f"{codes}")
            n_builds = len(builds)
            t0 = time.perf_counter()
            rec = ServingEngine.open(data_dir, transport="socket",
                                     backend="cuda", device="cuda")
            t_open = time.perf_counter() - t0
            print("socket reopen: spawn + handshake s per shard worker "
                  + ", ".join(f"{s.proc.ready_s:.2f}" for s in rec.shards)
                  + "; shard builds (shard, edges, s) "
                  + ", ".join(f"({i}, {s_:,}, {t_:.2f})"
                              for i, s_, t_ in builds[n_builds:]))
            note_memory(rec)
            sample_apps()
            rtriple = (rec.version, rec.epoch, rec.fingerprint())
            otriple = (oracle.version, oracle.epoch, oracle.fingerprint())
            dz = max((a.Z_owned - b.Z_owned).abs().max().item()
                     for a, b in zip(rec.shards, oracle.shards))
            ri, rv = rec.query_topk(held, k=k)
            oi, ov = oracle.query_topk(held, k=k)
            topk_equivalent(ri, rv, oi, ov)
            print(f"socket reopen: {t_open:.2f} s ({records} WAL records "
                  f"this generation, the torn write included); {rtriple[:2]} "
                  f"vs in-process {otriple[:2]}, fingerprint equal "
                  f"{rtriple[2] == otriple[2]}; max|dZ| = {dz:.3e}; held "
                  f"top-k topk_equivalent, bit-equal "
                  f"{bool(np.array_equal(ri, oi) and np.array_equal(rv, ov))}")
            if rtriple != otriple:
                raise AssertionError(f"reopened {rtriple} != in-process "
                                     f"{otriple}")
            for a, b in zip(rec.shards, oracle.shards):
                if not torch.allclose(a.Z_owned, b.Z_owned, rtol=1e-5,
                                      atol=1e-6):
                    raise AssertionError(f"reopened Z differs: {dz}")
            # a checkpoint of the reopened deployment: compaction, 4 socket
            # builds, snapshot, a rotated WAL
            t0 = time.perf_counter()
            info = rec.checkpoint()
            t_ckpt = time.perf_counter() - t0
            print(f"socket checkpoint (the reopened deployment): "
                  f"{t_ckpt:.2f} s (generation {info['generation']}, "
                  f"{info['edges_before']:,} -> {info['edges_after']:,} "
                  f"edges)")
            note_memory(rec)
            sample_apps()
            mem["router"] = (torch.cuda.max_memory_allocated(),
                             torch.cuda.memory_reserved())
            print("socket phase device memory per process, torch peak "
                  "allocated / reserved GiB: " + ", ".join(
                      f"{role} {a / 2**30:.2f} / {b / 2**30:.2f}"
                      for role, (a, b) in mem.items())
                  + "; nvidia-smi --query-compute-apps peak MiB by pid: "
                  + ", ".join(f"{pid} {mib}"
                              for pid, mib in sorted(apps_peak.items())))
            procs = list(rec._shard_procs)
            rec.close()
            rec = None
            codes = [p_.proc.returncode for p_ in procs]
            print(f"reopened deployment closed: worker exit codes {codes}")
            if any(codes):
                raise AssertionError(f"a worker did not exit cleanly: "
                                     f"{codes}")
            return dict(boot_s=t_boot, checkpoint_s=t_ckpt, reopen_s=t_open,
                        replica_ready_s=rep_proc.ready_s, tick_ms=tick_ms,
                        replica_reads=served, builds=builds)
        finally:
            R.RemoteShard.build = real_build
            for e in (sock, rec):
                if e is not None:
                    e.close()
            if oracle is not None:
                oracle.close()
            shutil.rmtree(tmp, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()

    def lm_self_check(cfg, params, prompts, first):
        """Kernel path against the dense plain path, layer by layer on the
        same input (teacher-forced): each prefill block with the kernel
        vs with `attn_full`, and each decode block (cache from the kernel
        path) vs the dense block over the S + 1 tokens at position S.
        Then `prefill`'s and `decode_step`'s logits vs the logits of the
        layer-by-layer run's last activations.  Each within LM_REL_TOL x
        max|reference|; top-1 equal wherever the reference's top-2
        margin exceeds that.  Last, the free-running gap to
        `forward_logits(impl="full")` is printed, not held: over 32
        random layers it is not a rounding bound (see LM_REL_TOL)."""
        from repro_torch.models import attention as A
        from repro_torch.models import transformer as T
        from repro_torch.models.layers import embed_tokens, take

        def rel(got, ref):
            err = (got.float() - ref.float()).abs().max().item()
            return err, err / max(ref.float().abs().max().item(), 1e-30)

        B, S = prompts.shape
        worst = {"prefill": (0.0, -1), "decode": (0.0, -1)}
        with torch.inference_mode():
            pl, cache = M.prefill(cfg, params, {"tokens": prompts},
                                  max_len=S + 1)
            dl, _ = M.decode_step(cfg, params, first, S, cache)
            del cache
            pos, pos1 = (torch.arange(n_, device=dev) for n_ in (S, S + 1))
            x = embed_tokens(cfg, params["embed"], prompts)
            xd = embed_tokens(cfg, params["embed"], first[:, None])[:, 0]
            for i in range(cfg.n_layers):
                p = take(params["stack"], i)
                yk, (k, v), _ = T.attn_block_train(cfg, p, x, pos,
                                                   impl="flash")
                yf, _, _ = T.attn_block_train(cfg, p, x, pos, impl="full")
                c = A.init_kv_cache(cfg, B, S + 1, x.dtype, device=dev)
                A.fill_kv_cache(cfg, c, k, v)
                yd, _, _ = T.attn_block_decode(cfg, p, xd, S, c)
                y1, _, _ = T.attn_block_train(
                    cfg, p, torch.cat([x, xd[:, None]], 1), pos1,
                    impl="full")
                for what, r_ in (("prefill", rel(yk, yf)[1]),
                                 ("decode", rel(yd, y1[:, S])[1])):
                    if r_ > worst[what][0]:
                        worst[what] = (r_, i)
                x, xd = yk, yd
                del yf, y1, c, k, v
            refs = [M._mask_padded_vocab(cfg, M._logits(
                cfg, params, y[:, None])[:, 0]) for y in (x[:, -1], xd)]
            del x, xd
            full, _ = M.forward_logits(
                cfg, params, torch.cat([prompts, first[:, None]], 1),
                impl="full")
            V = cfg.vocab
            free = [rel(pl[:, :V], full[:, S - 1, :V])[0],
                    rel(dl[:, :V], full[:, S, :V])[0]]
            del full
        for what, (r_, i) in worst.items():
            print(f"LM self-check, {what} blocks vs dense on the same "
                  f"input: worst max|diff| / max|ref| = {r_:.3e} (layer "
                  f"{i}), tol {LM_REL_TOL}")
            if not r_ <= LM_REL_TOL:
                raise AssertionError(f"LM self-check {what} block {i} off")
        for what, got, ref in (("prefill", pl, refs[0]),
                               ("decode step 1", dl, refs[1])):
            got, ref = got[:, :cfg.vocab].float(), ref[:, :cfg.vocab].float()
            err, r_ = rel(got, ref)
            top2 = ref.topk(2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > LM_REL_TOL * \
                ref.abs().max()
            agree = got.argmax(-1) == ref.argmax(-1)
            print(f"LM self-check, {what} logits vs the layer-by-layer run: "
                  f"max|diff| {err:.3e} ({r_:.3e} of max|logit|, "
                  f"bit-equal {bool(torch.equal(got, ref))}); top-1 agrees "
                  f"in {int(agree.sum())}/{B} rows, margin > tol in "
                  f"{int(decided.sum())}")
            if not r_ <= LM_REL_TOL or not bool(agree[decided].all()):
                raise AssertionError(f"LM self-check {what} logits off")
        print(f"free-running gap to forward_logits(impl='full') (printed, "
              f"not held): prefill {free[0]:.3f}, decode step 1 "
              f"{free[1]:.3f}")

    def lm_path():
        """Phase 6 (LM serve path); returns the flash kernel's row."""
        cfg = get_config("yi-6b")
        if args.lm_layers != cfg.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=args.lm_layers)
            print(f"LM depth CUT to {cfg.n_layers} of 32 layers")
        B, S, G = args.lm_batch, args.lm_prompt, args.lm_gen
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = M.init_params(cfg, args.seed, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        prompts = torch.as_tensor(np.random.default_rng(args.seed + 3).integers(
            0, cfg.vocab, (B, S)), device=dev)
        cold = {}
        generate(cfg, params, prompts, 2, timings=cold)   # warm-up

        _build.reset_launches()
        t = {}
        toks = generate(cfg, params, prompts, G, timings=t)
        launches = dict(_build.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"LM path: {cfg.name}, {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.param_count():,} params "
              f"({cfg.param_dtype}, compute {cfg.compute_dtype}); init "
              f"{t_init:.2f} s; warm-up prefill {cold['prefill_s'] * 1e3:.1f}"
              " ms")
        print(f"prefill B={B} S={S}: {t['prefill_s'] * 1e3:.1f} ms "
              f"({B * S / t['prefill_s']:,.0f} tok/s); decode {G - 1} "
              f"steps: {t['decode_s'] * 1e3 / max(G - 1, 1):.2f} ms per "
              f"step ({B * (G - 1) / t['decode_s']:,.0f} tok/s); peak "
              f"device memory {peak_gib:.2f} GiB")
        print(f"launches on the LM path: {launches}")
        if launches["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"flash_attention launched "
                                 f"{launches['flash_attention']} times, "
                                 f"expected one per layer ({cfg.n_layers})"
                                 " in prefill and none in decode")
        if any(n_ for k_, n_ in launches.items() if k_ != "flash_attention"):
            raise AssertionError("a GEE kernel ran on the LM path")
        if (tuple(toks.shape) != (B, G) or int(toks.min()) < 0
                or int(toks.max()) >= cfg.vocab):
            raise AssertionError(f"generated tokens off: {tuple(toks.shape)}")

        # where the time goes: one prefill and one decode step profiled
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with torch.inference_mode():
            with profile(activities=acts) as prof_p:
                _, cache = M.prefill(cfg, params, {"tokens": prompts},
                                     max_len=S + 2)
                torch.cuda.synchronize()
            with profile(activities=acts) as prof_d:
                M.decode_step(cfg, params, toks[:, 0], S, cache)
                torch.cuda.synchronize()
            del cache
        for what, prof, wall in (
                ("prefill", prof_p, t["prefill_s"] * 1e3),
                ("decode step", prof_d,
                 t["decode_s"] * 1e3 / max(G - 1, 1))):
            busy, n_dev, top = kernel_times(prof)
            print(f"profile {what}: device busy {busy:.1f} ms in {n_dev} "
                  f"kernels and copies, unprofiled wall {wall:.1f} ms, "
                  "device idle share "
                  f"{1 - busy / wall:.3f}; by kernel: " + "; ".join(
                      f"{n_[:56]} {ms_:.2f} ms x{c_}"
                      for n_, (ms_, c_) in top[:8]))

        lm_self_check(cfg, params, prompts, toks[:, 0])
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # the kernel at the prefill's shape
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        gen_ = torch.Generator(device=dev).manual_seed(args.seed)
        q, k, v = (torch.randn((B, h_, S, D), generator=gen_, device=dev,
                               dtype=torch.bfloat16) for h_ in (H, KV, KV))
        err = check_flash(q, k, v, "LM prefill shape")

        def run_sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)

        lib_err = (run_sdpa().float()
                   - FA.flash_attention_plain(q, k, v).float()).abs().max()
        print(f"library call max|err| vs plain: {lib_err.item():.3e}")
        flops = 4.0 * D * B * H * S * (S + 1) / 2    # causal pairs x 4 D
        nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
        b, by = bound_ms(nbytes, flops, BF16_TC_FLOPS)

        def run_kernel():
            return FA.flash_attention(q, k, v)

        # kernel and library call in turns: kernel, library, library, kernel
        ms1, lib1 = timer(run_kernel, 20), timer(run_sdpa, 20)
        lib2, ms2 = timer(run_sdpa, 20), timer(run_kernel, 20)
        ms = (ms1 + ms2) / 2
        print(f"flash_attention at the prefill's shape: kernel {ms1:.4f} / "
              f"{ms2:.4f} ms, library {lib1:.4f} / {lib2:.4f} ms")
        plain_ms = timer(lambda: FA.flash_attention_plain(q, k, v), 3)
        del q, k, v
        # the wide body (D > 128) at one shape: yi's batch and GQA group,
        # 8 query heads, S = 2048, D = 256, bfloat16
        Dw, Hw, KVw = 256, 8, 2
        qw, kw_, vw = (torch.randn((B, h_, S, Dw), generator=gen_,
                                   device=dev, dtype=torch.bfloat16)
                       for h_ in (Hw, KVw, KVw))
        check_flash(qw, kw_, vw, "wide body D=256")
        flops_w = 4.0 * Dw * B * Hw * S * (S + 1) / 2
        wide = dict(
            wide_D256_ms=timer(lambda: FA.flash_attention(qw, kw_, vw), 5),
            wide_D256_bound_ms=bound_ms(
                2 * (2 * B * Hw * S * Dw + 2 * B * KVw * S * Dw), flops_w,
                BF16_TC_FLOPS)[0],
            wide_D256_plain_ms=timer(
                lambda: FA.flash_attention_plain(qw, kw_, vw), 2),
            wide_D256_library_ms=timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qw, kw_, vw, is_causal=True, enable_gqa=True), 5))
        print(f"flash_attention wide body at B={B} H={Hw} KV={KVw} S={S} "
              f"D={Dw} bf16: kernel {wide['wide_D256_ms']:.4f} ms, bound "
              f"{wide['wide_D256_bound_ms']:.4f} ms, plain "
              f"{wide['wide_D256_plain_ms']:.4f} ms, library "
              f"{wide['wide_D256_library_ms']:.4f} ms")
        del qw, kw_, vw
        return dict(**wide,
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:72",
            launches=launches["flash_attention"], max_abs_err=err,
            ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, library_ms=(lib1 + lib2) / 2,
            tflops=flops / ms / 1e9, bound_share=b / ms,
            shape=f"B={B} H={H} KV={KV} S={S} D={D} bf16")

    def cut_depth(cfg, n):
        """cfg at full width with at most n layers (a whole group for
        zamba2 and xLSTM, n decoder and n encoder layers for whisper)."""
        if n is None or n >= cfg.n_layers:
            return cfg
        if cfg.is_encdec:
            return dataclasses.replace(cfg, n_layers=n, enc_layers=n,
                                       dec_layers=n)
        step = (cfg.xlstm.slstm_every if cfg.xlstm is not None
                else cfg.attn_every or 1)
        return dataclasses.replace(cfg, n_layers=max(step, n // step * step))

    def family_self_check(cfg, params, prompts, first, frames):
        """Phase 7's self-check, block by block on the same input
        (teacher-forced), by lm_self_check's rule (LM_REL_TOL x
        max|reference|):
        * each causal self-attention sublayer (norm, attention, output
          projection, residual) with the kernel against the dense
          `attn_full` path in prefill, and its decode form (cache from
          the kernel path) against the dense sublayer over the S + 1
          tokens at position S.  The rest of the block (whisper's
          cross-attention, the MLP or MoE FFN) then runs once, on the
          kernel path's output: MoE routing is discontinuous, so two
          paths within rounding may route a token differently;
        * each recurrent block (Mamba2, mLSTM, sLSTM) continued by one
          decode step from its prefill state, against the block over
          the S + 1 tokens at position S;
        * `prefill`'s and `decode_step`'s logits against the logits of
          the layer-by-layer run's last activations.
        The free-running gap to `forward_logits(impl="full")` on the
        S + 1 tokens is printed, not held, for every family: with random
        weights each stack magnifies rounding layer by layer (see
        LM_REL_TOL), xLSTM's too (its mLSTM divides by a normalizer that
        can be near zero).  On an NVIDIA H100 at bf16 xLSTM's prefill
        logits, the same code on the same first S tokens, differ from
        forward_logits' by 0.49 of max|logit|: the products' blocking
        differs between S and S + 1 rows.
        Returns the worst relative error of all held checks."""
        from repro_torch.models import attention as A
        from repro_torch.models import transformer as T
        from repro_torch.models.layers import embed_tokens, take

        B, S = prompts.shape
        worst = {}

        def note(what, got, ref):
            err = (got.float() - ref.float()).abs().max().item()
            r_ = err / max(ref.float().abs().max().item(), 1e-30)
            worst[what] = max(worst.get(what, 0.0), r_)

        pos, pos1 = (torch.arange(n_, device=dev) for n_ in (S, S + 1))
        posd = torch.full((1,), S, device=dev)

        def attn_layer(p, x, xd, enc_kv=None):
            yk, (k, v) = T.self_attn_train(cfg, p, x, pos, impl="flash")
            yf, _ = T.self_attn_train(cfg, p, x, pos, impl="full")
            note("prefill attention", yk, yf)
            del yf
            c = A.init_kv_cache(cfg, B, S + 1, x.dtype, device=dev)
            A.fill_kv_cache(cfg, c, k, v)
            yd, _ = T.self_attn_decode(cfg, p, xd, S, c)
            y1, _ = T.self_attn_train(cfg, p, torch.cat([x, xd[:, None]], 1),
                                      pos1, impl="full")
            note("decode attention", yd, y1[:, S])
            del y1, c, k, v
            x, _ = T.block_tail(cfg, p, yk, pos, enc_kv=enc_kv)
            xd, _ = T.block_tail(cfg, p, yd[:, None], posd, enc_kv=enc_kv)
            return x, xd[:, 0]

        def recurrent_layer(fn, p, x, xd):
            y, st = fn(cfg, p, x, None)
            yd, _ = fn(cfg, p, xd[:, None], st)
            y1, _ = fn(cfg, p, torch.cat([x, xd[:, None]], 1), None)
            note("decode recurrent", yd[:, 0], y1[:, S])
            return y, yd[:, 0]

        with torch.inference_mode():
            batch = {"tokens": prompts}
            if cfg.is_encdec:
                batch["frames"] = frames
            pl, cache = M.prefill(cfg, params, batch, max_len=S + 1)
            dl, _ = M.decode_step(cfg, params, first, S, cache)
            del cache
            x = embed_tokens(cfg, params["embed"], prompts,
                             pos if cfg.learned_pos else None)
            xd = embed_tokens(cfg, params["embed"], first[:, None],
                              posd[None].expand(B, 1) if cfg.learned_pos
                              else None)[:, 0]
            st = params["stack"] if "stack" in params else None
            if cfg.is_encdec:
                enc = T.whisper_encode(cfg, params, frames)
                for i in range(cfg.dec_layers):
                    p = take(params["dec"], i)
                    x, xd = attn_layer(p, x, xd, T.encoder_kv(p, enc))
                del enc
            elif cfg.xlstm is not None:
                for i in range(T.depth(st)):
                    g = take(st, i)
                    for j in range(T.depth(g["mlstm"])):
                        x, xd = recurrent_layer(T.mlstm_block,
                                                take(g["mlstm"], j), x, xd)
                    x, xd = recurrent_layer(T.slstm_block, g["slstm"], x, xd)
            elif cfg.ssm is not None:
                x0, xd0 = x, xd
                for i in range(T.depth(st["groups"])):
                    g = take(st["groups"], i)
                    for j in range(T.depth(g["mamba"])):
                        x, xd = recurrent_layer(T.mamba_block,
                                                take(g["mamba"], j), x, xd)
                    h, hd = attn_layer(st["shared_attn"],
                                       T._zamba_shared_in(cfg, st, x, x0),
                                       T._zamba_shared_in(cfg, st, xd, xd0))
                    x, xd = x + h, xd + hd
                if "tail" in st:
                    for j in range(T.depth(st["tail"])):
                        x, xd = recurrent_layer(T.mamba_block,
                                                take(st["tail"], j), x, xd)
            else:
                for i in range(T.depth(st)):
                    x, xd = attn_layer(take(st, i), x, xd)
            refs = [M._mask_padded_vocab(cfg, M._logits(
                cfg, params, y[:, None])[:, 0]) for y in (x[:, -1], xd)]
            del x, xd
            full, _ = M.forward_logits(
                cfg, params, torch.cat([prompts, first[:, None]], 1),
                frames=frames, impl="full")
            V = cfg.vocab
            free = [(pl[:, :V], full[:, S - 1, :V]),
                    (dl[:, :V], full[:, S, :V])]
            del full
        for what, got, ref in (("prefill logits", pl, refs[0]),
                               ("decode logits", dl, refs[1])):
            got, ref = got[:, :V].float(), ref[:, :V].float()
            note(what, got, ref)
            top2 = ref.topk(2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > LM_REL_TOL * \
                ref.abs().max()
            if not bool((got.argmax(-1) == ref.argmax(-1))[decided].all()):
                raise AssertionError(f"{cfg.name}: {what}: top-1 differs "
                                     "from the layer-by-layer run's")
        gaps = [(got.float() - ref.float()).abs().max().item()
                / max(ref.float().abs().max().item(), 1e-30)
                for got, ref in free]
        bad = {k_: v_ for k_, v_ in worst.items() if not v_ <= LM_REL_TOL}
        print(f"  self-check {cfg.name} (batch {B}): " + ", ".join(
            f"{k_} {v_:.3e}" for k_, v_ in worst.items())
            + f"; tol {LM_REL_TOL}; free-running gap to forward_logits"
            f"(impl='full') / max|logit|: prefill {gaps[0]:.3e}, decode "
            f"{gaps[1]:.3e} (printed, not held)")
        if bad:
            raise AssertionError(f"{cfg.name} self-check off: {bad}")
        return max(worst.values())

    def families_path():
        """Phase 7 (the other LM families' serve path).  Returns the
        flash row's additions: launches by arch, and the kernel at the
        D = 64 and D = 120 prefill shapes."""
        from torch.profiler import ProfilerActivity, profile
        by_arch = {}
        for arch, depth in FAMILIES:
            cfg0 = get_config(arch)
            limit = [n_ for n_ in (depth, args.fam_layers) if n_ is not None]
            cfg = cut_depth(cfg0, min(limit) if limit else None)
            cut = (f"depth CUT to {cfg.n_layers} of {cfg0.n_layers} layers"
                   if cfg.n_layers != cfg0.n_layers else
                   f"full depth, {cfg.n_layers} layers")
            B, S = args.lm_batch, args.lm_prompt
            G = args.lm_gen if arch == FAMILY_MAIN else FAMILY_GEN
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_arch = time.perf_counter()
            t0 = time.perf_counter()
            params = M.init_params(cfg, args.seed, device=dev)
            torch.cuda.synchronize()
            t_init = time.perf_counter() - t0
            rs = np.random.default_rng(args.seed + 5)
            prompts = torch.as_tensor(rs.integers(0, cfg.vocab, (B, S)),
                                      device=dev)
            frames = None
            if cfg.is_encdec:
                frames = torch.as_tensor(rs.normal(0, 1, (
                    B, cfg.n_frames, cfg.d_model)).astype(np.float32),
                    device=dev)
            generate(cfg, params, prompts, 2, frames=frames)   # warm-up
            _build.reset_launches()
            t = {}
            toks = generate(cfg, params, prompts, G, frames=frames,
                            timings=t)
            launches = dict(_build.launches)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            want = expected_flash(cfg, S)
            if launches["flash_attention"] != want:
                raise AssertionError(f"{arch}: flash_attention launched "
                                     f"{launches['flash_attention']} times "
                                     f"in prefill + decode, expected {want}")
            if any(n_ for k_, n_ in launches.items()
                   if k_ != "flash_attention"):
                raise AssertionError(f"{arch}: a GEE kernel ran")
            if (tuple(toks.shape) != (B, G) or int(toks.min()) < 0
                    or int(toks.max()) >= cfg.vocab):
                raise AssertionError(f"{arch}: generated tokens off")
            by_arch[arch] = launches["flash_attention"]
            # device activity only: xLSTM's prefill launches ~10^5 kernels
            acts = [ProfilerActivity.CUDA]
            batch = {"tokens": prompts}
            if frames is not None:
                batch["frames"] = frames
            with torch.inference_mode():
                with profile(activities=acts) as prof_p:
                    _, cache = M.prefill(cfg, params, batch, max_len=S + 2)
                    torch.cuda.synchronize()
                with profile(activities=acts) as prof_d:
                    M.decode_step(cfg, params, toks[:, 0], S, cache)
                    torch.cuda.synchronize()
                del cache
            dec_ms = t["decode_s"] * 1e3 / max(G - 1, 1)
            idle = []
            for prof, wall in ((prof_p, t["prefill_s"] * 1e3),
                               (prof_d, dec_ms)):
                busy, n_dev, top = kernel_times(prof)
                idle.append(1 - busy / wall)
                what = "prefill" if prof is prof_p else "decode step"
                print(f"  profile {arch} {what}: device busy {busy:.1f} ms "
                      f"in {n_dev} kernels and copies; by kernel: "
                      + "; ".join(
                          f"{n_[:48]} {ms_:.2f} ms x{c_}"
                          for n_, (ms_, c_) in top[:5]))
            del prof_p, prof_d
            # the dense scores of the self-check's attention at this batch
            # (float32 (B, H, S + 1, S + 1); up to about four alive at once):
            # chameleon-34b's at batch 4 do not fit beside its weights
            H = cfg.n_heads if cfg.xlstm is None else 0
            need = 4 * 4 * B * H * (S + 1) ** 2 + 4 * 2**30
            torch.cuda.empty_cache()
            nb = B if need < torch.cuda.mem_get_info()[0] else 1
            err = family_self_check(
                cfg, params, prompts[:nb], toks[:nb, 0],
                None if frames is None else frames[:nb])
            print(f"family {arch}: {cut}, {cfg.param_count():,} params "
                  f"({cfg.param_dtype}, compute {cfg.compute_dtype}); init "
                  f"{t_init:.2f} s; prefill B={B} S={S}: "
                  f"{t['prefill_s'] * 1e3:.1f} ms; decode {G - 1} steps: "
                  f"{dec_ms:.2f} ms per step; device idle share prefill "
                  f"{idle[0]:.3f}, decode {idle[1]:.3f}; flash launches "
                  f"{launches['flash_attention']} (expected {want}); peak "
                  f"{peak_gib:.2f} GiB; self-check max rel err {err:.3e}; "
                  f"wall {time.perf_counter() - t_arch:.1f} s")
            del params, prompts, frames, toks
            gc.collect()
            torch.cuda.empty_cache()

        # the kernel at the families' other head dims, prefill shapes
        out = dict(launches_by_arch=by_arch)
        B, S = args.lm_batch, args.lm_prompt
        gen_ = torch.Generator(device=dev).manual_seed(args.seed + 7)
        for tag, arch in (("whisper_D64", "whisper-medium"),
                          ("zamba2_D64", "zamba2-1.2b"),
                          ("danube_D120", "h2o-danube-3-4b")):
            c_ = get_config(arch)
            H, KV, D = c_.n_heads, c_.n_kv_heads, c_.head_dim
            q, k, v = (torch.randn((B, h_, S, D), generator=gen_, device=dev,
                                   dtype=torch.bfloat16)
                       for h_ in (H, KV, KV))
            e_ = check_flash(q, k, v, f"{arch} prefill shape")
            flops = 4.0 * D * B * H * S * (S + 1) / 2
            nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
            out[f"{tag}_ms"] = timer(lambda: FA.flash_attention(q, k, v), 20)
            out[f"{tag}_bound_ms"] = bound_ms(nbytes, flops,
                                              BF16_TC_FLOPS)[0]
            out[f"{tag}_plain_ms"] = timer(
                lambda: FA.flash_attention_plain(q, k, v), 2)
            out[f"{tag}_library_ms"] = timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 20)
            print(f"flash_attention at {arch}'s prefill shape B={B} H={H} "
                  f"KV={KV} S={S} D={D} bf16: kernel {out[tag + '_ms']:.4f}"
                  f" ms, bound {out[tag + '_bound_ms']:.4f} ms, plain "
                  f"{out[tag + '_plain_ms']:.4f} ms, library "
                  f"{out[tag + '_library_ms']:.4f} ms, max|err| {e_:.3e}")
            del q, k, v
        return out

    walls = {"build + small shapes": time.perf_counter() - t_start}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        return out

    results, main_graph = timed("GEE path", gee_path)
    gc.collect()
    torch.cuda.empty_cache()
    timed("plan cache", plan_cache_path, main_graph[0], main_graph[2])
    timed("engine", engine_path, *main_graph)
    gc.collect()
    results[0].update(timed("skew", skew_path))
    gc.collect()
    torch.cuda.empty_cache()
    timed("socket deployment", socket_path, *main_graph)
    del main_graph
    gc.collect()
    results.append(timed("yi-6b", lm_path))
    gc.collect()
    torch.cuda.empty_cache()
    fam = timed("families", families_path)
    gc.collect()
    torch.cuda.empty_cache()
    flash_train, scatter_train = timed("training", train_path, torch, dev,
                                       args, timer, smi)
    print("phase wall seconds: " + ", ".join(f"{k_} {v_:.1f}"
                                             for k_, v_ in walls.items()))
    fam["launches_by_arch"] = {"yi-6b": results[-1]["launches"],
                               **fam["launches_by_arch"]}
    results[-1].update(fam)
    results[-1].update(flash_train)
    results[0].update(scatter_train)

    for r_ in results:
        rate = (f", {r_['tflops']:.1f} TFLOP/s, {r_['bound_share']:.3f} of "
                f"the bound; wide body D = 256: {r_['wide_D256_ms']:.4f} ms "
                f"(bound {r_['wide_D256_bound_ms']:.4f})"
                ) if "tflops" in r_ else ""
        if "ms_all_labelled" in r_:
            rate = (f", {r_['bound_share']:.3f} of the bound "
                    f"({r_['bound_share_12b']:.3f} of the 12-byte one), all "
                    f"labelled {r_['ms_all_labelled']:.4f} ms (bound "
                    f"{r_['all_labelled_bound_ms']:.4f}, library "
                    f"{r_['all_labelled_library_ms']:.4f}), embed "
                    f"{r_['embed_ms']:.4f} ms, skew {r_['skew_ms']:.4f} ms "
                    f"({r_['skew_bound_share']:.3f} of its bound, library "
                    f"{r_['skew_library_ms']:.4f})")
        if "select_ms" in r_:
            rate = (f", select {r_['select_ms']:.4f} ms + merge "
                    f"{r_['merge_ms']:.4f} ms, {r_['bound_share']:.3f} of "
                    f"the bound, issue floor {r_['issue_floor_ms']:.4f} ms; "
                    f"general path: k = 100 {r_['wide_k100_ms']:.4f} ms "
                    f"(bound {r_['wide_k100_bound_ms']:.4f}, library "
                    f"{r_['wide_k100_library_ms']:.4f}), K = 300 "
                    f"{r_['wide_K300_ms']:.4f} ms (bound "
                    f"{r_['wide_K300_bound_ms']:.4f}, library "
                    f"{r_['wide_K300_library_ms']:.4f})")
        if "wide_K200_ms" in r_:
            rate = (f", rows in device memory at K = 200: "
                    f"{r_['wide_K200_ms']:.4f} ms (bound "
                    f"{r_['wide_K200_bound_ms']:.4f}, library "
                    f"{r_['wide_K200_library_ms']:.4f})")
        print(f"{r_['name']}: {r_['shape']}: kernel {r_['ms']:.4f} ms, "
              f"bound {r_['bound_ms']:.4f} ms ({r_['bound_by']}), plain "
              f"{r_['plain_ms']:.4f} ms, library {r_['library_ms']:.4f} ms, "
              f"launches {r_['launches']}, max|err| {r_['max_abs_err']:.3e}"
              f"{rate}")
        if "train_fn_ms" in r_:
            print(f"  {r_['name']} in training (phase 8): launches "
                  f"{r_['train_launches']}; forward + backward at yi's "
                  f"shape {r_['train_fn_ms']:.3f} ms (bound "
                  f"{r_['train_fn_bound_ms']:.4f}, plain "
                  f"{r_['train_fn_plain_ms']:.3f}, library "
                  f"{r_['train_fn_library_ms']:.3f})")
        elif "train_launches" in r_:
            print(f"  {r_['name']} in training (phase 8, the GEE embedding "
                  f"init): launches {r_['train_launches']}")
    print(json.dumps({"kernels": [{k_: v_ for k_, v_ in r_.items()
                                   if k_ != "shape"} for r_ in results]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
