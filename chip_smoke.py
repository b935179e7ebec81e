"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--steps 8] [--lm-batch 4]
                          [--lm-prompt 2048] [--lm-gen 16] [--lm-layers 32]
                          [--fam-layers N] [--train-layers 12]
                          [--train-steps 8]

1. builds every CUDA kernel of `src/repro_torch/kernels/csrc` with nvcc;
   It counts the HGMMA (wgmma) instructions in the flash library's SASS
   where the toolkit has `cuobjdump` (none fails the run) and requires
   ptxas to report no spills in the bfloat16 flash bodies (the
   backward's persistent pass one per D <= 128 and the D = 256 body, the
   forward per D <= 128 at its own width and at a narrower runtime width,
   at danube's 120, and the D = 256 body and its cluster forward), in the
   float32 backward's (`f32bwd`, one per D <= 128) and in the float32
   bodies at D = 256 (`f32wide`, `f32widebwd`, each also as its cluster
   body), and no C7520 (wgmma serialized) in any; the four walks'
   instantiations (above D = 2048) print their spill bytes;
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
   gee_delta_renorm at K = 200, topk_fused at K = 300 and at k = 100
   (the chunked and long-list select bodies), flash attention at D = 96
   (read in place by the D = 128 body) and at D = 160, 192, 256, 320,
   512, 768 and 2112 in both dtypes (up to 256 each dtype's D = 256 body,
   read in place: the tensor-core body at bfloat16, `f32wide` at float32;
   above it, up to 2048, the cluster forward, and at 2112 the CUDA-core
   wide body; each case's route checked).  At
   every flash case
   the forward with lse (`flash_attention_fwd`: the same output bits,
   lse within 1e-5 of the dense oracle's) and the backward
   (`flash_attention_bwd`, twice: the same bits) against its plain
   version on the same (o, lse) and a random dO, at the forward's
   tolerance; the float32 backward takes its body `f32bwd` up to D = 128
   (two float32-only cases: D = 96, zero-padded to 128, and a ragged S =
   1000 at D = 64), `f32widebwd` up to 256 (160 and 192 read in place),
   bfloat16 its D = 256 tensor-core body up to 256 (160 and 192 read in
   place); both dtypes the cluster backward at 320 (a ragged last slice),
   512 and 768 (three blocks a cluster), and in walks above 2048: 2112
   (two walks of five blocks) and 4160 (three walks of six) (each case's
   route checked);
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
   and the wide bodies at one wide shape each: top-k with k = 100 on
   shard 0's rows (the register body's long lists), top-k at K = 300
   (the chunked body) and the delta kernel at K = 200 on 262,144 random
   rows; each of these shapes, and the skew graph's scatter, also
   beside its library call, the top-k lines with the body each took;
   the delta kernel also on the device alone at the main shape, and a
   sweep at n_local = 1,048,576 over K = 16, 64, 128, 129, 172, 200,
   256, 512 with the real delta's entries: each K bit-equal to the
   plain version, timed beside its byte bound and library call, with
   the launcher's rows a tile, ring depth and grid);
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
5d. distributed GEE (`repro_torch.core.distributed`) on phase 3's graph
   in a one-rank NCCL group (`edge_mesh("cuda")`; one card, and NCCL
   puts no two ranks on one card): for each of the four modes an
   `Embedder(backend="distributed:<mode>", mesh=...)` plans, fits and
   refits, Z within atol 1e-5 of phase 3's cuda fit (the gee_scatter
   kernel) and nothing dropped; then `gee_a2a_steady` from
   `prebucket_host`'s buckets, the Laplacian through the ring against
   the cuda backend's fit of the Laplacian-scaled weights, and the name
   `backend="auto"` resolves to under the mesh.  Prints per mode plan
   and fit seconds, refit ms and peak device memory; destroys its group;
5e. the tuners (`repro_torch.launch.autotune`): `tune_scatter` over
   tile_n at phase 3's shape (an Erdos-Renyi graph of the same n, s,
   K = 16) and `tune_topk` over the select grid at phase 3's top-k
   shape (shard 0's rows, 64 queries, k = 10); prints the tuned geometry
   beside the default with each one's time and share of its bound, and
   requires the scatter's byte model at tile_n = 256 to equal the
   kernel table's bound bytes;
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
   prefill's shape, and at one wide shape (B = --lm-batch, H 8, KV 2,
   S = --lm-prompt, D = 256): the D = 256 tensor-core body at bfloat16
   beside SDPA and its bound (with the launcher's items and grid), the
   float32 bodies on the same inputs in float32 (`f32wide` and
   `f32widebwd`, with the launchers' items and grid) beside SDPA's
   float32 forward and backward (in turns) and their fp32 operation
   bounds: the forward held to its plain version at 2e-5, the backward
   to the plain version in float64 at atol = rtol = 2e-5, its two runs
   bit-equal, each at most F32_FWD_MAX_RATIO or F32_BWD_MAX_RATIO (1.25)
   x its SDPA call; both dtypes at D = 512 (B 1, H 8, KV 2, S =
   --lm-prompt: the cluster forward and the cluster backward, two blocks
   a cluster, with the launchers' C, items and clusters) in both
   directions beside SDPA (the backend it picks, read from a profile) and
   their bounds, the forward held to its plain version (2e-5 at float32,
   2e-2 at bfloat16, two runs bit-equal) and at most
   F32_CLUSTER_FWD_MAX_RATIO (0.8, float32) or BF16_CLUSTER_FWD_MAX_RATIO
   (0.25, bfloat16) x SDPA's forward, the backward's two runs bit-equal,
   held at float32 to the float64 plain version at atol = rtol = 2e-5
   and at bfloat16 to the plain version at 2e-2, and at most
   F32_BWD_MAX_RATIO (float32) or BF16_CLUSTER_BWD_MAX_RATIO (0.5,
   bfloat16) x SDPA's backward; the same forward and backward timed and
   printed at B = --lm-batch; both dtypes at D = 2304 (B 1, H 2, KV 1),
   the cluster bodies in two walks of five blocks, held to their plain
   versions (two runs bit-equal) and to at most WALK_MAX_RATIO x SDPA's,
   beside their bounds and the retired CUDA-core bodies' times from
   PERF.md; the backward (its
   D = 256 tensor-core body, with the launcher's items and grid) beside
   SDPA's backward, and `FlashAttentionFunction` forward + backward on
   the model's (B, S, H, D) layout beside SDPA's forward + backward, all
   in turns; then, at yi's prefill shape in float32, the CUDA-core
   forward (`f32body`) and backward (`f32bwd`, with the launcher's items
   and grid) beside SDPA's float32 forward and backward (in turns) and
   their float32 operation bounds, each held to its plain version at
   atol = rtol = 2e-5 (the backward to the plain version in float64,
   since the float32 one's own rounding takes two thirds of that limit
   there), the backward's two runs bit-equal and its time at most
   F32_BWD_MAX_RATIO (1.25) x SDPA's backward;
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
   dims (D = 64 for whisper and zamba2, D = 120 for danube, read in
   place) against its plain version, timed beside SDPA, with the ops
   named pad or copy in a profile of one launch (none expected);
8. the LM training path (`train_path`), at --lm-batch x --lm-prompt:
   a. `FlashAttentionFunction` (the forward kernel and the backward
      kernel) at yi-6b's attention shape against autograd of the plain
      attention: one launch of each kernel and no call of `causal_plain`,
      output at the bfloat16 tolerance, dq, dk, dv each element within
      GRAD_TOL and in the Frobenius norm within GRAD_FRO_TOL (the median
      |gradient| printed beside them); forward + backward timed beside
      the plain version and SDPA's.  Then the backward alone from the
      forward kernel's (o, lse): against `flash_attention_bwd_plain` by
      the same two limits, SDPA's backward read the same way (it must
      pass too), faults made from the kernel's gradients (dq zero from
      row 256 on, dk's and dv's last key tile zero, each gradient 2 %
      too large) that must fail, two runs bit-equal; the same checks on
      the (B, H, S, D) views of the model's (B, S, H, D) tensors, which
      must also give the contiguous copies' bits; timed beside its plain
      version and SDPA's backward (one autograd call on a retained
      graph), with its TFLOP/s over the five products and its share of
      their bound.  Last, a torch.profiler trace of one
      `FlashAttentionFunction` forward + backward on leaves that require
      grad: no copy (`aten::copy_`, `contiguous`, `clone`, a copy kernel)
      may run, and the device time is split by kernel against the host's
      wall time;
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
      Launch counts are zeroed just before and read just after: flash
      twice per layer per step (forward and remat), its backward once
      per layer per step, the
      scatter kernel at least 7 times in the embedding init (fit + 6
      refine rounds).  Every loss and grad norm finite, every leaf
      changed.  One more step runs under torch.profiler (device idle
      share);
   e. every arch's reduced config with remat: two train steps on the
      card against the same two on the CPU from the same weights (wq
      and wk tempered),
      losses within FAM_TRAIN_TOL; flash launched twice per causal
      self-attention per step, its backward once (the float32 body
      `f32bwd` at the reduced head dim);
9. the sharded paths and the dry run (`shard_path`, budget 150 s):
   a. a one-rank NCCL group and a (data=1, model=1) `DeviceMesh`: yi-6b
      at full width, 2 layers, remat, bfloat16 compute, wq and wk
      tempered, --lm-batch x --lm-prompt tokens: two steps of
      `jit_train_step` (params, m, v and batch as DTensors) against two
      of `make_train_step` from the same weights.  Losses and every leaf
      bit-equal (one rank: the same kernels in the same order; a gap
      within 1e-6 of max|leaf| is printed and passes).  Flash launches
      are zeroed before and read after the sharded steps: 2 x 2 x 2
      (forward and remat, each layer, each step) and 2 x 2 backward, the
      kernels run on each rank's local heads under DTensor;
   b. the same mesh and model under `use_sharding`: prefill of --lm-batch
      prompts of --lm-prompt tokens and 8 greedy tokens with DTensor
      params and a DTensor cache, against `generate` unsharded on the
      same params.  Yi has `decode_seq_shard`, so every decode step's
      attention takes `_decode_attn_seq_sharded` (counted); prefill
      launches flash once per layer.  The same tokens, and each decode
      attention output within LM_REL_TOL x max|output| of the
      unsharded one;
   c. the dry run against the card: `launch.dryrun.run_cell` on a
      one-rank fake mesh at phase 8's configuration (yi-6b width,
      --train-layers layers, --lm-batch x --lm-prompt).  Its argument
      bytes (params, m, v, batch) must equal what the card holds for
      them, exactly; its argument + temporary bytes are printed beside
      phase 8's measured peak, its roofline step beside phase 8's step;
   d. the production dry run on the host: `run_cell("yi-6b",
      "train_4k")` on the 256-rank fake mesh and `run_gee` for the four
      modes at Friendster scale, each `[dryrun]` line with its host
      seconds.

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
# Phase 8a's gradients at yi-6b's attention shape (bfloat16 dq, dk, dv
# of one attention call): each element within GRAD_TOL (atol and rtol) of
# the plain version's, and the whole gradient within GRAD_FRO_TOL of it
# in the Frobenius norm.  A gradient sums up to 16,384 terms whose
# factors P and dS are rounded to bfloat16, so an element near zero is
# off by the rounding of the largest terms: SDPA's own backward misses an
# elementwise 2e-2 on one element of 4.2M there.  The norm reading is
# what rounding leaves everywhere, about 3e-3 for the kernel and for
# SDPA; a gradient 2 % too large, or one key tile of dv left out, reads
# about 2e-2, which an elementwise limit does not see.  Phase 8a prints
# both readings for the kernel and for SDPA's backward, with the median
# |gradient| beside GRAD_TOL, and shows that the check refuses such
# faults.
GRAD_TOL = 3e-2
GRAD_FRO_TOL = 1e-2
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


def bound_ms(nbytes: float, flops: float, tensor_cores: bool = False):
    """(least ms for the work, "bytes" or "operations") from the port's
    hardware model (`repro_torch.launch.roofline.bound_s`): fp32
    operations outside the tensor cores, or with `tensor_cores` bf16 on
    them.  Attention on bf16 inputs is two matrix products per tile, work
    the card does at the tensor-core rate (the library call does): the
    least time for it is against that peak, whatever arithmetic a given
    kernel uses."""
    from repro_torch.launch import roofline as RL
    t, by = RL.bound_s(nbytes, flops,
                       RL.PEAK_FLOPS if tensor_cores else RL.FP32_FLOPS)
    return t * 1e3, by


def kernel_times(prof):
    """(device ms summed over kernels and copies, their count,
    [(name, (ms, count))] largest first) from a torch.profiler profile;
    one stream, so the sum is the device's busy time."""
    from torch.autograd import DeviceType
    agg = {}
    for e in prof.events():
        # (a profiler schedule's step marker also lands on the device)
        if (e.device_type == DeviceType.CUDA
                and not e.name.startswith("ProfilerStep")):
            ms, n = agg.get(e.name, (0.0, 0))
            agg[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return (sum(ms for ms, _ in agg.values()),
            sum(n for _, n in agg.values()),
            sorted(agg.items(), key=lambda kv: -kv[1][0]))


def profiled(torch, fn, activities):
    """(the profile of one call of fn, its host wall ms): a first call
    under the profiler warms it up and is not recorded (the profiler
    misses the first kernels of a session)."""
    from torch.profiler import profile, schedule
    with profile(activities=activities, acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            prof.step()
    return prof, wall


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


def grad_gap(got, ref):
    """(max|err|, the largest share of the elementwise limit GRAD_TOL x
    (1 + |ref|), ||err|| / ||ref|| in the Frobenius norm, median|ref|) of
    a gradient against its plain version."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    return (err.max().item(), (err / (GRAD_TOL * (1 + r.abs()))).max().item(),
            (err.norm() / r.norm()).item(), r.abs().median().item())


def grad_ok(gap) -> bool:
    """Whether a `grad_gap` reading is inside both limits (NaN is not)."""
    return gap[1] <= 1 and gap[2] <= GRAD_FRO_TOL


def show_gaps(gaps) -> str:
    """dq, dk, dv readings of `grad_gap`, for a line of output."""
    return "; ".join(
        f"{n_} max|err| {e_:.3e}, {s_:.3f} of the elementwise limit, "
        f"{f_:.3e} in the norm, median|plain| {m_:.3e}"
        for n_, (e_, s_, f_, m_) in zip(("dq", "dk", "dv"), gaps)) + (
        f" (atol = rtol = {GRAD_TOL}, norm {GRAD_FRO_TOL})")


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
# the float32 backward bodies (f32bwd at yi's shape, f32widebwd at the
# wide shape, the cluster backward at D = 512): each time over SDPA's
# float32 backward in the same run (phase 6), at most; and the float32
# forward's at the wide shape (f32wide) over SDPA's float32 forward
F32_BWD_MAX_RATIO = 1.25
F32_FWD_MAX_RATIO = 1.25
# the bfloat16 cluster backward at D = 512 over SDPA's backward, at most
BF16_CLUSTER_BWD_MAX_RATIO = 0.5
# the cluster forward at D = 512 over SDPA's forward in the same run, at
# most: float32 and bfloat16
F32_CLUSTER_FWD_MAX_RATIO = 0.8
BF16_CLUSTER_FWD_MAX_RATIO = 0.25
# the cluster bodies in walks (D = 2304, phase 6) over SDPA's forward or
# backward in the same run, at most, by kernel and dtype
WALK_MAX_RATIO = {("flash_attention", "bf16"): 0.5,
                  ("flash_attention", "f32"): 2.0,
                  ("flash_attention_bwd", "bf16"): 1.0,
                  ("flash_attention_bwd", "f32"): 2.5}
# the CUDA-core bodies the walks replaced, at the same shape on an H100
# 80GB HBM3 at 700 W (PERF.md's kernel table), printed beside, not re-run
RETIRED_D2304_MS = {("flash_attention", "f32"): 17.81,
                    ("flash_attention", "bf16"): 18.77,
                    ("flash_attention_bwd", "f32"): 154.2,
                    ("flash_attention_bwd", "bf16"): 151.2}
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
    the additions to the flash and gee_scatter rows of the kernels line,
    the backward kernel's row, and the main run's steady step ms and peak
    device bytes (for phase 9c)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config, list_archs
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as TR
    from repro_torch.models import attention as A
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
        return FlashAttentionFunction.apply(*t)

    def fn_plain(*t):
        return causal_plain(*t, C)

    def fn_library(*t):        # SDPA in its (B, H, S, D) layout
        return torch.nn.functional.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in t), is_causal=True,
            enable_gqa=True).transpose(1, 2)

    class Copying(torch.autograd.Function):
        """`FlashAttentionFunction` with the layout copies it made before
        the kernels read the model's layout in place (contiguous (B, H,
        S, D) copies of q, k, v and dO, gradients handed back as
        transposed views): timed beside it, to price the copies."""

        @staticmethod
        def forward(ctx, *t):
            t = [x.transpose(1, 2).contiguous() for x in t]
            o_, lse_ = FA.flash_attention_fwd(*t)
            ctx.save_for_backward(*t, o_, lse_)
            return o_.transpose(1, 2)

        @staticmethod
        def backward(ctx, g_):
            return tuple(x.transpose(1, 2) for x in FA.flash_attention_bwd(
                *ctx.saved_tensors, g_.transpose(1, 2).contiguous()))

    # the kernel's path must never reach the plain recompute
    plain_calls = []

    def counted_plain(*a, **k):
        plain_calls.append(1)
        return causal_plain(*a, **k)

    A.causal_plain = counted_plain
    _build.reset_launches()
    try:
        o_k, g_k = fwd_bwd(fn_kernel)
    finally:
        A.causal_plain = causal_plain
    n_fn = (_build.launches["flash_attention"],
            _build.launches["flash_attention_bwd"])
    o_p, g_p = fwd_bwd(fn_plain)
    if n_fn != (1, 1) or plain_calls:
        raise AssertionError(f"FlashAttentionFunction launched the forward "
                             f"and backward kernels {n_fn} times, expected "
                             f"(1, 1), and called causal_plain "
                             f"{len(plain_calls)} times, expected 0")
    err_o = rel(o_k, o_p)
    gaps = [grad_gap(a, b) for a, b in zip(g_k, g_p)]
    print(f"FlashAttentionFunction at B={B} S={S} H={H} KV={KV} D={D} "
          f"bf16: output max|diff| {err_o[0]:.3e} vs plain; gradients vs "
          f"autograd of the plain attention: " + show_gaps(gaps))
    if not torch.allclose(o_k.float(), o_p.float(), rtol=2e-2, atol=2e-2):
        raise AssertionError("FlashAttentionFunction output off")
    if not all(grad_ok(g_) for g_ in gaps):
        raise AssertionError(f"FlashAttentionFunction gradients off: "
                             f"{show_gaps(gaps)}")
    del o_k, o_p, g_k, g_p
    flops = 4.0 * D * B * H * S * (S + 1) / 2       # causal pairs x 4 D
    # forward, then the backward's recompute and its four products
    flops_fb = 3.5 * flops
    # bfloat16 bytes: q, k, v and dO read, o, dq, dk and dv written
    nbytes = 2 * (5 * B * H * S * D + 6 * B * KV * S * D)
    flash_add.update(
        train_fn_ms=timer(lambda: fwd_bwd(fn_kernel), 5),
        train_fn_plain_ms=timer(lambda: fwd_bwd(fn_plain), 3),
        train_fn_library_ms=timer(lambda: fwd_bwd(fn_library), 5),
        train_fn_copying_ms=timer(lambda: fwd_bwd(Copying.apply), 5),
        train_fn_bound_ms=bound_ms(nbytes, flops_fb, tensor_cores=True)[0])
    print(f"FlashAttentionFunction forward + backward (the timed call: "
          f"forward, (o.float() * w).sum(), backward): "
          f"{flash_add['train_fn_ms']:.3f} ms (both kernels, the model's "
          f"layout read in place), with the layout copies "
          f"{flash_add['train_fn_copying_ms']:.3f} ms, plain "
          f"{flash_add['train_fn_plain_ms']:.3f} ms, library (SDPA) "
          f"{flash_add['train_fn_library_ms']:.3f} ms, bound "
          f"{flash_add['train_fn_bound_ms']:.4f} ms")
    # where the timed call's time goes, in place and with the copies
    for name_, fn_ in (("in place", fn_kernel),
                       ("with the layout copies", Copying.apply)):
        prof_, wall_ = profiled(torch, lambda: fwd_bwd(fn_),
                                [ProfilerActivity.CUDA])
        busy_, n_k_, top_ = kernel_times(prof_)
        print(f"profile of the timed call, {name_}: {wall_:.3f} ms host "
              f"wall, {busy_:.3f} ms device in {n_k_} kernels: " + "; ".join(
                  f"{n_[:56]} {ms_:.4f} ms x{c_}" for n_, (ms_, c_) in top_))
        del prof_
    # the backward alone, in its (B, H, S, D) layout, from the forward
    # kernel's (o, lse): against its plain version on the same inputs,
    # two runs bit-equal, timed beside SDPA's backward (one autograd
    # call on a retained SDPA graph); then the same on the views of the
    # model's (B, S, H, D) tensors, read in place
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    dot = w.to(torch.bfloat16).transpose(1, 2).contiguous()
    o_t, lse_t = FA.flash_attention_fwd(qt, kt, vt)
    g1 = FA.flash_attention_bwd(qt, kt, vt, o_t, lse_t, dot)
    g2 = FA.flash_attention_bwd(qt, kt, vt, o_t, lse_t, dot)
    gpl = FA.flash_attention_bwd_plain(qt, kt, vt, o_t, lse_t, dot)
    if not all(same(a, b) for a, b in zip(g1, g2)):
        raise AssertionError("flash_attention_bwd at yi's shape: runs differ")
    w_bf = w.to(torch.bfloat16)
    views = [x.transpose(1, 2) for x in (q, k, v, w_bf)]
    o_v, lse_v = FA.flash_attention_fwd(*views[:3])
    gv1 = FA.flash_attention_bwd(*views[:3], o_v, lse_v, views[3])
    gv2 = FA.flash_attention_bwd(*views[:3], o_v, lse_v, views[3])
    gaps_v = [grad_gap(a, b) for a, b in zip(gv1, gpl)]
    if not (same(o_v, o_t) and same(lse_v, lse_t)
            and all(same(a, b) and same(a, c)
                    for a, b, c in zip(gv1, gv2, g1))
            and all(x.transpose(1, 2).is_contiguous() for x in (o_v, *gv1))
            and all(grad_ok(g_) for g_ in gaps_v)):
        raise AssertionError(f"flash attention on the model's (B, S, H, D) "
                             f"layout: outputs not bit-equal to the "
                             f"contiguous copies', or not in that layout, "
                             f"or {show_gaps(gaps_v)}")
    print(f"flash attention on the (B, H, S, D) views of the model's (B, S, "
          f"H, D) tensors, read in place: o, lse, dq, dk, dv bit-equal to the "
          f"contiguous copies' and between two runs, written in (B, S, H, D) "
          f"memory; vs plain {show_gaps(gaps_v)}")
    del gv1, gv2, o_v, lse_v, views
    # held by grad_gap's two limits; SDPA's backward on the same inputs
    # is read the same way, and faults made from the kernel's own
    # gradients must fail the check
    gaps = [grad_gap(a, b) for a, b in zip(g1, gpl)]
    bwd_err = max(g_[0] for g_ in gaps)
    if not all(grad_ok(g_) for g_ in gaps):
        raise AssertionError(f"flash_attention_bwd at yi's shape vs its "
                             f"plain version: {show_gaps(gaps)}")
    lib_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *lib_in, is_causal=True, enable_gqa=True)
    gaps_lib = [grad_gap(a, b) for a, b in zip(
        torch.autograd.grad(lib_out, lib_in, dot, retain_graph=True), gpl)]
    dq1, dk1, dv1 = g1
    last_tile = torch.arange(S - FA.TILES[torch.bfloat16][D][1], S,
                             device=dev)
    faults = {"dq from row 256 on zero": (0, dq1.index_fill(
                  2, torch.arange(256, S, device=dev), 0)),
              "dq x 1.02": (0, (dq1.float() * 1.02).to(dq1.dtype)),
              "dk's last key tile zero": (1, dk1.index_fill(2, last_tile, 0)),
              "dk x 1.02": (1, (dk1.float() * 1.02).to(dk1.dtype)),
              "dv's last key tile zero": (2, dv1.index_fill(2, last_tile, 0)),
              "dv x 1.02": (2, (dv1.float() * 1.02).to(dv1.dtype))}
    passed = [n_ for n_, (i_, x_) in faults.items()
              if grad_ok(grad_gap(x_, gpl[i_]))]
    print(f"flash_attention_bwd at yi's shape: kernel vs plain "
          f"{show_gaps(gaps)}; SDPA's backward vs plain "
          f"{show_gaps(gaps_lib)}; faults refused "
          f"{len(faults) - len(passed)} of {len(faults)}")
    if passed or not all(grad_ok(g_) for g_ in gaps_lib):
        raise AssertionError(f"the gradient check at yi's shape: faults "
                             f"that pass it {passed}; SDPA's backward "
                             f"{show_gaps(gaps_lib)}")
    del g1, g2, gpl, dq1, dk1, dv1, faults, last_tile
    # the least work, which the kernel does: five products over the
    # causal pairs (S, dP, dv, dk, dq)
    flops_b = 2.5 * flops
    # bfloat16 q, o, dO, k, v read and dq, dk, dv written; lse read
    nbytes_b = 2 * (4 * B * H * S * D + 4 * B * KV * S * D) + 4 * B * H * S
    bound_b, by_b = bound_ms(nbytes_b, flops_b, tensor_cores=True)
    bwd_row = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/models/attention.py:163",
        replaces_note=("no TPU kernel: the reference differentiates "
                       "attn_flash with XLA; its Pallas kernel "
                       "(src/repro/kernels/flash_attention.py:72) is "
                       "forward only"),
        shape=f"B={B} H={H} KV={KV} S={S} D={D} bf16",
        max_abs_err=bwd_err,
        ms=timer(lambda: FA.flash_attention_bwd(qt, kt, vt, o_t, lse_t,
                                                dot), 10),
        plain_ms=timer(lambda: FA.flash_attention_bwd_plain(
            qt, kt, vt, o_t, lse_t, dot), 2),
        library_ms=timer(lambda: torch.autograd.grad(
            lib_out, lib_in, dot, retain_graph=True), 10),
        bound_ms=bound_b, bound_by=by_b)
    tflops_b = flops_b / (bwd_row["ms"] * 1e-3) / 1e12
    bwd_row.update(five_product_tflops=tflops_b,
                   bound_share=bound_b / bwd_row["ms"])
    print(f"flash_attention_bwd alone at B={B} H={H} KV={KV} S={S} D={D} "
          f"bf16: {bwd_row['ms']:.4f} ms ({tflops_b:.1f} TFLOP/s over the "
          f"five products it does), bound {bound_b:.4f} ms ({by_b}; "
          f"{bwd_row['bound_share']:.3f} of it reached); plain "
          f"{bwd_row['plain_ms']:.3f} ms, library (SDPA's backward) "
          f"{bwd_row['library_ms']:.4f} ms; two runs bit-equal")
    del qt, kt, vt, dot, o_t, lse_t, lib_in, lib_out

    # FlashAttentionFunction's forward + backward under torch.profiler, on
    # leaves that require grad and a contiguous (B, S, H, D) cotangent: no
    # layout copy may run, and the device time splits by kernel
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    fn_do = w_bf.contiguous()

    def fn_fwd_bwd():
        for t in ins:
            t.grad = None
        torch.autograd.backward(FlashAttentionFunction.apply(*ins), fn_do)

    prof_fn, fn_wall = profiled(
        torch, fn_fwd_bwd, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    busy_fn, n_fn_k, top_fn = kernel_times(prof_fn)
    copies = sorted({e.name for e in prof_fn.events()
                     if e.name in ("aten::copy_", "aten::contiguous",
                                   "aten::clone")}
                    | {n_ for n_, _ in top_fn
                       if "copy" in n_.lower() or "Memcpy" in n_})
    grads_ok = all(t.grad is not None and t.grad.is_contiguous()
                   for t in ins)
    print(f"FlashAttentionFunction forward + backward under the profiler: "
          f"{fn_wall:.3f} ms host wall, {busy_fn:.3f} ms device in "
          f"{n_fn_k} kernels: " + "; ".join(
              f"{n_[:48]} {ms_:.4f} ms x{c_}" for n_, (ms_, c_) in top_fn)
          + f"; copies {copies or 'none'}; gradients in the leaves' "
          f"(B, S, H, D) layout {grads_ok}")
    if copies or not grads_ok:
        raise AssertionError(f"FlashAttentionFunction made a layout copy: "
                             f"{copies}, or its gradients are not in the "
                             f"leaves' layout ({grads_ok})")
    flash_add.update(train_fn_device_ms=busy_fn)
    del ins, fn_do, prof_fn, q, k, v, w, w_bf

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
    n_par_bwd = _build.launches["flash_attention_bwd"]
    loss_t, gt = grads("triangular")        # attn_flash's values, plain
    if (n_par, n_par_bwd) != (2 * cfg2.n_layers, cfg2.n_layers):
        raise AssertionError(f"gradient parity: flash launched {n_par} "
                             f"times forward, {n_par_bwd} backward, "
                             f"expected {2 * cfg2.n_layers} (remat) and "
                             f"{cfg2.n_layers}")
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
          f"max|g_plain| (tol {LM_REL_TOL}); flash launches {n_par}, "
          f"backward {n_par_bwd}")
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
    if launches["flash_attention_bwd"] != cfg.n_layers * steps:
        raise AssertionError(f"train path: flash_attention_bwd launched "
                             f"{launches['flash_attention_bwd']} times, "
                             f"expected {cfg.n_layers * steps} (each layer, "
                             "each step)")
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
    bwd_row["launches"] = launches["flash_attention_bwd"]
    scatter_add["train_launches"] = launches["gee_scatter"]
    measured = {"step_ms": steady, "peak_bytes": peak_gib * 2**30}
    del params, hist, prof, before, after, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8e. every family's reduced config: card vs CPU, two steps ------
    by_arch, bwd_by_arch, bwd_bodies = {}, {}, set()
    worst = (0.0, "")
    for arch in list_archs():
        cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
        route_ = FA._backward_route(torch.float32, cfg.head_dim)
        bwd_bodies.add(f"D = {cfg.head_dim}: "
                       + (f"the cluster backward at {route_[1]}"
                          if route_[0] == "cluster" else
                          f"f32bwd<{route_[1]}> {route_[0]}"))
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
        n_b = _build.launches["flash_attention_bwd"]
        want = 2 * 2 * expected_flash(cfg, 64)
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        worst = max(worst, (gap, arch))
        by_arch[arch] = n_
        bwd_by_arch[arch] = n_b
        if n_ != want or n_b != want // 2 or not gap <= FAM_TRAIN_TOL:
            raise AssertionError(f"{arch} reduced train steps: card "
                                 f"{losses['cuda']} vs cpu {losses['cpu']}"
                                 f", flash {n_} (expected {want}), "
                                 f"backward {n_b} (expected {want // 2})")
    print(f"reduced families, 2 train steps with remat, card vs CPU from "
          f"the same weights (wq, wk at 1/sqrt(d_model)): worst loss gap {worst[0]:.3e} ({worst[1]}; "
          f"tol {FAM_TRAIN_TOL}); flash launches {by_arch}; backward "
          f"{bwd_by_arch} (float32 backward body: "
          f"{', '.join(sorted(bwd_bodies))})")
    flash_add["train_launches_by_arch"] = by_arch
    bwd_row["launches_by_arch"] = bwd_by_arch
    return flash_add, scatter_add, bwd_row, measured


def shard_path(torch, dev, args, smi, phase8):
    """Phase 9 (the sharded train step and serve path, the dry run); see
    the module docstring.  `phase8`: the main training run's steady step
    ms and peak bytes.  Returns the flash row's additions."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train as TR
    from repro_torch.launch.serve import generate
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models.layers import ParamTree
    from repro_torch.sharding import (make_rules, spec_tree_shardings,
                                      use_sharding)
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import (jit_train_step,
                                                 make_train_step,
                                                 place_batch, place_tree)
    from repro_torch.training.trees import build, items

    B, S, G = args.lm_batch, args.lm_prompt, FAMILY_GEN
    on_card = dev.type == "cuda"
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=2)
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    if dist.is_initialized():
        raise AssertionError("phase 9: a process group is already up")
    kw = ({"device_id": torch.device("cuda", torch.cuda.current_device())}
          if on_card else {})
    dist.init_process_group("nccl" if on_card else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **kw)
    try:
        mesh = DeviceMesh(dev.type, [[0]], mesh_dim_names=("data", "model"))
        rules = make_rules(mesh)
        base = M.init_params(cfg, args.seed, device=dev)
        temper_attention(torch, base)

        def clone(grad):
            p_ = ParamTree(build((k, v.detach().clone())
                                 for k, v in items(base)))
            return p_.requires_grad_(grad)

        # -- 9a. jit_train_step against make_train_step, two steps -----
        t0 = time.perf_counter()
        gen_ = torch.Generator(device=dev).manual_seed(args.seed + 21)
        batches = [{"tokens": torch.randint(
            0, cfg.vocab, (B, S), generator=gen_, device=dev,
            dtype=torch.int32)} for _ in range(2)]
        opt = AdamW(lr=3e-4)
        ref = clone(True)
        st = opt.init(ref)
        step = make_train_step(cfg, opt)
        ref_losses = []
        for b_ in batches:
            ref, st, m_ = step(ref, st, b_)
            ref_losses.append(m_["loss"].item())
        del st
        sp = clone(True)
        ss = opt.init(sp)
        jstep = jit_train_step(cfg, opt, mesh, rules)
        sync()
        _build.reset_launches()
        t1 = time.perf_counter()
        sh_losses = []
        for b_ in batches:
            sp, ss, m_ = jstep(sp, ss, b_)
            sh_losses.append(full(m_["loss"]).item())
        sync()
        sharded_s = time.perf_counter() - t1
        n_train = _build.launches["flash_attention"]
        n_train_bwd = _build.launches["flash_attention_bwd"]
        want = 2 * 2 * cfg.n_layers if on_card else 0
        if (n_train, n_train_bwd) != (want, want // 2):
            raise AssertionError(f"9a: flash launched {n_train} times "
                                 f"forward, {n_train_bwd} backward in the "
                                 f"sharded steps, expected {want} and "
                                 f"{want // 2}")
        if not all(isinstance(t, DTensor) for _, t in items(sp)):
            raise AssertionError("9a: the sharded step's params are not "
                                 "DTensors")
        worst, unequal = 0.0, 0
        for (path, a), (_, b) in zip(items(ref), items(sp)):
            b = full(b)
            if not torch.equal(a, b):
                unequal += 1
                worst = max(worst, (a.float() - b.float()).abs().max().item()
                            / max(a.float().abs().max().item(), 1e-30))
        same_loss = ref_losses == sh_losses
        print(f"9a sharded train step: yi-6b width, {cfg.n_layers} layers, "
              f"remat, B={B} S={S}, mesh (data=1, model=1) on a one-rank "
              f"{dist.get_backend()} group: losses sharded {sh_losses} vs "
              f"unsharded {ref_losses} (equal: {same_loss}); leaves "
              f"bit-equal {len(list(items(ref))) - unequal} of "
              f"{len(list(items(ref)))}, worst gap {worst:.3e} of "
              f"max|leaf|; flash launches {n_train} (expected {want}), "
              f"backward {n_train_bwd}; "
              f"two sharded steps {sharded_s * 1e3:.1f} ms; wall "
              f"{time.perf_counter() - t0:.1f} s")
        gap = max(abs(a - b) / abs(a) for a, b in zip(ref_losses,
                                                      sh_losses))
        if worst > 1e-6 or gap > 1e-6:
            raise AssertionError(f"9a: sharded step off the unsharded one "
                                 f"(leaf gap {worst:.3e}, loss gap "
                                 f"{gap:.3e}; tol 1e-6)")
        out["shard_train_launches"] = n_train
        out["shard_train_bwd_launches"] = n_train_bwd
        del ref, sp, ss, batches
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # -- 9b. the serve path under use_sharding --------------------
        t0 = time.perf_counter()
        params = clone(False)
        prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen_,
                                device=dev)
        seen, seq_calls = [], [0]
        orig_decode, orig_seq = A.decode_attention, A._decode_attn_seq_sharded

        def recording(*a, **k):
            o_, c_ = orig_decode(*a, **k)
            seen.append(full(o_).float().clone())
            return o_, c_

        def counting(*a, **k):
            seq_calls[0] += 1
            return orig_seq(*a, **k)

        A.decode_attention, A._decode_attn_seq_sharded = recording, counting
        try:
            want_toks = generate(cfg, params, prompts, G)
            plain_att = list(seen)
            seen.clear()
            placed = place_tree(params, spec_tree_shardings(
                rules, M.param_specs(cfg)), mesh)
            sync()
            _build.reset_launches()
            t1 = time.perf_counter()
            # no_grad: a DTensor view cannot be taken in inference mode
            with torch.no_grad(), use_sharding(mesh, rules), \
                    implicit_replication():
                logits, cache = M.prefill(cfg, placed, place_batch(
                    {"tokens": prompts}, mesh, rules), max_len=S + G)
                n_prefill = _build.launches["flash_attention"]
                toks = full(logits).argmax(-1)
                got = [toks]
                for i in range(G - 1):
                    token = place_batch({"token": toks}, mesh, rules)
                    logits, cache = M.decode_step(cfg, placed,
                                                  token["token"], S + i,
                                                  cache)
                    toks = full(logits).argmax(-1)
                    got.append(toks)
            sync()
            serve_s = time.perf_counter() - t1
        finally:
            A.decode_attention, A._decode_attn_seq_sharded = (
                orig_decode, orig_seq)
        got_toks = torch.stack(got, 1)
        n_decode = _build.launches["flash_attention"] - n_prefill
        want_prefill = cfg.n_layers if on_card else 0
        att_gap = max((a - b).abs().max().item()
                      / max(a.abs().max().item(), 1e-30)
                      for a, b in zip(plain_att, seen))
        print(f"9b sharded serve: yi-6b width, {cfg.n_layers} layers, B={B}"
              f" prompt {S}, {G} greedy tokens under use_sharding: tokens "
              f"equal to the unsharded path's "
              f"{bool(torch.equal(got_toks, want_toks))}; seq-sharded "
              f"decode attention calls {seq_calls[0]} (expected "
              f"{cfg.n_layers * (G - 1)}); decode attention outputs "
              f"{len(seen)}, worst gap {att_gap:.3e} of max|output| (tol "
              f"{LM_REL_TOL}); flash launches prefill {n_prefill} "
              f"(expected {want_prefill}), decode {n_decode}; "
              f"{serve_s * 1e3:.1f} ms; wall {time.perf_counter() - t0:.1f} s")
        if not torch.equal(got_toks, want_toks):
            raise AssertionError(f"9b: sharded tokens {got_toks.tolist()} "
                                 f"!= unsharded {want_toks.tolist()}")
        if seq_calls[0] != cfg.n_layers * (G - 1) or \
                len(seen) != len(plain_att) or not att_gap <= LM_REL_TOL:
            raise AssertionError("9b: the seq-sharded decode did not run "
                                 "in every layer and step, or its outputs "
                                 "are off the unsharded ones")
        if n_prefill != want_prefill or n_decode:
            raise AssertionError(f"9b: flash launched {n_prefill} times in "
                                 f"prefill (expected {want_prefill}) and "
                                 f"{n_decode} in decode (expected 0)")
        out["shard_serve_launches"] = n_prefill
        del base, params, placed, cache, logits, seen, plain_att
    finally:
        dist.destroy_process_group()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- 9c. the dry run against the card: phase 8's configuration -----
    t0 = time.perf_counter()
    cfg8 = dataclasses.replace(get_config("yi-6b"),
                               n_layers=args.train_layers)
    shape8 = ShapeSpec("phase8", S, B, "train")
    rec = DR.run_cell("yi-6b", "train_4k", cfg_override=cfg8,
                      shape_override=shape8, mesh_shape=(1, 1), probe=False,
                      save=False)
    dist.destroy_process_group()
    t_dry = time.perf_counter() - t0
    params = M.init_params(cfg8, args.seed, device=dev)
    st = AdamW(state_dtype=cfg8.state_dtype).init(params)
    batch = TR.build_batch_fn(cfg8, TR.parse_args([
        "--arch", "yi-6b", "--batch", str(B), "--seq", str(S), "--seed",
        str(args.seed)]), dev)(0)
    held = sum(t.numel() * t.element_size() for tree in
               (params, st.m, st.v, batch) for _, t in items(tree))
    del params, st, batch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    pred = rec["arg_bytes"] + rec["temp_bytes"]
    ratio = phase8["step_ms"] / (rec["step_s"] * 1e3)
    print(f"9c dry run at phase 8's configuration (yi-6b width, "
          f"{cfg8.n_layers} layers, B={B} S={S}, one rank): argument bytes "
          f"predicted {rec['arg_bytes']:,} vs held on the card {held:,} "
          f"(equal: {rec['arg_bytes'] == held}); predicted argument + "
          f"temporary {pred / 2**30:.2f} GiB vs phase 8's measured peak "
          f"{phase8['peak_bytes'] / 2**30:.2f} GiB; roofline step "
          f"{rec['step_s'] * 1e3:.1f} ms ({rec['dominant']}: compute "
          f"{rec['compute_s'] * 1e3:.1f}, memory {rec['memory_s'] * 1e3:.1f},"
          f" collective {rec['collective_s'] * 1e3:.1f}) vs phase 8's step "
          f"{phase8['step_ms']:.1f} ms: measured / predicted {ratio:.2f}; "
          f"trace {rec['compile_s']:.1f} s, wall "
          f"{time.perf_counter() - t0:.1f} s (dry run {t_dry:.1f}); card "
          f"{smi}")
    if rec["arg_bytes"] != held:
        raise AssertionError("9c: the dry run's argument bytes differ from "
                             "what the card holds")

    # -- 9d. the production dry run, on the host -----------------------
    t0 = time.perf_counter()
    try:
        cell = DR.run_cell("yi-6b", "train_4k", save=False)
        print(f"9d run_cell yi-6b train_4k on {cell['chips']} ranks: "
              f"{time.perf_counter() - t0:.1f} s host (trace "
              f"{cell['compile_s']:.1f} s, probes {cell['probe_s']:.1f} s); "
              f"flops/dev {cell['flops_per_device']:.4e} (probe "
              f"{cell['probe']['flops']:.4e})")
        for mode in DR.GEE_MODES:
            t1 = time.perf_counter()
            DR.run_gee(mode=mode, save=False)
            print(f"9d run_gee {mode}: {time.perf_counter() - t1:.1f} s host")
    finally:
        dist.destroy_process_group()
    print(f"9d wall {time.perf_counter() - t0:.1f} s")
    return out


def profile_refit(torch, emb, mode):
    """One more refit of `emb` under torch.profiler: prints its wall
    time, the device's busy time and idle share, the kernels that take
    most of it and the host operations that take most of the host's
    time; returns (wall ms, busy ms)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        emb.refit()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n_dev, top = kernel_times(prof)
    print(f"profile distributed:{mode} refit: wall {wall:.1f} ms under the "
          f"profiler, device busy {busy:.1f} ms in {n_dev} kernels and "
          f"copies, idle share {1 - busy / wall:.3f}; by kernel: "
          + "; ".join(f"{n_[:48]} {ms_:.2f} ms x{c_}"
                      for n_, (ms_, c_) in top[:6]))
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(f"profile distributed:{mode} refit, host self time by op: "
          + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ms "
                      f"x{e.count}" for e in host[:8]))
    return wall, busy


def distributed_path(torch, dev, g, Y, Z_cuda):
    """Phase 5d: distributed GEE (`repro_torch.core.distributed`) on
    the main path's graph in a one-rank NCCL group, every mode held
    to phase 3's cuda fit `Z_cuda` (numpy); returns its figures for
    the summary.  Its tensors and its group are gone when it
    returns."""
    from repro_torch.core import distributed as D
    from repro_torch.encoder import Embedder, EncoderConfig
    from repro_torch.encoder.backends import resolve_auto
    from repro_torch.graph import Graph

    n, K = g.n, Z_cuda.shape[1]
    Zc = torch.as_tensor(Z_cuda, device=dev)
    mesh = D.edge_mesh(dev.type)
    backend = str(torch.distributed.get_backend())
    print(f"phase 5d: a {mesh.size()}-rank {backend} group")
    if mesh.size() != 1 or ("nccl" if dev.type == "cuda"
                            else "gloo") not in backend:
        raise AssertionError("phase 5d: expected a one-rank NCCL group")
    out = {}

    def err(Z):
        return (torch.as_tensor(Z, device=dev) - Zc).abs().max().item()

    try:
        for mode in ("replicated", "reduce_scatter", "a2a", "ring"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            emb = Embedder(EncoderConfig(K=K),
                           backend=f"distributed:{mode}", device=dev,
                           mesh=mesh)
            t0 = time.perf_counter()
            emb.plan(g)
            torch.cuda.synchronize()
            t_plan = time.perf_counter() - t0
            t0 = time.perf_counter()
            emb.fit(g, Y)
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t0
            e_fit, info = err(emb.Z_), dict(emb.last_info_)
            t0 = time.perf_counter()
            emb.refit()
            torch.cuda.synchronize()
            t_refit = time.perf_counter() - t0
            e_refit = err(emb.Z_)
            peak = torch.cuda.max_memory_allocated() / 2**30
            cf = emb._plan.data["capacity_factor"]
            print(f"distributed:{mode}: plan {t_plan:.2f} s (capacity "
                  f"factor {cf:.4f}), fit {t_fit:.2f} s, refit "
                  f"{t_refit * 1e3:.1f} ms, peak device memory "
                  f"{peak:.2f} GiB; max|Z - Z_cuda| fit {e_fit:.3e}, "
                  f"refit {e_refit:.3e}; dropped {info['dropped']}; "
                  f"plan stats {emb.plan_stats}")
            if (info["dropped"] or emb.last_info_["dropped"]
                    or not e_fit <= 1e-5 or not e_refit <= 1e-5):
                raise AssertionError(f"distributed:{mode} off the cuda "
                                     f"fit or dropping")
            out[mode] = dict(plan_s=t_plan, fit_s=t_fit,
                             refit_ms=t_refit * 1e3, peak_gib=peak)
            if mode == "reduce_scatter":
                out["refit_profile"] = profile_refit(torch, emb, mode)
            del emb
            gc.collect()
            torch.cuda.empty_cache()
        # the steady-state a2a from host buckets
        t0 = time.perf_counter()
        b_dst, b_src, b_w, n_pad = D.prebucket_host(g, 1)
        t_bucket = time.perf_counter() - t0
        Y_pad = np.full(n_pad, -1, np.int32)
        Y_pad[:n] = Y
        slabs = [torch.as_tensor(a[0], device=dev)
                 for a in (b_dst, b_src, b_w)]
        del b_dst, b_src, b_w
        Y_t = torch.as_tensor(Y_pad, device=dev)
        D.gee_a2a_steady(*slabs, Y_t, K=K, n_pad=n_pad, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Zs, dropped = D.gee_a2a_steady(*slabs, Y_t, K=K, n_pad=n_pad,
                                       mesh=mesh)
        torch.cuda.synchronize()
        t_steady = time.perf_counter() - t0
        e_steady = err(Zs[:n])
        del slabs, Zs, Y_t
        print(f"gee_a2a_steady: prebucket_host {t_bucket:.2f} s, embed "
              f"{t_steady * 1e3:.1f} ms, max|Z - Z_cuda| "
              f"{e_steady:.3e}")
        if int(dropped) or not e_steady <= 1e-5:
            raise AssertionError("gee_a2a_steady off the cuda fit")
        # the Laplacian through the ring, against the cuda backend's fit
        # of the Laplacian-scaled weights (`effective_weights`' float64
        # math, its degrees summed on the card: the host's np.add.at
        # over 2 s contributions takes tens of seconds)
        del Zc
        gc.collect()
        torch.cuda.empty_cache()
        u_t = torch.as_tensor(g.u, device=dev).long()
        v_t = torch.as_tensor(g.v, device=dev).long()
        w64 = torch.as_tensor(g.w, device=dev).double()
        deg = torch.bincount(torch.cat([u_t, v_t]),
                             weights=torch.cat([w64, w64]), minlength=n)
        scale = 1.0 / torch.sqrt(torch.clamp_min(deg, 1.0))
        w_eff = (w64 * scale[u_t] * scale[v_t]).float().cpu().numpy()
        del u_t, v_t, w64, deg, scale
        Zl_ref = Embedder(EncoderConfig(K=K), backend="cuda",
                          device=dev).fit(Graph(g.u, g.v, w_eff, n), Y).Z_
        del w_eff
        t0 = time.perf_counter()
        Zl, dl = D.gee_distributed(g, Y, K=K, mode="ring", mesh=mesh,
                                   laplacian=True)
        t_lap = time.perf_counter() - t0
        e_lap = (torch.as_tensor(Zl, device=dev) - Zl_ref).abs().max(
            ).item()
        del Zl, Zl_ref
        print(f"Laplacian through the ring: {t_lap:.2f} s, max|Z - "
              f"Z_cuda(laplacian)| {e_lap:.3e}, dropped {dl}")
        if dl or not e_lap <= 1e-5:
            raise AssertionError("the Laplacian ring is off the cuda "
                                 "backend's Laplacian fit")
        auto = resolve_auto(n, g.s, mesh=mesh)
        want = resolve_auto(n, g.s, device_kind=dev.type, device_count=1)
        print(f"backend='auto' under the one-rank mesh: {auto}")
        if auto != want:
            raise AssertionError(f"auto under the mesh gave {auto}, "
                                 f"expected {want}")
        out.update(prebucket_s=t_bucket, steady_ms=t_steady * 1e3,
                   laplacian_ring_s=t_lap, auto=auto)
    finally:
        D.destroy_local_group()
    if torch.distributed.is_initialized():
        raise AssertionError("phase 5d left a process group behind")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tune_path(torch, dev, n, s, m_topk, scatter_bound_bytes):
    """Phase "tune": `launch.autotune` at the main path's shapes; the
    tuned geometry beside the defaults.  Returns the figures."""
    from repro_torch.launch import autotune as AT

    sc = AT.tune_scatter(n, s, 16, iters=21, device=dev)
    tk = AT.tune_topk(m_topk, 16, 64, 10, iters=21, device=dev)
    out = {}
    for what, r_ in (("gee_scatter tile_n", sc),
                     ("topk_fused select grid (max_grid)", tk)):
        b_, d_ = r_["best_point"], r_["default_point"]
        print(f"tune {what}: best {b_['cfg']} {b_['seconds'] * 1e3:.4f} "
              f"ms ({b_['bound_share']:.3f} of its {b_['bound_by']} "
              f"bound {b_['bound_s'] * 1e3:.4f} ms), default "
              f"{d_['cfg']} {d_['seconds'] * 1e3:.4f} ms "
              f"({d_['bound_share']:.3f}); points "
              + ", ".join(f"{list(c.values())[0]}: {t * 1e3:.4f}"
                          for c, t in r_["trace"]))
        out[what.split()[0]] = dict(best=b_, default=d_)
    moved = sc["default_point"]["moved_bytes"]
    print(f"tune: the scatter's byte model at tile_n = 256 moves "
          f"{moved:,} bytes; the kernel table's bound counts "
          f"{scatter_bound_bytes:,}")
    if moved != scatter_bound_bytes:
        raise AssertionError("the tuner's scatter byte model differs "
                             "from the kernel table's bound")
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
    from repro_torch.launch import roofline as RL
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
        c7520 = [ln.strip() for ln in
                 _build.ptxas_log["flash_attention"].splitlines()
                 if "C7520" in ln]
        fwd_c7520 = [ln for ln in c7520 if "flash_fwd_bf16_kernel" in ln]
        for ln in c7520:
            print(f"ptxas C7520 (wgmma serialized): {ln}")
        print(f"ptxas: {len(fwd_c7520)} C7520 warnings in the bfloat16 "
              f"forward bodies, {len(c7520) - len(fwd_c7520)} elsewhere")
        spills = ptxas_spills(_build.ptxas_log["flash_attention"])
        # the walks' instantiations (<CL = true, WALKS = true>, mangled
        # ILb1ELb1E) run above D = 2048 only: their spills are printed
        walks = {f: n for f, n in spills.items() if "ILb1ELb1E" in f}
        spills = {f: n for f, n in spills.items() if f not in walks}
        print(f"ptxas: the walks' instantiations spill "
              f"{sorted(walks.values())} bytes (stores + loads)")
        if len(walks) != 4:
            raise AssertionError(f"ptxas: {len(walks)} walks' "
                                 f"instantiations, 4 expected: {walks}")
        bf16 = {f: n for f, n in spills.items()
                if any(k_ in f for k_ in ("flash_fwd_bf16_kernel",
                                          "flash_bwd_kernel"))}
        # the forward: per D <= 128 one body at its own width and one at a
        # runtime narrower width, and danube's 120 on D = 128 (its own
        # body: `launch.fwd_ablate` times it against the runtime width's),
        # and the D = 256 body (any width) and its cluster forward; the
        # backward one per D <= 128 and the D = 256 body (any width) and
        # its cluster backward
        if len(bf16) != 17 or any(bf16.values()):
            raise AssertionError(f"ptxas spill bytes of the bfloat16 flash "
                                 f"bodies (17 expected: forward 11, "
                                 f"backward 6; all 0): {bf16}")
        print("ptxas: the 17 bfloat16 flash bodies (forward 10 and the "
              "cluster forward, backward 5 and the cluster backward) spill "
              "0 bytes")
        # the float32 backward body, one per D <= 128
        f32b = {f: n for f, n in spills.items()
                if "flash_bwd_f32_kernel" in f}
        if len(f32b) != 4 or any(f32b.values()):
            raise AssertionError(f"ptxas spill bytes of the float32 "
                                 f"backward bodies (4 expected, all 0): "
                                 f"{f32b}")
        print("ptxas: the 4 float32 backward bodies (f32bwd, D = 16, 32, "
              "64, 128) spill 0 bytes")
        # the float32 bodies at D = 256, forward and backward, and their
        # cluster instantiations
        f32w = {f: n for f, n in spills.items() if "f32_wide_kernel" in f}
        if len(f32w) != 4 or any(f32w.values()):
            raise AssertionError(f"ptxas spill bytes of the float32 D = 256 "
                                 f"bodies (4 expected, all 0): {f32w}")
        print("ptxas: the float32 D = 256 bodies (f32wide, f32widebwd and "
              "their cluster bodies) spill 0 bytes")
        if c7520:
            raise AssertionError(f"ptxas serialized the wgmma of a flash "
                                 f"body (C7520): {c7520}")
    if "query_fused" in _build.ptxas_log:         # built in this run
        dspill = {f: n for f, n in ptxas_spills(
            _build.ptxas_log["query_fused"]).items()
            if "delta_renorm_kernel" in f}
        if len(dspill) != 1 or any(dspill.values()):
            raise AssertionError(f"ptxas spill bytes of delta_renorm_kernel "
                                 f"(one body, 0 expected): {dspill}")
        print("ptxas: delta_renorm_kernel (one body for every K) spills 0 "
              "bytes")
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
        # the plain version's additions in list order and its norms: the
        # same bits
        if not same(a[0], p[0]):
            raise AssertionError(f"gee_delta_renorm {what}: Z_new is not "
                                 "the plain version's bit for bit")
        if not same(a[1], p[1]):
            raise AssertionError(f"gee_delta_renorm {what}: Zn is not "
                                 "the plain version's bit for bit")
        # the kernel's Zn is exactly normalize_rows of its own Z_new
        if not same(a[1], QF.normalize_rows(a[0])):
            raise AssertionError(f"gee_delta_renorm {what}: Zn is not "
                                 "normalize_rows(Z_new) bit for bit")
        return max((a[0] - p[0]).abs().max().item(),
                   (a[1] - p[1]).abs().max().item()) if Z.numel() else 0.0

    def delta_sweep(r_t, c_t, v_t, gen_, n_local=1 << 20,
                    widths=(16, 64, 128, 129, 172, 200, 256, 512)):
        """gee_delta_renorm at n_local rows of each width: the real
        delta's entries below n_local, classes mod K; each K held
        bit-equal to the plain version, timed (kernel and library with
        the calls queued behind a spin kernel: the device's time alone;
        plain back to back) beside its byte bound, with the launcher's
        plan.  Returns {"sweep": [...]} for the kernels line."""
        keep = r_t < n_local
        rs, vs = r_t[keep], v_t[keep]
        out = []
        for Kd in widths:
            cs = c_t[keep] % Kd
            Zd = torch.rand((n_local, Kd), generator=gen_, device=dev)
            err_d = check_delta(Zd, rs, cs, vs, f"sweep K={Kd}")

            def lib_d():
                Zx = Zd.clone().index_put_((rs.long(), cs.long()), vs,
                                           accumulate=True)
                return torch.nn.functional.normalize(Zx, dim=1, eps=1e-9)

            row = dict(
                K=Kd, n_local=n_local, m=int(rs.shape[0]),
                ms=timer(lambda: QF.gee_delta_renorm(Zd, rs, cs, vs), 10,
                         queue_ahead=True),
                bound_ms=bound_ms(3 * Zd.numel() * 4 + rs.shape[0] * 12,
                                  rs.shape[0])[0],
                plain_ms=timer(lambda: QF.gee_delta_renorm_plain(
                    Zd, rs, cs, vs), 2),
                library_ms=timer(lib_d, 5, queue_ahead=True),
                max_abs_err=err_d, plan=QF.delta_info(Zd))
            row["kernel_over_library"] = row["ms"] / row["library_ms"]
            row["bound_over_kernel"] = row["bound_ms"] / row["ms"]
            pl = row["plan"]
            print(f"gee_delta_renorm sweep K={Kd} (n_local={n_local}, "
                  f"{row['m']} entries): kernel {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms, bound / kernel "
                  f"{row['bound_over_kernel']:.3f}, library "
                  f"{row['library_ms']:.4f} ms, kernel / library "
                  f"{row['kernel_over_library']:.3f}, plain "
                  f"{row['plain_ms']:.2f} ms; plan: {pl['rows']} rows a "
                  f"tile, {pl['stages']} stages of {pl['stage_bytes']} B, "
                  f"pitch {pl['kp']}, {pl['smem']} B a block, "
                  f"{pl['blocks_per_sm']} blocks an SM, grid {pl['grid']} "
                  f"over {pl['tiles']} tiles")
            out.append(row)
            del Zd
        return {"sweep": out}

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

    def check_flash_bwd(q, k, v, what):
        """The forward with lse (the same output bits, lse within 1e-5 of
        the dense oracle's), then the backward twice (the same bits)
        against its plain version on the same (o, lse) and a random dO,
        at the forward's tolerance (atol and rtol)."""
        o, lse = FA.flash_attention_fwd(q, k, v)
        _, plse = FA.flash_attention_plain(q, k, v, return_lse=True)
        do = torch.as_tensor(rng.normal(size=tuple(q.shape)).astype(
            np.float32), device=dev).to(q.dtype)
        a = FA.flash_attention_bwd(q, k, v, o, lse, do)
        b = FA.flash_attention_bwd(q, k, v, o, lse, do)
        p = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        if not same(o, FA.flash_attention(q, k, v)):
            raise AssertionError(f"flash_attention_fwd {what}: output "
                                 "differs from flash_attention's")
        if not torch.allclose(lse, plse, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"flash_attention_fwd {what}: lse max|err| "
                                 f"{(lse - plse).abs().max().item()}")
        tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
        for n_, x, y, z in zip(("dq", "dk", "dv"), a, b, p):
            if not same(x, y) or x.dtype != q.dtype:
                raise AssertionError(f"flash_attention_bwd {what}: {n_} "
                                     "runs differ or dtype off")
            if not torch.allclose(x.float(), z.float(), rtol=tol, atol=tol):
                raise AssertionError(
                    f"flash_attention_bwd {what}: {n_} max|err| "
                    f"{(x.float() - z.float()).abs().max().item()}")

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
    # the widths outside the main path's bodies: the delta kernel at
    # K = 200 (20 rows a tile) and at K = 20,000 (a row too wide for three
    # stages: its chunks, twice), top-k's chunked body (K > 256), its long
    # lists (k > 64) and its general path (k > 4096)
    Zw = torch.as_tensor(rng.random((700, 200), dtype=np.float32),
                         device=dev)
    rw = np.sort(rng.integers(0, 700, 600)).astype(np.int32)
    check_delta(Zw, torch.as_tensor(rw, device=dev),
                torch.as_tensor(rng.integers(0, 4, 600).astype(np.int32),
                                device=dev),
                torch.as_tensor(rng.random(600, dtype=np.float32),
                                device=dev), "K=200")
    Zc = torch.as_tensor(rng.normal(size=(64, 20000)).astype(np.float32),
                         device=dev)
    rc = np.sort(rng.integers(0, 64, 800)).astype(np.int32)
    check_delta(Zc, torch.as_tensor(rc, device=dev),
                torch.as_tensor(rng.integers(0, 20000, 800).astype(np.int32),
                                device=dev),
                torch.as_tensor(rng.random(800, dtype=np.float32) - 0.5,
                                device=dev), "K=20000")
    pc = QF.delta_info(Zc)
    print(f"gee_delta_renorm K=20000 (64 rows, 800 entries): bit-equal to "
          f"the plain version; {pc['chunks']} chunks a row, "
          f"{pc['tiles']} tiles, grid {pc['grid']}")
    del Zc
    for Kw, mw, kw_ in ((300, 5000, 10), (16, 20000, 100), (300, 40, 100),
                        (16, 6000, 4100)):
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
        # D > 128: up to 256 each dtype's D = 256 body, 160 and 192 read in
        # place (the tensor-core bodies at bfloat16, f32wide and
        # f32widebwd at float32), at D = 512 the cluster bodies (ragged S)
        (1, 4, 2, 100, 160), (1, 4, 2, 130, 192), (2, 8, 2, 130, 256),
        (1, 2, 1, 70, 512),
        # above 256 the cluster forward and backward: a ragged last slice
        # (320) and three blocks a cluster (768); above 2048 in walks: two
        # of five blocks (2112) and three of six (4160)
        (1, 4, 2, 100, 320), (1, 4, 1, 130, 768), (1, 2, 1, 70, 2112),
        (1, 2, 1, 70, 4160))
        for dt in (torch.float32, torch.bfloat16)]
    # float32 only: the float32 backward body (f32bwd) at D = 96, zero-padded
    # to its D = 128, and at a ragged S against its 64-key items
    flash_cases += [((2, 4, 1, 333, 96), torch.float32),
                    ((1, 8, 2, 1000, 64), torch.float32)]
    flash_cases += [((1, lm.n_heads, lm.n_kv_heads, 2049, lm.head_dim),
                     torch.bfloat16),
                    ((args.lm_batch, lm.n_heads, lm.n_kv_heads,
                      args.lm_prompt - 1, lm.head_dim), torch.bfloat16)]
    for (B_, H_, KV_, S_, D_), dt in flash_cases:
        want_ = "cluster" if D_ > 256 else None
        if want_ and FA._backward_route(dt, D_)[0] != want_:
            raise AssertionError(f"flash_attention_bwd at D = {D_} {dt}: "
                                 f"route {FA._backward_route(dt, D_)}, not "
                                 f"{want_}")
        want_f = "cluster" if D_ > 256 else None
        if want_f and FA._forward_route(dt, D_)[0] != want_f:
            raise AssertionError(f"flash_attention at D = {D_} {dt}: route "
                                 f"{FA._forward_route(dt, D_)}, not "
                                 f"{want_f}")
        qkv = [torch.as_tensor(rng.normal(size=(B_, h_, S_, D_)).astype(
            np.float32), device=dev).to(dt) for h_ in (H_, KV_, KV_)]
        check_flash(*qkv, f"B={B_} H={H_} KV={KV_} S={S_} D={D_} {dt}")
        check_flash_bwd(*qkv, f"B={B_} H={H_} KV={KV_} S={S_} D={D_} {dt}")
        del qkv
    print(f"small-shape kernel checks: ok ({len(flash_cases)} flash cases, "
          f"each forward and backward)")

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
            bound_bytes=8 * S + 8 * row_ptr.numel() + z_bytes,
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
            # one FMUL and one FADD per term (no FFMA: common.cuh), at
            # the fp32 rate's instructions a second (it counts an FMA as
            # two operations)
            issue_floor_ms=2.0 * nq * m * K / (RL.FP32_FLOPS / 2) * 1e3,
            shape=f"m={m} nq={nq} k={k} K={K} select grid "
                  f"{cand[0].shape[1]} blocks"))
        del cand
        # the bodies outside the k = 10 main shape: long lists (k = 100
        # on shard 0's rows, the register body) and wide rows (K = 300 on
        # 262,144 random unit rows, k = 10, the chunked body)
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
        # which select body each launch took, and the times side by side
        for tag, rows_, k_ in (("wide_k100", Zn0, 100), ("wide_K300", Zw, k)):
            info = QF.select_info(rows_, k=k_, nq=nq)
            wide[f"{tag}_body"] = info["body"]
            ms_, b_, lib_ = (wide[f"{tag}{x}"] for x in
                             ("_ms", "_bound_ms", "_library_ms"))
            print(f"topk_fused {tag[5:]} (m={rows_.shape[0]} "
                  f"K={rows_.shape[1]} nq={nq} k={k_}): body {info['body']}"
                  f" (group {info['group']}, tile {info['tile']}, slots "
                  f"{info['cap']}, chunk {info['chunk']}, smem "
                  f"{info['smem']} B); kernel {ms_:.4f} ms, bound "
                  f"{b_:.4f} ms, library {lib_:.4f} ms; kernel / library "
                  f"{ms_ / lib_:.3f}, bound / kernel {b_ / ms_:.3f}")
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
            # the calls queued behind a spin kernel: the device's time alone
            device_ms=timer(lambda: QF.gee_delta_renorm(Z0, r_t, c_t, v_t),
                            10, queue_ahead=True),
            plan=QF.delta_info(Z0),
            shape=f"n_local={nl} m={r_t.shape[0]} K={K}"))
        print(f"gee_delta_renorm at shard 0 (n_local={nl} K={K}, "
              f"{r_t.shape[0]} entries): kernel {results[-1]['ms']:.4f} ms "
              f"back to back, {results[-1]['device_ms']:.4f} ms on the "
              f"device alone, bound {b:.4f} ms, bound / kernel "
              f"{b / results[-1]['device_ms']:.3f}, library "
              f"{results[-1]['library_ms']:.4f} ms; the launcher's plan "
              f"{results[-1]['plan']}")
        # K = 200 (20 rows a tile) on 262,144 rows, with the same delta's
        # contributions
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
        results[-1].update(delta_sweep(r_t, c_t, v_t, gen_))
        return results, (g, truth, Y), Z_fit.cpu().numpy()

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

    def sdpa_backend(fn):
        """(the SDPA backend one call of fn runs, its kernels' names) from
        a profile of the call: "cudnn", "efficient" (the memory-efficient
        kernels), "flash", or "math" (no fused attention kernel: matrix
        products and a softmax)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof_:
            fn()
            torch.cuda.synchronize()
        names = [n_ for n_, _ in kernel_times(prof_)[2]]
        low = " ".join(names).lower()
        backend = ("cudnn" if "cudnn" in low else
                   "efficient" if ("fmha" in low or "attention_kernel" in low
                                   or "mem_eff" in low) else
                   "flash" if "flash" in low else "math")
        return backend, names

    def d512_path(B, forward=True):
        """Both dtypes at D = 512 (B x 8 query heads over 2 KV heads, S =
        --lm-prompt): the forward on the cluster forward and the backward
        on the cluster backward (two blocks a cluster, each its dtype's
        D = 256 body on 256 columns, with the launchers' C, items and
        clusters): each timed beside SDPA's (in turns; the backend it
        picks read from a profile) and its bound, fp32 operations at
        float32 and tensor-core operations at bfloat16; the forward held
        to its plain version (check_flash: 2e-5 at float32, 2e-2 at
        bfloat16, two runs bit-equal) and its time at most
        F32_CLUSTER_FWD_MAX_RATIO x SDPA's float32 forward and
        BF16_CLUSTER_FWD_MAX_RATIO x SDPA's bfloat16 forward; the
        backward's two runs bit-equal, held at float32 to the plain
        version in float64 at atol = rtol = 2e-5 and at bfloat16 to the
        plain version at the forward's tolerance, and its time at most
        F32_BWD_MAX_RATIO x SDPA's float32 backward and
        BF16_CLUSTER_BWD_MAX_RATIO x SDPA's bfloat16 backward.  With
        forward=False (the run at B = --lm-batch) both are timed and
        printed, not held.  Returns the flash row's `wide_D512_*` and
        `wide_bwd_D512_*` entries (at B = --lm-batch `wide_D512_B<B>_*`
        and `wide_bwd_D512_B<B>_*` ones)."""
        S, H, KV, D = args.lm_prompt, 8, 2, 512
        gen_ = torch.Generator(device=dev).manual_seed(args.seed + 512 + B)
        flops = 4.0 * D * B * H * S * (S + 1) / 2
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out = {}
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, do = (torch.randn((B, H, S, D), generator=gen_, device=dev,
                                 dtype=dt) for _ in range(2))
            k, v = (torch.randn((B, KV, S, D), generator=gen_, device=dev,
                                dtype=dt) for _ in range(2))
            esz, tc = q.element_size(), dt == torch.bfloat16
            fp = f"wide_D512_{tag}"
            bp = (f"wide_bwd_D512_{tag}" if forward else
                  f"wide_bwd_D512_B{B}_{tag}")
            row = {}
            # the forward: the cluster forward, C blocks a cluster
            froute_ = FA._forward_route(dt, D)
            fsch_ = FA._fwd_schedule(B, H, S, D, dev, dt)
            if froute_[0] != "cluster":
                raise AssertionError(f"flash_attention at D = 512 {dt}: "
                                     f"route {froute_}, not cluster")
            fbody_ = (f"{'Fwd<256>' if tc else 'f32wide'} x {fsch_['C']} "
                      f"a cluster")
            err = None
            if forward:
                err = check_flash(q, k, v, f"D=512 {dt}")   # two runs equal
            else:
                fp = f"wide_D512_B{B}_{tag}"

            def fwd():
                return FA.flash_attention(q, k, v)

            def fwd_sdpa():
                return sdpa(q, k, v, is_causal=True, enable_gqa=True)

            f1, l1 = timer(fwd, 20, warm=3), timer(fwd_sdpa, 3)
            l2, f2 = timer(fwd_sdpa, 3), timer(fwd, 20, warm=3)
            be_f, names_f = sdpa_backend(fwd_sdpa)
            row.update({
                f"{fp}_ms": (f1 + f2) / 2,
                f"{fp}_bound_ms": bound_ms(
                    esz * (2 * B * H * S * D + 2 * B * KV * S * D),
                    flops, tensor_cores=tc)[0],
                f"{fp}_library_ms": (l1 + l2) / 2,
                f"{fp}_library_backend": be_f,
                f"{fp}_body": fbody_,
                f"{fp}_C": fsch_["C"], f"{fp}_items": fsch_["items"],
                f"{fp}_clusters": fsch_["clusters"]})
            if forward:
                row[f"{fp}_plain_ms"] = timer(
                    lambda: FA.flash_attention_plain(q, k, v), 2)
                row[f"{fp}_max_abs_err"] = err
            ms_ = row[f"{fp}_ms"]
            fratio_ = ms_ / row[f"{fp}_library_ms"]
            flimit_ = (BF16_CLUSTER_FWD_MAX_RATIO if tc else
                       F32_CLUSTER_FWD_MAX_RATIO)
            print(f"flash_attention ({fbody_}) at B={B} H={H} KV={KV} "
                  f"S={S} D={D} {dt}: kernel {f1:.4f} / {f2:.4f} ms, "
                  f"SDPA {l1:.4f} / {l2:.4f} ms (backend {be_f}: "
                  f"{'; '.join(n_[:48] for n_ in names_f[:3])}), kernel "
                  f"/ library {fratio_:.3f} (at most {flimit_}"
                  f"{'' if forward else ', not held here'}), bound "
                  f"{row[f'{fp}_bound_ms']:.4f} ms, share of the bound "
                  f"{row[f'{fp}_bound_ms'] / ms_:.4f}; the launcher's "
                  f"schedule: {fsch_['items']} items of {fsch_['rows']} rows "
                  f"x {fsch_['keys']}-key tiles on {fsch_['clusters']} "
                  f"clusters of C = {fsch_['C']} blocks (grid "
                  f"{fsch_['grid']})"
                  + (f"; plain {row[f'{fp}_plain_ms']:.3f} ms, max|err| "
                     f"vs plain {err:.3e} (atol = rtol = "
                     f"{2e-2 if tc else 2e-5} held), two runs bit-equal"
                     if forward else ""))
            if forward and fratio_ > flimit_:
                raise AssertionError(f"flash_attention at D = 512 {dt} "
                                     f"takes {fratio_:.3f} x SDPA's forward, "
                                     f"above {flimit_}")
            o, lse = FA.flash_attention_fwd(q, k, v)
            route_ = FA._backward_route(dt, D)
            sch_ = FA._bwd_schedule(B, KV, S, D, dev, dt)
            body_ = (f"{'widebwd' if tc else 'f32widebwd'} x {sch_['C']} "
                     f"a cluster ({route_[0]})")
            ga = FA.flash_attention_bwd(q, k, v, o, lse, do)
            gb = FA.flash_attention_bwd(q, k, v, o, lse, do)
            if not all(same(x_, y_) for x_, y_ in zip(ga, gb)):
                raise AssertionError(f"flash_attention_bwd at D = 512 {dt} "
                                     f"B={B}: two runs differ")
            err_b = None
            if forward:
                if tc:
                    gp = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
                    tol_, how = 2e-2, "the plain version"
                else:
                    gp = FA.flash_attention_bwd_plain(
                        *(x.double() for x in (q, k, v, o, lse, do)))
                    tol_, how = 2e-5, "the float64 plain version"
                for n_, x_, z_ in zip(("dq", "dk", "dv"), ga, gp):
                    if not torch.allclose(x_.to(z_.dtype), z_, rtol=tol_,
                                          atol=tol_):
                        raise AssertionError(
                            f"flash_attention_bwd at D = 512 {dt}: {n_} "
                            f"max|err| "
                            f"{(x_.to(z_.dtype) - z_).abs().max().item()} "
                            f"from {how}, outside atol = rtol = {tol_}")
                err_b = max((x_.to(z_.dtype) - z_).abs().max().item()
                            for x_, z_ in zip(ga, gp))
                del gp
            del ga, gb
            lib_in = [x.detach().requires_grad_() for x in (q, k, v)]
            lib_out = sdpa(*lib_in, is_causal=True, enable_gqa=True)

            def bwd():
                return FA.flash_attention_bwd(q, k, v, o, lse, do)

            def bwd_sdpa():
                return torch.autograd.grad(lib_out, lib_in, do,
                                           retain_graph=True)

            b1, bl1 = timer(bwd, 3), timer(bwd_sdpa, 2)
            bl2, b2 = timer(bwd_sdpa, 2), timer(bwd, 3)
            be_b, names_b = sdpa_backend(bwd_sdpa)
            row.update({
                f"{bp}_ms": (b1 + b2) / 2,
                f"{bp}_bound_ms": bound_ms(
                    esz * (4 * B * H * S * D + 4 * B * KV * S * D)
                    + 4 * B * H * S, 2.5 * flops, tensor_cores=tc)[0],
                f"{bp}_library_ms": (bl1 + bl2) / 2,
                f"{bp}_library_backend": be_b,
                f"{bp}_body": body_,
                f"{bp}_C": sch_["C"], f"{bp}_items": sch_["items"],
                f"{bp}_clusters": sch_["clusters"]})
            if forward:
                row[f"{bp}_plain_ms"] = timer(
                    lambda: FA.flash_attention_bwd_plain(q, k, v, o, lse,
                                                         do), 1)
                row[f"{bp}_max_abs_err"] = err_b
            ms_ = row[f"{bp}_ms"]
            ratio_ = ms_ / row[f"{bp}_library_ms"]
            limit_ = F32_BWD_MAX_RATIO if not tc else \
                BF16_CLUSTER_BWD_MAX_RATIO
            by = "fp32 operations" if not tc else "bf16 tensor-core operations"
            print(f"flash_attention_bwd ({body_}) at B={B} H={H} KV={KV} "
                  f"S={S} D={D} {dt}: kernel {b1:.4f} / {b2:.4f} ms, SDPA's "
                  f"backward {bl1:.4f} / {bl2:.4f} ms (backend {be_b}: "
                  f"{'; '.join(n_[:48] for n_ in names_b[:3])}), kernel / "
                  f"library {ratio_:.3f} (at most {limit_}"
                  f"{'' if forward else ', not held here'}), bound "
                  f"{row[f'{bp}_bound_ms']:.4f} ms ({by}), share of the "
                  f"bound {row[f'{bp}_bound_ms'] / ms_:.4f}; the launcher's "
                  f"schedule: {sch_['items']} items of {sch_['keys']} keys x "
                  f"{sch_['queries']}-query steps on {sch_['clusters']} "
                  f"clusters of C = {sch_['C']} blocks (grid "
                  f"{sch_['grid']}); two runs bit-equal"
                  + (f"; plain {row[f'{bp}_plain_ms']:.3f} ms, max|err| "
                     f"{err_b:.3e} (atol = rtol = "
                     f"{2e-2 if tc else 2e-5} held)" if forward else ""))
            if forward and ratio_ > limit_:
                raise AssertionError(f"flash_attention_bwd at D = 512 {dt} "
                                     f"takes {ratio_:.3f} x SDPA's backward, "
                                     f"above {limit_}")
            out.update(row)
            del q, k, v, do, o, lse, lib_in, lib_out
        return out

    def d2304_path():
        """Both dtypes above 2048 (B 1, H 2, KV 1, S = --lm-prompt, D =
        2304: 9 slices, two walks of clusters of five blocks): the cluster
        forward and backward in walks, each held to its plain version (the
        forward by check_flash: 2e-5 at float32, 2e-2 at bfloat16, two
        runs bit-equal; the backward's two runs bit-equal, at float32
        against the float64 plain version at atol = rtol = 2e-5, at
        bfloat16 against the plain version at 2e-2), timed beside SDPA's
        (in turns) and its bound, and held to at most WALK_MAX_RATIO x
        SDPA's forward or backward; the retired CUDA-core bodies' times
        at this shape (`PERF.md`, not re-run) printed beside.  Returns
        the flash row's `wide_D2304_*` and `wide_bwd_D2304_*` entries."""
        B, H, KV, S, D = 1, 2, 1, args.lm_prompt, 2304
        gen_ = torch.Generator(device=dev).manual_seed(args.seed + D)
        flops = 4.0 * D * B * H * S * (S + 1) / 2
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out = {}
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            if (FA._forward_route(dt, D)[0], FA._backward_route(dt, D)[0]) \
                    != ("cluster", "cluster"):
                raise AssertionError(f"flash attention at D = {D} {dt}: "
                                     f"routes {FA._forward_route(dt, D)}, "
                                     f"{FA._backward_route(dt, D)}")
            q, do = (torch.randn((B, H, S, D), generator=gen_, device=dev,
                                 dtype=dt) for _ in range(2))
            k, v = (torch.randn((B, KV, S, D), generator=gen_, device=dev,
                                dtype=dt) for _ in range(2))
            esz, tc = q.element_size(), dt == torch.bfloat16
            fp, bp = f"wide_D2304_{tag}", f"wide_bwd_D2304_{tag}"
            fsch_ = FA._fwd_schedule(B, H, S, D, dev, dt)
            bsch_ = FA._bwd_schedule(B, KV, S, D, dev, dt)
            if (fsch_["C"], fsch_["G"], bsch_["C"], bsch_["G"]) != \
                    (5, 2, 5, 2):
                raise AssertionError(f"flash attention at D = {D} {dt}: "
                                     f"schedules {fsch_}, {bsch_}")
            err_f = check_flash(q, k, v, f"D={D} {dt}")  # two runs equal
            o, lse = FA.flash_attention_fwd(q, k, v)
            ga = FA.flash_attention_bwd(q, k, v, o, lse, do)
            gb = FA.flash_attention_bwd(q, k, v, o, lse, do)
            if not all(same(x_, y_) for x_, y_ in zip(ga, gb)):
                raise AssertionError(f"flash_attention_bwd at D = {D} {dt}: "
                                     "two runs differ")
            if tc:
                gp = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
                tol_, how = 2e-2, "the plain version"
            else:
                gp = FA.flash_attention_bwd_plain(
                    *(x.double() for x in (q, k, v, o, lse, do)))
                tol_, how = 2e-5, "the float64 plain version"
            for n_, x_, z_ in zip(("dq", "dk", "dv"), ga, gp):
                if not torch.allclose(x_.to(z_.dtype), z_, rtol=tol_,
                                      atol=tol_):
                    raise AssertionError(
                        f"flash_attention_bwd at D = {D} {dt}: {n_} "
                        f"max|err| {(x_.to(z_.dtype) - z_).abs().max().item()}"
                        f" from {how}, outside atol = rtol = {tol_}")
            err_b = max((x_.to(z_.dtype) - z_).abs().max().item()
                        for x_, z_ in zip(ga, gp))
            del ga, gb, gp
            torch.cuda.empty_cache()
            lib_in = [x.detach().requires_grad_() for x in (q, k, v)]
            lib_out = sdpa(*lib_in, is_causal=True, enable_gqa=True)

            def fwd():
                return FA.flash_attention(q, k, v)

            def fwd_sdpa():
                return sdpa(q, k, v, is_causal=True, enable_gqa=True)

            def bwd():
                return FA.flash_attention_bwd(q, k, v, o, lse, do)

            def bwd_sdpa():
                return torch.autograd.grad(lib_out, lib_in, do,
                                           retain_graph=True)

            f1, l1 = timer(fwd, 10, warm=2), timer(fwd_sdpa, 3)
            l2, f2 = timer(fwd_sdpa, 3), timer(fwd, 10, warm=2)
            b1, bl1 = timer(bwd, 3), timer(bwd_sdpa, 2)
            bl2, b2 = timer(bwd_sdpa, 2), timer(bwd, 3)
            by = "fp32 operations" if not tc else "bf16 tensor-core operations"
            row = {
                f"{fp}_ms": (f1 + f2) / 2,
                f"{fp}_bound_ms": bound_ms(
                    esz * (2 * B * H * S * D + 2 * B * KV * S * D), flops,
                    tensor_cores=tc)[0],
                f"{fp}_plain_ms": timer(
                    lambda: FA.flash_attention_plain(q, k, v), 1),
                f"{fp}_library_ms": (l1 + l2) / 2,
                f"{fp}_max_abs_err": err_f,
                f"{fp}_body": (f"{'Fwd<256>' if tc else 'f32wide'} x "
                               f"{fsch_['C']} a cluster in {fsch_['G']} "
                               "walks"),
                f"{fp}_C": fsch_["C"], f"{fp}_G": fsch_["G"],
                f"{fp}_items": fsch_["items"],
                f"{fp}_clusters": fsch_["clusters"],
                f"{bp}_ms": (b1 + b2) / 2,
                f"{bp}_bound_ms": bound_ms(
                    esz * (4 * B * H * S * D + 4 * B * KV * S * D)
                    + 4 * B * H * S, 2.5 * flops, tensor_cores=tc)[0],
                f"{bp}_plain_ms": timer(
                    lambda: FA.flash_attention_bwd_plain(q, k, v, o, lse,
                                                         do), 1),
                f"{bp}_library_ms": (bl1 + bl2) / 2,
                f"{bp}_max_abs_err": err_b,
                f"{bp}_body": (f"{'widebwd' if tc else 'f32widebwd'} x "
                               f"{bsch_['C']} a cluster in {bsch_['G']} "
                               "walks"),
                f"{bp}_C": bsch_["C"], f"{bp}_G": bsch_["G"],
                f"{bp}_items": bsch_["items"],
                f"{bp}_clusters": bsch_["clusters"]}
            for what, key, a_, b_, c_, d_, sch_ in (
                    ("flash_attention", fp, f1, f2, l1, l2, fsch_),
                    ("flash_attention_bwd", bp, b1, b2, bl1, bl2, bsch_)):
                ms_ = row[f"{key}_ms"]
                ratio_ = ms_ / row[f"{key}_library_ms"]
                limit_ = WALK_MAX_RATIO[what, tag]
                print(f"{what} ({row[f'{key}_body']}) at B={B} H={H} KV={KV}"
                      f" S={S} D={D} {dt}: kernel {a_:.4f} / {b_:.4f} ms, "
                      f"SDPA {c_:.4f} / {d_:.4f} ms, kernel / library "
                      f"{ratio_:.3f} (at most {limit_}), bound "
                      f"{row[f'{key}_bound_ms']:.4f} ms ({by}), share of "
                      f"the bound {row[f'{key}_bound_ms'] / ms_:.4f}, plain "
                      f"{row[f'{key}_plain_ms']:.3f} ms, max|err| vs plain "
                      f"{row[f'{key}_max_abs_err']:.3e} (held), two runs "
                      f"bit-equal; {sch_['items']} items on "
                      f"{sch_['clusters']} clusters of C = {sch_['C']} "
                      f"blocks, G = {sch_['G']} walks [the retired CUDA-core "
                      f"body: {RETIRED_D2304_MS[what, tag]} ms, PERF.md, not "
                      f"re-run]")
                if ratio_ > limit_:
                    raise AssertionError(f"{what} at D = {D} {dt} takes "
                                         f"{ratio_:.3f} x SDPA's, above "
                                         f"{limit_}")
            out.update(row)
            del q, k, v, do, o, lse, lib_in, lib_out
        return out

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
        b, by = bound_ms(nbytes, flops, tensor_cores=True)

        def run_kernel():
            return FA.flash_attention(q, k, v)

        # kernel and library call in turns: kernel, library, library, kernel
        ms1, lib1 = timer(run_kernel, 20), timer(run_sdpa, 20)
        lib2, ms2 = timer(run_sdpa, 20), timer(run_kernel, 20)
        ms = (ms1 + ms2) / 2
        sch = FA._fwd_schedule(B, H, S, D, dev)
        print(f"flash_attention at the prefill's shape B={B} H={H} KV={KV} "
              f"S={S} D={D} bf16: kernel {ms1:.4f} / {ms2:.4f} ms, library "
              f"{lib1:.4f} / {lib2:.4f} ms, kernel / library "
              f"{ms / ((lib1 + lib2) / 2):.3f}, bound {b:.4f} ms, share of "
              f"the bound {b / ms:.3f}; the launcher's schedule "
              f"(flash_attention_fwd_info): {sch['items']} work items of "
              f"{sch['rows']} rows on a grid of {sch['grid']} persistent "
              f"blocks")
        plain_ms = timer(lambda: FA.flash_attention_plain(q, k, v), 3)
        del q, k, v
        # the wide bodies (D > 128) at one shape: yi's batch and a GQA
        # group of 4, 8 query heads, S = 2048, D = 256 (a Gemma-style head
        # dim): bfloat16 on the D = 256 tensor-core body beside SDPA, the
        # same inputs in float32 on the CUDA-core wide body, and the
        # backward at bfloat16 (its D = 256 tensor-core body) beside SDPA's
        Dw, Hw, KVw = 256, 8, 2
        qw, kw_, vw = (torch.randn((B, h_, S, Dw), generator=gen_,
                                   device=dev, dtype=torch.bfloat16)
                       for h_ in (Hw, KVw, KVw))
        err_w = check_flash(qw, kw_, vw, "wide D=256 bf16")
        flops_w = 4.0 * Dw * B * Hw * S * (S + 1) / 2
        bytes_w = 2 * (2 * B * Hw * S * Dw + 2 * B * KVw * S * Dw)

        def run_wide():
            return FA.flash_attention(qw, kw_, vw)

        def run_wide_sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qw, kw_, vw, is_causal=True, enable_gqa=True)

        # kernel and library call in turns, as at the prefill's shape
        w1, wl1 = timer(run_wide, 20), timer(run_wide_sdpa, 20)
        wl2, w2 = timer(run_wide_sdpa, 20), timer(run_wide, 20)
        sch_w = FA._fwd_schedule(B, Hw, S, Dw, dev)
        wide = dict(
            wide_D256_ms=(w1 + w2) / 2,
            wide_D256_bound_ms=bound_ms(bytes_w, flops_w,
                                        tensor_cores=True)[0],
            wide_D256_plain_ms=timer(
                lambda: FA.flash_attention_plain(qw, kw_, vw), 2),
            wide_D256_library_ms=(wl1 + wl2) / 2,
            wide_D256_max_abs_err=err_w)
        ms_w, lib_w = wide["wide_D256_ms"], wide["wide_D256_library_ms"]
        print(f"flash_attention wide, the D = 256 tensor-core body, at B={B} "
              f"H={Hw} KV={KVw} S={S} D={Dw} bf16: kernel {w1:.4f} / "
              f"{w2:.4f} ms, library {wl1:.4f} / {wl2:.4f} ms, kernel / "
              f"library {ms_w / lib_w:.3f}, bound "
              f"{wide['wide_D256_bound_ms']:.4f} ms, share of the bound "
              f"{wide['wide_D256_bound_ms'] / ms_w:.3f}, plain "
              f"{wide['wide_D256_plain_ms']:.4f} ms; the launcher's "
              f"schedule (flash_attention_fwd_info): {sch_w['items']} work "
              f"items of {sch_w['rows']} rows x {sch_w['keys']}-key tiles on "
              f"a grid of {sch_w['grid']} persistent blocks")
        # the float32 bodies at the same shape (f32wide, f32widebwd) on
        # the same inputs in float32, beside SDPA's float32 forward and
        # backward (one autograd call on a retained graph) in turns,
        # against their fp32 operation bounds: the forward held to its
        # plain version at 2e-5 (check_flash), the backward to the plain
        # version in float64 at atol = rtol = 2e-5 and its two runs
        # bit-equal; each at most F32_FWD_MAX_RATIO / F32_BWD_MAX_RATIO x
        # its SDPA call
        qf, kf, vf = (x.float() for x in (qw, kw_, vw))
        err_f = check_flash(qf, kf, vf, "wide D=256 float32")

        def run_f32_wide():
            return FA.flash_attention(qf, kf, vf)

        def run_f32_wide_sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qf, kf, vf, is_causal=True, enable_gqa=True)

        ff1, ffl1 = timer(run_f32_wide, 5), timer(run_f32_wide_sdpa, 5)
        ffl2, ff2 = timer(run_f32_wide_sdpa, 5), timer(run_f32_wide, 5)
        sch_ff = FA._fwd_schedule(B, Hw, S, Dw, dev, torch.float32)
        wide.update(
            wide_D256_f32_ms=(ff1 + ff2) / 2,
            # float32 operations outside the tensor cores, 4-byte operands
            wide_D256_f32_bound_ms=bound_ms(2 * bytes_w, flops_w)[0],
            wide_D256_f32_plain_ms=timer(
                lambda: FA.flash_attention_plain(qf, kf, vf), 2),
            wide_D256_f32_library_ms=(ffl1 + ffl2) / 2,
            wide_D256_f32_max_abs_err=err_f,
            wide_D256_f32_body=f"f32wide (flash_fwd_f32_wide_kernel, "
                               f"{FA._forward_route(torch.float32, Dw)[0]})")
        ms_ff = wide["wide_D256_f32_ms"]
        ratio_ff = ms_ff / wide["wide_D256_f32_library_ms"]
        print(f"flash_attention wide in float32 at the same shape, "
              f"{wide['wide_D256_f32_body']}: kernel {ff1:.4f} / {ff2:.4f} "
              f"ms, SDPA's float32 forward {ffl1:.4f} / {ffl2:.4f} ms, "
              f"kernel / library {ratio_ff:.3f} (at most "
              f"{F32_FWD_MAX_RATIO}), bound "
              f"{wide['wide_D256_f32_bound_ms']:.4f} ms (fp32 operations), "
              f"share of the bound "
              f"{wide['wide_D256_f32_bound_ms'] / ms_ff:.3f}, plain "
              f"{wide['wide_D256_f32_plain_ms']:.4f} ms, max|err| "
              f"{err_f:.3e}; the launcher's schedule "
              f"(flash_attention_fwd_info): {sch_ff['items']} work items of "
              f"{sch_ff['rows']} rows x {sch_ff['keys']}-key tiles on a "
              f"grid of {sch_ff['grid']} persistent blocks")
        if ratio_ff > F32_FWD_MAX_RATIO:
            raise AssertionError(f"flash_attention at the wide shape float32 "
                                 f"takes {ratio_ff:.3f} x SDPA's forward, "
                                 f"above {F32_FWD_MAX_RATIO}")
        o_f, lse_f = FA.flash_attention_fwd(qf, kf, vf)
        do_f = torch.randn(qf.shape, generator=gen_, device=dev)
        gb1 = FA.flash_attention_bwd(qf, kf, vf, o_f, lse_f, do_f)
        gb2 = FA.flash_attention_bwd(qf, kf, vf, o_f, lse_f, do_f)
        g64 = FA.flash_attention_bwd_plain(
            *(x.double() for x in (qf, kf, vf, o_f, lse_f, do_f)))
        for n_, x_, y_, z_ in zip(("dq", "dk", "dv"), gb1, gb2, g64):
            if not same(x_, y_):
                raise AssertionError(f"flash_attention_bwd at the wide shape "
                                     f"float32: {n_} runs differ")
            if not torch.allclose(x_.double(), z_, rtol=2e-5, atol=2e-5):
                raise AssertionError(
                    f"flash_attention_bwd at the wide shape float32: {n_} "
                    f"max|err| {(x_.double() - z_).abs().max().item()} "
                    f"from the float64 plain version, outside atol = rtol "
                    f"= 2e-5")
        err_fb = max((a_.double() - b_).abs().max().item()
                     for a_, b_ in zip(gb1, g64))
        del gb1, gb2, g64
        lib_in = [x.detach().requires_grad_() for x in (qf, kf, vf)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *lib_in, is_causal=True, enable_gqa=True)

        def run_f32_wide_bwd():
            return FA.flash_attention_bwd(qf, kf, vf, o_f, lse_f, do_f)

        def run_f32_wide_bwd_sdpa():
            return torch.autograd.grad(lib_out, lib_in, do_f,
                                       retain_graph=True)

        fw1, fwl1 = timer(run_f32_wide_bwd, 3), timer(run_f32_wide_bwd_sdpa, 3)
        fwl2, fw2 = timer(run_f32_wide_bwd_sdpa, 3), timer(run_f32_wide_bwd, 3)
        route_fw = FA._backward_route(torch.float32, Dw)
        sch_fw = FA._bwd_schedule(B, KVw, S, Dw, dev, torch.float32)
        wide.update(
            wide_bwd_D256_f32_ms=(fw1 + fw2) / 2,
            wide_bwd_D256_f32_bound_ms=bound_ms(
                4 * (4 * B * Hw * S * Dw + 4 * B * KVw * S * Dw)
                + 4 * B * Hw * S, 2.5 * flops_w)[0],
            wide_bwd_D256_f32_plain_ms=timer(
                lambda: FA.flash_attention_bwd_plain(qf, kf, vf, o_f, lse_f,
                                                     do_f), 1),
            wide_bwd_D256_f32_library_ms=(fwl1 + fwl2) / 2,
            wide_bwd_D256_f32_max_abs_err=err_fb,
            wide_bwd_D256_f32_body=f"f32widebwd (flash_bwd_f32_wide_kernel, "
                                   f"{route_fw[0]})")
        ms_fw = wide["wide_bwd_D256_f32_ms"]
        ratio_fw = ms_fw / wide["wide_bwd_D256_f32_library_ms"]
        print(f"flash_attention_bwd at the same shape in float32, "
              f"{wide['wide_bwd_D256_f32_body']}: kernel {fw1:.4f} / "
              f"{fw2:.4f} ms, SDPA's float32 backward {fwl1:.4f} / "
              f"{fwl2:.4f} ms, kernel / library {ratio_fw:.3f} (at most "
              f"{F32_BWD_MAX_RATIO}), bound "
              f"{wide['wide_bwd_D256_f32_bound_ms']:.4f} ms (fp32 "
              f"operations), share of the bound "
              f"{wide['wide_bwd_D256_f32_bound_ms'] / ms_fw:.3f}, plain "
              f"{wide['wide_bwd_D256_f32_plain_ms']:.1f} ms; the launcher's "
              f"schedule (flash_attention_bwd_info): {sch_fw['items']} work "
              f"items of {sch_fw['keys']} keys x {sch_fw['queries']}-query "
              f"steps on a grid of {sch_fw['grid']} persistent blocks; "
              f"max|err| vs the float64 plain version {err_fb:.3e} (atol = "
              f"rtol = 2e-5 held), two runs bit-equal")
        if ratio_fw > F32_BWD_MAX_RATIO:
            raise AssertionError(f"flash_attention_bwd at the wide shape "
                                 f"float32 takes {ratio_fw:.3f} x SDPA's "
                                 f"backward, above {F32_BWD_MAX_RATIO}")
        del o_f, lse_f, do_f, lib_in, lib_out
        del qf, kf, vf
        wide.update(d512_path(B=1))
        wide.update(d512_path(B=args.lm_batch, forward=False))
        wide.update(d2304_path())
        # the backward at the bfloat16 shape, on its tensor-core body for
        # 128 < D <= 256: two runs bit-equal, held to its plain version by
        # phase 8's limits, timed beside SDPA's backward (one autograd call
        # on a retained graph) in turns
        o_w, lse_w = FA.flash_attention_fwd(qw, kw_, vw)
        do_w = torch.randn(qw.shape, generator=gen_, device=dev,
                           dtype=torch.bfloat16)
        gw1 = FA.flash_attention_bwd(qw, kw_, vw, o_w, lse_w, do_w)
        gw2 = FA.flash_attention_bwd(qw, kw_, vw, o_w, lse_w, do_w)
        gwp = FA.flash_attention_bwd_plain(qw, kw_, vw, o_w, lse_w, do_w)
        gaps_w = [grad_gap(a, b) for a, b in zip(gw1, gwp)]
        if not (all(same(a, b) for a, b in zip(gw1, gw2))
                and all(grad_ok(g_) for g_ in gaps_w)):
            raise AssertionError(f"flash_attention_bwd at D = 256: runs "
                                 f"differ or {show_gaps(gaps_w)}")
        del gw1, gw2, gwp
        lib_in = [x.detach().requires_grad_() for x in (qw, kw_, vw)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *lib_in, is_causal=True, enable_gqa=True)

        def run_wide_bwd():
            return FA.flash_attention_bwd(qw, kw_, vw, o_w, lse_w, do_w)

        def run_wide_bwd_sdpa():
            return torch.autograd.grad(lib_out, lib_in, do_w,
                                       retain_graph=True)

        b1, bl1 = timer(run_wide_bwd, 10), timer(run_wide_bwd_sdpa, 10)
        bl2, b2 = timer(run_wide_bwd_sdpa, 10), timer(run_wide_bwd, 10)
        route_b = FA._backward_route(torch.bfloat16, Dw)
        sch_b = FA._bwd_schedule(B, KVw, S, Dw, dev)
        wide.update(
            wide_bwd_D256_ms=(b1 + b2) / 2,
            # five products over the causal pairs; q, o, dO, k, v read and
            # dq, dk, dv written in bf16, lse read
            wide_bwd_D256_bound_ms=bound_ms(
                2 * (4 * B * Hw * S * Dw + 4 * B * KVw * S * Dw)
                + 4 * B * Hw * S, 2.5 * flops_w, tensor_cores=True)[0],
            wide_bwd_D256_library_ms=(bl1 + bl2) / 2,
            wide_bwd_D256_body=f"widebwd (flash_bwd_kernel_d256, "
                               f"{route_b[0]})")
        ms_b, lib_b = wide["wide_bwd_D256_ms"], wide["wide_bwd_D256_library_ms"]
        print(f"flash_attention_bwd at the same shape, bf16, the D = 256 "
              f"tensor-core body ({wide['wide_bwd_D256_body']}): kernel "
              f"{b1:.4f} / {b2:.4f} ms, library (SDPA's backward) "
              f"{bl1:.4f} / {bl2:.4f} ms, kernel / library "
              f"{ms_b / lib_b:.3f}, bound "
              f"{wide['wide_bwd_D256_bound_ms']:.4f} ms, share of the bound "
              f"{wide['wide_bwd_D256_bound_ms'] / ms_b:.3f}; the launcher's "
              f"schedule (flash_attention_bwd_info): {sch_b['items']} work "
              f"items of {sch_b['keys']} keys x {sch_b['queries']}-query "
              f"steps on a grid of {sch_b['grid']} persistent blocks; two "
              f"runs bit-equal; vs plain {show_gaps(gaps_w)}")
        del o_w, lse_w, lib_in, lib_out
        # the slice at the wide shape: FlashAttentionFunction forward +
        # backward on the model's (B, S, H, D) layout (both kernels) beside
        # SDPA's forward + backward, in turns
        from repro_torch.models.attention import FlashAttentionFunction
        ins_w = [x.transpose(1, 2) for x in (qw, kw_, vw)]
        do_sw = do_w.transpose(1, 2)

        def wide_fn(fn):
            ins = [t.detach().requires_grad_() for t in ins_w]
            fn(*ins).backward(do_sw)
            return [t.grad for t in ins]

        def fn_wide_kernel(*t):
            return FlashAttentionFunction.apply(*t)

        def fn_wide_sdpa(*t):
            return torch.nn.functional.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in t), is_causal=True,
                enable_gqa=True).transpose(1, 2)

        n0 = (_build.launches["flash_attention"],
              _build.launches["flash_attention_bwd"])
        wide_fn(fn_wide_kernel)
        n1 = (_build.launches["flash_attention"],
              _build.launches["flash_attention_bwd"])
        if (n1[0] - n0[0], n1[1] - n0[1]) != (1, 1):
            raise AssertionError(f"FlashAttentionFunction at the wide shape "
                                 f"launched {n1[0] - n0[0]} forward and "
                                 f"{n1[1] - n0[1]} backward kernels, "
                                 f"expected 1 and 1")
        f1, fl1 = (timer(lambda: wide_fn(fn_wide_kernel), 5),
                   timer(lambda: wide_fn(fn_wide_sdpa), 5))
        fl2, f2 = (timer(lambda: wide_fn(fn_wide_sdpa), 5),
                   timer(lambda: wide_fn(fn_wide_kernel), 5))
        wide.update(wide_fn_D256_ms=(f1 + f2) / 2,
                    wide_fn_D256_library_ms=(fl1 + fl2) / 2)
        print(f"FlashAttentionFunction forward + backward at the same shape "
              f"on the (B, S, H, D) layout: {f1:.4f} / {f2:.4f} ms, SDPA's "
              f"forward + backward {fl1:.4f} / {fl2:.4f} ms, ratio "
              f"{(f1 + f2) / (fl1 + fl2):.3f}")
        del qw, kw_, vw, do_w, do_sw, ins_w
        # the CUDA-core bodies that float32 runs at D <= 128 (the reduced
        # archs of phase 8e train on them), at yi's prefill shape: the
        # forward (f32body) and the backward (f32bwd) beside SDPA's float32
        # forward and backward (one autograd call on a retained graph),
        # against their float32 operation bounds; both held to their plain
        # versions at phase 2's float32 limit (atol = rtol = 2e-5), the
        # backward's to the plain version in float64: a dv element here
        # sums 16,384 terms, and the float32 plain version's own rounding
        # takes about two thirds of the limit (its gap is printed); the
        # backward's two runs bit-equal, and its time at most
        # F32_BWD_MAX_RATIO x SDPA's backward, timed in turns
        qf, kf, vf, dof = (torch.randn((B, h_, S, D), generator=gen_,
                                       device=dev, dtype=torch.float32)
                           for h_ in (H, KV, KV, H))
        err_y = check_flash(qf, kf, vf, "yi's shape float32")
        o_f, lse_f = FA.flash_attention_fwd(qf, kf, vf)
        gf1 = FA.flash_attention_bwd(qf, kf, vf, o_f, lse_f, dof)
        gf2 = FA.flash_attention_bwd(qf, kf, vf, o_f, lse_f, dof)
        gfp = FA.flash_attention_bwd_plain(qf, kf, vf, o_f, lse_f, dof)
        gf64 = FA.flash_attention_bwd_plain(
            *(x.double() for x in (qf, kf, vf, o_f, lse_f, dof)))

        def limit_share(x_, z_):        # of atol = rtol = 2e-5
            return ((x_.double() - z_).abs() / (2e-5 * (1 + z_.abs()))
                    ).max().item()

        gaps_f = [grad_gap(a, b) for a, b in zip(gf1, gf64)]
        err_bf = max(g_[0] for g_ in gaps_f)
        for n_, x_, y_, z_ in zip(("dq", "dk", "dv"), gf1, gf2, gf64):
            if not same(x_, y_):
                raise AssertionError(f"flash_attention_bwd at yi's shape "
                                     f"float32: {n_} runs differ")
            if not limit_share(x_, z_) <= 1:
                raise AssertionError(
                    f"flash_attention_bwd at yi's shape float32: {n_} "
                    f"max|err| {(x_.double() - z_).abs().max().item()} "
                    f"from the float64 plain version, outside atol = rtol "
                    f"= 2e-5")
        f32_share = [limit_share(x_, z_) for x_, z_ in zip(gf1, gf64)]
        plain_share = [limit_share(x_, z_) for x_, z_ in zip(gfp, gf64)]
        del gf1, gf2, gfp, gf64
        lib_in = [x.detach().requires_grad_() for x in (qf, kf, vf)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *lib_in, is_causal=True, enable_gqa=True)
        nbytes_f = 4 * (2 * B * H * S * D + 2 * B * KV * S * D)

        def run_f32_bwd():
            return FA.flash_attention_bwd(qf, kf, vf, o_f, lse_f, dof)

        def run_f32_bwd_sdpa():
            return torch.autograd.grad(lib_out, lib_in, dof,
                                       retain_graph=True)

        fb1, fbl1 = timer(run_f32_bwd, 3), timer(run_f32_bwd_sdpa, 3)
        fbl2, fb2 = timer(run_f32_bwd_sdpa, 3), timer(run_f32_bwd, 3)
        plain_bwd_ms = timer(lambda: FA.flash_attention_bwd_plain(
            qf, kf, vf, o_f, lse_f, dof), 1)
        route_f = FA._backward_route(torch.float32, D)
        sch_f = FA._bwd_schedule(B, KV, S, D, dev, torch.float32)
        wide.update(
            f32_yi_ms=timer(lambda: FA.flash_attention(qf, kf, vf), 3),
            f32_yi_bound_ms=bound_ms(nbytes_f, flops)[0],
            f32_yi_library_ms=timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qf, kf, vf, is_causal=True, enable_gqa=True), 3),
            f32_yi_max_abs_err=err_y,
            f32_bwd_yi_ms=(fb1 + fb2) / 2,
            f32_bwd_yi_bound_ms=bound_ms(
                4 * (4 * B * H * S * D + 4 * B * KV * S * D)
                + 4 * B * H * S, 2.5 * flops)[0],
            f32_bwd_yi_plain_ms=plain_bwd_ms,
            f32_bwd_yi_library_ms=(fbl1 + fbl2) / 2,
            f32_bwd_yi_max_abs_err=err_bf,
            f32_bwd_yi_body=f"f32bwd (flash_bwd_f32_kernel<{route_f[1]}>, "
                            f"{route_f[0]})")
        ratio_f = wide["f32_bwd_yi_ms"] / wide["f32_bwd_yi_library_ms"]
        print(f"float32 at yi's prefill shape (B={B} H={H} KV={KV} S={S} "
              f"D={D}), the CUDA-core bodies: forward "
              f"{wide['f32_yi_ms']:.4f} ms (bound "
              f"{wide['f32_yi_bound_ms']:.4f} ms, fp32 operations; SDPA "
              f"{wide['f32_yi_library_ms']:.4f} ms; max|err| vs plain "
              f"{err_y:.3e}); backward ({wide['f32_bwd_yi_body']}) "
              f"{fb1:.4f} / {fb2:.4f} ms, SDPA's backward {fbl1:.4f} / "
              f"{fbl2:.4f} ms, kernel / library {ratio_f:.3f} (at most "
              f"{F32_BWD_MAX_RATIO}), bound "
              f"{wide['f32_bwd_yi_bound_ms']:.4f} ms (fp32 operations), "
              f"share of the bound "
              f"{wide['f32_bwd_yi_bound_ms'] / wide['f32_bwd_yi_ms']:.3f}, "
              f"plain {plain_bwd_ms:.1f} ms; the "
              f"launcher's schedule: {sch_f['items']} work items of "
              f"{sch_f['keys']} keys x {sch_f['queries']}-query steps on a "
              f"grid of {sch_f['grid']} persistent blocks; two runs "
              f"bit-equal; against the plain version in float64, "
              f"dq, dk, dv at {', '.join(f'{s_:.3f}' for s_ in f32_share)} "
              f"of the elementwise limit atol = rtol = 2e-5 (the float32 "
              f"plain version at "
              f"{', '.join(f'{s_:.3f}' for s_ in plain_share)}), "
              f"{show_gaps(gaps_f)}")
        if ratio_f > F32_BWD_MAX_RATIO:
            raise AssertionError(f"flash_attention_bwd at yi's shape "
                                 f"float32 takes {ratio_f:.3f} x SDPA's "
                                 f"backward, above {F32_BWD_MAX_RATIO}")
        del qf, kf, vf, dof, o_f, lse_f, lib_in, lib_out
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
                                              tensor_cores=True)[0]
            out[f"{tag}_plain_ms"] = timer(
                lambda: FA.flash_attention_plain(q, k, v), 2)
            out[f"{tag}_library_ms"] = timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 20)
            # a pad or slice copy around the launch would show here
            prof_, _ = profiled(torch, lambda: FA.flash_attention(q, k, v),
                             [torch.profiler.ProfilerActivity.CPU,
                              torch.profiler.ProfilerActivity.CUDA])
            copies = sorted({ev.key for ev in prof_.key_averages()
                             if "pad" in ev.key or "copy" in ev.key.lower()})
            out[f"{tag}_copies"] = copies
            sch = FA._fwd_schedule(B, H, S, D, dev)
            print(f"flash_attention at {arch}'s prefill shape B={B} H={H} "
                  f"KV={KV} S={S} D={D} bf16 (route "
                  f"{FA._forward_route(q.dtype, D)[0]}): kernel "
                  f"{out[tag + '_ms']:.4f} ms, bound "
                  f"{out[tag + '_bound_ms']:.4f} ms, share of the bound "
                  f"{out[tag + '_bound_ms'] / out[tag + '_ms']:.3f}, plain "
                  f"{out[tag + '_plain_ms']:.4f} ms, library "
                  f"{out[tag + '_library_ms']:.4f} ms, kernel / library "
                  f"{out[tag + '_ms'] / out[tag + '_library_ms']:.3f}, "
                  f"max|err| {e_:.3e}; the launcher's schedule "
                  f"(flash_attention_fwd_info): {sch['items']} work items "
                  f"of {sch['rows']} rows on a grid of {sch['grid']} "
                  f"persistent blocks; copies around the launch: "
                  f"{', '.join(copies) if copies else 'none'}")
            del q, k, v
        return out

    walls = {"build + small shapes": time.perf_counter() - t_start}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        return out

    results, main_graph, Z_cuda = timed("GEE path", gee_path)
    gc.collect()
    torch.cuda.empty_cache()
    timed("plan cache", plan_cache_path, main_graph[0], main_graph[2])
    timed("engine", engine_path, *main_graph)
    gc.collect()
    results[0].update(timed("skew", skew_path))
    gc.collect()
    torch.cuda.empty_cache()
    timed("socket deployment", socket_path, *main_graph)
    timed("distributed GEE", distributed_path, torch, dev, main_graph[0],
          main_graph[2], Z_cuda)
    del main_graph, Z_cuda
    gc.collect()
    lo, hi = RowPartition(args.n, 2).slice(0)
    tuned = timed("tune", tune_path, torch, dev, args.n, args.s, hi - lo,
                  results[0]["bound_bytes"])
    for r_, key in ((results[0], "gee_scatter"), (results[1], "topk_fused")):
        r_["tune"] = {which: {"cfg": pt["cfg"], "ms": pt["seconds"] * 1e3,
                              "bound_share": pt["bound_share"]}
                      for which, pt in tuned[key].items()}
    results.append(timed("yi-6b", lm_path))
    gc.collect()
    torch.cuda.empty_cache()
    fam = timed("families", families_path)
    gc.collect()
    torch.cuda.empty_cache()
    flash_train, scatter_train, bwd_row, phase8 = timed(
        "training", train_path, torch, dev, args, timer, smi)
    gc.collect()
    torch.cuda.empty_cache()
    shard = timed("sharding and dry run", shard_path, torch, dev, args, smi,
                  phase8)
    bwd_row["shard_train_launches"] = shard.pop("shard_train_bwd_launches")
    flash_train.update(shard)
    print("phase wall seconds: " + ", ".join(f"{k_} {v_:.1f}"
                                             for k_, v_ in walls.items()))
    fam["launches_by_arch"] = {"yi-6b": results[-1]["launches"],
                               **fam["launches_by_arch"]}
    results[-1].update(fam)
    results[-1].update(flash_train)
    results[0].update(scatter_train)
    # phase 6's float32 backward at yi's shape goes to the backward's row
    bwd_row.update({k_: results[-1].pop(k_) for k_ in list(results[-1])
                    if k_.startswith("f32_bwd_")})
    results.append(bwd_row)

    for r_ in results:
        rate = (f", {r_['tflops']:.1f} TFLOP/s, {r_['bound_share']:.3f} of "
                f"the bound; the D = 256 body: {r_['wide_D256_ms']:.4f} ms "
                f"(bound {r_['wide_D256_bound_ms']:.4f}, library "
                f"{r_['wide_D256_library_ms']:.4f}); float32 at D = 256 "
                f"(f32wide): {r_['wide_D256_f32_ms']:.4f} ms, backward "
                f"(f32widebwd) {r_['wide_bwd_D256_f32_ms']:.4f} ms; "
                f"the backward at D = 256 ({r_['wide_bwd_D256_body']}): "
                f"{r_['wide_bwd_D256_ms']:.4f} ms (SDPA's "
                f"{r_['wide_bwd_D256_library_ms']:.4f}); forward + "
                f"backward at D = 256 {r_['wide_fn_D256_ms']:.4f} ms (SDPA's "
                f"{r_['wide_fn_D256_library_ms']:.4f})"
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
                    f"k = 100 ({r_['wide_k100_body']} body) "
                    f"{r_['wide_k100_ms']:.4f} ms "
                    f"(bound {r_['wide_k100_bound_ms']:.4f}, library "
                    f"{r_['wide_k100_library_ms']:.4f}), K = 300 "
                    f"({r_['wide_K300_body']} body) "
                    f"{r_['wide_K300_ms']:.4f} ms (bound "
                    f"{r_['wide_K300_bound_ms']:.4f}, library "
                    f"{r_['wide_K300_library_ms']:.4f})")
        if "wide_K200_ms" in r_:
            rate = (f", on the device alone {r_['device_ms']:.4f} ms; "
                    f"K = 200 at 262,144 rows: {r_['wide_K200_ms']:.4f} ms "
                    f"(bound {r_['wide_K200_bound_ms']:.4f}, library "
                    f"{r_['wide_K200_library_ms']:.4f}); the sweep's bound "
                    f"/ kernel " + ", ".join(
                        f"K={w_['K']} {w_['bound_over_kernel']:.3f}"
                        for w_ in r_["sweep"]))
        print(f"{r_['name']}: {r_['shape']}: kernel {r_['ms']:.4f} ms, "
              f"bound {r_['bound_ms']:.4f} ms ({r_['bound_by']}), plain "
              f"{r_['plain_ms']:.4f} ms, library {r_['library_ms']:.4f} ms, "
              f"launches {r_['launches']}, max|err| {r_['max_abs_err']:.3e}"
              f"{rate}")
        if "train_fn_ms" in r_:
            print(f"  {r_['name']} in training (phase 8): launches "
                  f"{r_['train_launches']}; forward + backward at yi's "
                  f"shape {r_['train_fn_ms']:.3f} ms (with the layout "
                  f"copies {r_['train_fn_copying_ms']:.3f}, bound "
                  f"{r_['train_fn_bound_ms']:.4f}, plain "
                  f"{r_['train_fn_plain_ms']:.3f}, library "
                  f"{r_['train_fn_library_ms']:.3f})")
        elif "train_launches" in r_:
            print(f"  {r_['name']} in training (phase 8, the GEE embedding "
                  f"init): launches {r_['train_launches']}")
        if r_["name"] == "flash_attention_bwd":
            print(f"  {r_['name']}: {r_['five_product_tflops']:.1f} TFLOP/s "
                  f"over its five products, {r_['bound_share']:.3f} of the "
                  f"bound; launches by reduced arch {r_['launches_by_arch']}; "
                  f"{r_['shard_train_launches']} in two sharded train steps "
                  f"(phase 9); float32 at yi's shape "
                  f"({r_['f32_bwd_yi_body']}) "
                  f"{r_['f32_bwd_yi_ms']:.4f} ms (bound "
                  f"{r_['f32_bwd_yi_bound_ms']:.4f}, plain "
                  f"{r_['f32_bwd_yi_plain_ms']:.1f}, SDPA's "
                  f"{r_['f32_bwd_yi_library_ms']:.4f})")
        elif "shard_train_launches" in r_:
            print(f"  {r_['name']} on local heads under DTensor (phase 9): "
                  f"launches {r_['shard_train_launches']} in two sharded "
                  f"train steps, {r_['shard_serve_launches']} in the "
                  f"sharded prefill")
    print(json.dumps({"kernels": [{k_: v_ for k_, v_ in r_.items()
                                   if k_ != "shape"} for r_ in results]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
