"""Where the flash forward's time goes: `flash_attention` at the models'
prefill shapes and at two wide head dims, timed with source variants of
its tensor-core bodies (``flash_fwd_bf16_kernel``, and
``flash_fwd_bf16_kernel_d256`` for 128 < D <= 256), of its float32 body
for 128 < D <= 256 (``flash_fwd_f32_wide_kernel``) and of the cluster
forward above 256 (both D = 256 bodies with CL = true) that each drop or
change one piece of work.

Each variant is ``csrc/flash_attention.cu`` with a text patch, built
with nvcc (``-Xptxas -v``) into ``build/repro_torch/fwd_ablate/`` and
run in a process of its own, in the order base, the variants, base.
The variants that drop work give wrong answers by design: they are
timed, never checked (each process prints its largest difference from
SDPA).  The build prints ptxas' C7520 warnings (wgmma serialized) and
the spill bytes of every forward body.

    base           the kernel as it is
    no_store       the epilogue's TMA stores off (O is computed and staged
                   in shared memory, never written)
    no_exp         P = S * scale - m with no ex2: the products, loads and
                   the rest of the softmax alone
    stages3        a ring of 3 K and V slots below D = 128 (2 in the
                   kernel; D = 128 has no room for a third)
    two_consumers  D = 64 in items of 128 rows, two consumer warpgroups
                   (three over 192 rows in the kernel)
    no_turns       the consumers issue their products without taking
                   turns on the tensor cores
    legacy         one block per work item (the grid before the
                   persistent blocks; each block takes one ticket)
    runtime_width  width 120 through the runtime-width body
    wide_bk64      the D = 256 body with 64-key K and V tiles (80 in the
                   kernel, as in FlashAttention-3's hdim-256 forward)
    wide_o_regs    the D = 256 body's O written from registers, the Q
                   slot released after the consumers' last S (in the
                   kernel O is staged in the consumer's rows of the Q slot
                   and stored with TMA, the slot released once the store
                   has read it)
    wide_no_turns  the D = 256 body's consumers without turns
    wide_one_stage the D = 256 body with one K and V stage (two in the
                   kernel; the cluster forward has one, its second
                   stage's room holding the exchange)
    f32_body256    float32 at D = 256 on f32body as it stands (one block a
                   64-row query tile, Q and K at pitch D + 1 in shared
                   memory, one K and V tile at a time, plain loads): the
                   floor the float32 wide body (f32wide) has to beat
    f32w_no_exp    f32wide with p = s - m and alpha = 1, no expf
    f32w_no_s      f32wide without its S product (the softmax on zeros)
    f32w_no_pv     f32wide without its P V product
    f32w_one_stage f32wide with one K and V stage (two in the kernel)
    cl_no_xch      the cluster forward (D > 256) without its exchange:
                   no reads of the other ranks' partials and no arrivals
                   or waits (namespace clusterbwd, as `bwd_ablate`'s
                   variant of the same name, and the bfloat16 body's pair
                   sum): each block's D = 256 body on its slice alone
    cl_one_slice   the cluster forward's walks (above D = 2048) with S
                   over each block's first slice alone (the other slices'
                   Q and K neither loaded nor multiplied): what the
                   recomputed S costs (namespace clusterbwd, as
                   `bwd_ablate`'s variant of the same name)

`legacy` changes the grid rule that both bfloat16 bodies share; the
`wide_*` variants touch only the bfloat16 D = 256 body (`wide_o_regs`
is meant for it alone), the `f32*` variants only float32 at D = 256,
`cl_no_xch` only the exchange, `cl_one_slice` only the walks' slice
count, the others only the D <= 128 ones.

Shapes (--shape, repeatable: a preset or B,H,KV,S,D):

    yi       4, 32, 4, 2048, 128   (yi-6b's prefill)
    zamba2   4, 32, 32, 2048, 64   (zamba2-1.2b's)
    danube   4, 32, 8, 2048, 120   (h2o-danube-3-4b's, read in place)
    whisper  4, 16, 16, 2048, 64   (whisper-medium's decoder)
    wide     4, 8, 2, 2048, 256    (yi's batch and GQA group of 4 at a
                                    Gemma-style head dim: the D = 256 body)
    wide_f32 4, 8, 2, 2048, 256    (the same in float32: f32wide)
    d512     1, 8, 2, 2048, 512    (the wide shape at B 1 and D = 512: the
                                    cluster forward, two blocks a cluster)
    d512_f32 1, 8, 2, 2048, 512    (the same in float32 operands)
    d2304    1, 2, 1, 2048, 2304   (a head dim above 2048: 9 slices,
                                    clusters of 5 blocks in two walks)
    d2304_f32 1, 2, 1, 2048, 2304  (the same in float32 operands)

The presets run bfloat16 operands, except wide_f32, d512_f32 and
d2304_f32, which run float32; a shape written out runs bfloat16.  Above
D = 256 the default variants are base and the ``cl_*`` ones, and above
2048 ``--parent`` is refused (a parent before the walks runs widebody
there).

Run on a card (CUDA events, the mean of 20 calls, three rounds each, on
the model's (B, S, H, D) layout and on contiguous (B, H, S, D) tensors;
each process also times `scaled_dot_product_attention` on the same
inputs).  Per shape and layout each process also prints the device-only
time of kernel and SDPA (the calls queued behind a spin kernel, so that
no host gap is timed), the device time of one profiled kernel call
(torch.profiler; "not measured" if it records no kernel), and a digest
of the output's and lse's bits:

    PYTHONPATH=src python -m repro_torch.launch.fwd_ablate \\
        [--shape yi --shape zamba2 ...] [--variants base,no_exp] \\
        [--parent OTHER/src/repro_torch/kernels/csrc/flash_attention.cu]

--parent adds a variant "parent": that file as it is (say, a parent
commit's, unpacked with ``git archive``), run first and last (parent,
base, the variants, base, parent).  Its ``flash_attention_launch`` must
take the arguments this wrapper passes.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
import time

from repro_torch.kernels import _build
from repro_torch.launch import bwd_ablate as _bwd_ablate

OUT = _build.BUILD_DIR / "fwd_ablate"

#: (B, H, KV, S, D) of each model's prefill at batch 4 x 2048 tokens
PRESETS = {
    "yi": (4, 32, 4, 2048, 128),
    "zamba2": (4, 32, 32, 2048, 64),
    "danube": (4, 32, 8, 2048, 120),
    "whisper": (4, 16, 16, 2048, 64),
    "wide": (4, 8, 2, 2048, 256),
    "wide_f32": (4, 8, 2, 2048, 256),
    "d512": (1, 8, 2, 2048, 512),
    "d512_f32": (1, 8, 2, 2048, 512),
    "d2304": (1, 2, 1, 2048, 2304),
    "d2304_f32": (1, 2, 1, 2048, 2304),
}
#: the model presets (the D <= 128 bodies), the default --shape list
MODEL_PRESETS = ("yi", "zamba2", "danube", "whisper")
#: the presets that run float32 operands (the others bfloat16)
FLOAT32_PRESETS = ("wide_f32", "d512_f32", "d2304_f32")

_EX2 = "s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));"

# the D = 256 body's epilogue: O staged in the Q slot and stored by TMA,
# and (wide_o_regs) written from registers instead, rows below S and
# columns below the width
_WIDE_STAGED = """\
      // into this consumer's own rows of the Q slot (its last S has read
      // them) in the TMA store's swizzled layout, then one store a
      // column chunk; the map drops rows past S and columns past the
      // width.  The slot is released once the stores have read it.
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + c0;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          st_shared(qa + (col / GQ::AW) * GQ::CHUNK +
                        GQ::swizzle((r0 + 8 * h2) * GQ::ROW +
                                    (col % GQ::AW) * 2),
                    pack_bf16(acc[4 * jj + 2 * h2] / den[h2],
                              acc[4 * jj + 2 * h2 + 1] / den[h2]));
      }
      fence_async_smem();
      named_sync(1 + NCONS + w, 128);
      if (tid == 0) {
        if constexpr (WALKS) {                 // the owned slice, if any
          const int own = clusterbwd::rank() + clusterbwd::size() * walk;
          if (own < slices)
            for (int cc = 0; cc < GQ::NC; ++cc)
              tma_store(&to, qa + cc * GQ::CHUNK, own * D + cc * GQ::AW, h,
                        row0, b);
        } else {
          for (int cc = 0; cc < GQ::NC; ++cc)
            tma_store(&to, qa + cc * GQ::CHUNK,
                      (CL ? clusterbwd::rank() * D : 0) + cc * GQ::AW, h,
                      row0, b);
        }
        bulk_commit();
        bulk_wait<true>();
        mbar_arrive(empty_q);
      } else if constexpr (WALKS) {
        mbar_arrive(empty_q);
      }
"""
_WIDE_REGS = """\
      // straight from registers: rows below S, columns below the width
      __nv_bfloat16* op = at(o, lo, b, h);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = row0 + r0 + 8 * h2;
        if (row >= S) continue;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          const int col = 8 * jj + c0;
          if (col < width)
            *reinterpret_cast<__nv_bfloat162*>(op + row * lo.s + col) =
                __floats2bfloat162_rn(acc[4 * jj + 2 * h2] / den[h2],
                                      acc[4 * jj + 2 * h2 + 1] / den[h2]);
        }
      }
      if constexpr (WALKS) mbar_arrive(empty_q);   // the walks' last Q
"""

PATCHES = {
    "base": [],
    "no_store": [("      if (tid == 0) {\n"
                  "        for (int c = 0; c < GO::NC; ++c)\n",
                  "      if (tid == 0 && scale_log2 < 0.f) {\n"
                  "        for (int c = 0; c < GO::NC; ++c)\n")],
    "no_exp": [(_EX2, _EX2.replace("ex2(fmaf", "(fmaf"))],
    "stages3": [("  static constexpr int STAGES = 2;\n",
                 "  static constexpr int STAGES = D == 128 ? 2 : 3;\n")],
    "two_consumers": [("  static constexpr int CONSUMERS = D == 64 ? 3 : 2;\n",
                       "  static constexpr int CONSUMERS = 2;\n")],
    "no_turns": [
        ("      pin(p);\n      bar_sync(1 + w);\n      wgmma_fence();\n"
         "      issue();\n      bar_arrive(1 + (w + 1) % NCONS);\n",
         "      pin(p);\n      wgmma_fence();\n      issue();\n"),
        ("        bar_sync(1 + w);\n"
         "        bar_arrive(1 + (w + 1) % NCONS);\n", ""),
        ("    if (w == NCONS - 1) bar_arrive(1);         // consumer 0 goes "
         "first\n", ""),
        ("    if (w == 0) bar_sync(1);                   // the last turn's "
         "hand-over\n", "")],
    "legacy": [("  const int grid = n_items < sms ? n_items : sms;",
                "  const int grid = n_items;")],
    "runtime_width": [
        ("  if constexpr (D == 128)\n"
         "    if (width == 120) fn = flash_fwd_bf16_kernel<128, 120>;\n",
         "")],
    "wide_bk64": [
        ("  static constexpr int BK = 80;              // keys per K and V "
         "tile\n",
         "  static constexpr int BK = 64;              // keys per K and V "
         "tile\n")],
    "wide_o_regs": [
        ("                           int slices) {",
         "                           int slices,\n"
         "                           __nv_bfloat16* __restrict__ o, Lay lo,"
         "\n                           int width) {"),
        ("  flash_fwd_bf16_kernel_d256<false><<<grid, F::THREADS, F::SMEM, "
         "stream>>>(\n      mq, mk, mv, mo, lse, work, B, H, KV, S, "
         "scale * LOG2E, 0, 1);",
         "  flash_fwd_bf16_kernel_d256<false><<<grid, F::THREADS, F::SMEM, "
         "stream>>>(\n      mq, mk, mv, mo, lse, work, B, H, KV, S, "
         "scale * LOG2E, 0, 1,\n      static_cast<__nv_bfloat16*>(o), "
         "ly[3], width);"),
        ("                             scale * LOG2E, g, slices);",
         "                             scale * LOG2E, g, slices,\n"
         "                             static_cast<__nv_bfloat16*>(o), "
         "ly[3], width);"),
        ("    mbar_init(empty_q, WALKS ? 128 * NCONS : NCONS);",
         "    mbar_init(empty_q, 128 * NCONS);"),
        ("        if (WALKS || tid == 0) mbar_arrive(empty_q);\n",
         "        if (WALKS) mbar_arrive(empty_q);\n"),
        (_WIDE_STAGED, _WIDE_REGS),
        ("      mbar_arrive(empty_k + 8 * slot(0));\n      if (walks) {\n",
         "      mbar_arrive(empty_k + 8 * slot(0));\n"
         "      if (last == 0) mbar_arrive(empty_q);\n      if (walks) {\n"),
        ("        mbar_arrive(empty_k + 8 * slot(t));\n        if constexpr",
         "        mbar_arrive(empty_k + 8 * slot(t));\n"
         "        if (t == last) mbar_arrive(empty_q);\n        if constexpr")],
    "wide_no_turns": [
        ("      pin(pk);\n      bar_sync(1 + w);\n      wgmma_fence();\n"
         "      issue();\n      bar_arrive(1 + (w + 1) % NCONS);\n",
         "      pin(pk);\n      wgmma_fence();\n      issue();\n"),
        ("    if (w == NCONS - 1) bar_arrive(1);         // consumer 0 takes "
         "turn 0\n", ""),
        ("    if (w == 0) bar_sync(1);                   // the other's last "
         "hand-over\n", "")],
    "wide_one_stage": [
        ("  static constexpr int STAGES = 2;           // K and V tiles in the "
         "ring\n",
         "  static constexpr int STAGES = 1;           // K and V tiles in the "
         "ring\n")],
    "f32_body256": [
        ("    case 256: return f32wide::launch(q, k, v, o, l, ly, B, H, KV, S, "
         "width,\n                                     scale, st);\n",
         "    case 256: return f32body::launch<256>(q, k, v, o, l, ly, B, H, "
         "KV, S,\n                                          scale, st);\n")],
    "f32w_no_exp": [
        ("        const float alpha = expf(m - m_new);\n",
         "        const float alpha = 1.f;\n"),
        ("          const float p = expf(z[c] - m_new);\n",
         "          const float p = z[c] - m_new;\n")],
    "f32w_no_s": [
        ("          for (int tt = 0; tt < D / 4 / PARTS; ++tt) {\n"
         "            const int u = D / 4 / PARTS * pq + tt;\n"
         "            float4 qf[4];\n#pragma unroll\n"
         "            for (int r = 0; r < 4; ++r)\n"
         "              qf[r] = lds4(gb, Q_OFF",
         "          for (int tt = 0; tt < 0; ++tt) {\n"
         "            const int u = D / 4 / PARTS * pq + tt;\n"
         "            float4 qf[4];\n#pragma unroll\n"
         "            for (int r = 0; r < 4; ++r)\n"
         "              qf[r] = lds4(gb, Q_OFF"),
        ("            for (int tt = 0; tt < D / 4 / PARTS; ++tt) {\n"
         "              const int u = D / 4 / PARTS * pq + tt;\n"
         "              float4 qf[4];\n#pragma unroll\n"
         "              for (int r = 0; r < 4; ++r)\n"
         "                qf[r] = lds4(gb, qb",
         "            for (int tt = 0; tt < 0; ++tt) {\n"
         "              const int u = D / 4 / PARTS * pq + tt;\n"
         "              float4 qf[4];\n#pragma unroll\n"
         "              for (int r = 0; r < 4; ++r)\n"
         "                qf[r] = lds4(gb, qb")],
    "f32w_no_pv": [("        for (int key = 0; key < BK; ++key) {",
                    "        for (int key = 0; key < 0; ++key) {")],
    "f32w_one_stage": [
        ("constexpr int STAGES = 2;       // K and V tiles in the ring",
         "constexpr int STAGES = 1;       // K and V tiles in the ring")],
}
# the cluster forward's exchange, cut in namespace clusterbwd as the
# backward's ablation cuts it: no reads of the other ranks' partials, no
# arrivals and no waits
PATCHES["cl_no_xch"] = [*_bwd_ablate.PATCHES["cl_no_xch"],
                        ("      if (C == 2) {                            // "
                         "the pair's sum\n",
                         "      if (C == 0) {                            // "
                         "the pair's sum\n")]
# the walks' S over one slice (namespace clusterbwd, as the backward's)
PATCHES["cl_one_slice"] = _bwd_ablate.PATCHES["cl_one_slice"]


def variant_source(name: str, parent=None) -> str:
    """The source of one variant (raises if a patch does not apply
    exactly once); "parent" is the file `parent` as it is."""
    if name == "parent":
        return open(parent).read()
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} not once in the "
                             "source")
        src = src.replace(old, new)
    return src


def forward_notes(log: str) -> list:
    """From an ``nvcc -Xptxas -v`` log: ptxas' C7520 warnings (wgmma
    serialized) and, per forward body (``flash_fwd_bf16_kernel<D, W>``,
    and ``<256>`` for ``flash_fwd_bf16_kernel_d256``), its registers and
    spill bytes; the float32 bodies as ``f32<D>`` (f32body's
    ``flash_fwd_kernel<D>``) and ``f32<256> wide``
    (``flash_fwd_f32_wide_kernel``); the cluster forward's instantiations
    (CL = true) with `` cluster`` after their body's name, and
    `` cluster walks`` for the walks' (above 2048)."""
    out, fn = [], None
    for line in log.splitlines():
        body = re.search(r"flash_fwd_bf16_kernelILi(\d+)ELi(\d+)E", line)
        f32 = re.search(r"flash_fwd_kernelILi(\d+)E", line)
        name = (f"<{body[1]}, {body[2]}>" if body else
                "<256>" if "flash_fwd_bf16_kernel_d256" in line else
                f"f32<{f32[1]}>" if f32 else
                "f32<256> wide" if "flash_fwd_f32_wide_kernel" in line
                else None)
        if name and re.search(r"(d256|f32_wide_kernel)ILb1E", line):
            name += " cluster"
        if name and re.search(r"(d256|f32_wide_kernel)ILb1ELb1E", line):
            name += " walks"
        if "C7520" in line:
            if name:
                out.append(f"C7520 in {name}: "
                           + line.split("C7520)")[-1].split(" in the "
                                                           "function")[0]
                           .strip())
            continue
        if "Function properties for" in line:
            fn = name
        elif fn and "spill stores" in line:
            sp = re.findall(r"(\d+) bytes spill", line)
            out.append(f"{fn} spill {'+'.join(sp)} B")
        elif fn and "Used" in line and "registers" in line:
            out[-1] += f", {re.search(r'Used (\d+) registers', line)[1]} regs"
            fn = None
    return out


def build(names, parent=None) -> dict:
    """One nvcc per variant, all started together; {variant: the forward
    bodies' ptxas notes}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs, notes = {}, {}
    for name in names:
        cu = OUT / f"{name}.cu"
        text = variant_source(name, parent)
        if (OUT / f"{name}.so").exists() and cu.exists() and \
                cu.read_text() == text:        # built by an earlier run
            notes[name] = ["built before, from the same source"]
            continue
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               "-I", str(_build.CSRC), "-o", str(OUT / f"{name}.so"),
               str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        notes[name] = forward_notes(log)
    return notes


def _mean_ms(fn, reps: int, queued: bool = False) -> float:
    """CUDA-event ms a call over `reps` calls; `queued`: the calls wait
    behind a spin kernel while the host enqueues them, so the time is the
    device's alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)            # tens of ms of spin
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _profiled_ms(fn):
    """Device ms of the kernels of one call of fn under torch.profiler
    (after one call that is not recorded), or None if it records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            prof.step()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and not e.name.startswith("ProfilerStep")]
    return sum(us) / 1e3 if us else None


def time_variant(name: str, shape, reps: int = 20,
                 dtype: str = "bfloat16") -> dict:
    """Per layout, three rounds of (kernel ms, SDPA ms) with the variant's
    library and the largest |kernel - SDPA|, on tensors of `dtype` from a
    seeded generator: "model", the (B, H, S, D) views of the model's (B,
    S, H, D) tensors; "contiguous", (B, H, S, D) tensors (as
    `chip_smoke.py` times them)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    _build._libs["flash_attention"] = ctypes.CDLL(str(OUT / f"{name}.so"))
    B, H, KV, S, D = shape
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    model = [torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).to(getattr(torch, dtype)).transpose(1, 2)
        for h in (H, KV, KV)]
    out = {}
    for layout, (q, k, v) in (("model", model), ("contiguous", [
            t.contiguous() for t in model])):
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        def kernel():
            return FA.flash_attention(q, k, v)

        err = (kernel().float() - sdpa().float()).abs()
        o, lse = FA.flash_attention_fwd(q, k, v)
        bits = hashlib.sha1(o.contiguous().view(torch.int16).cpu().numpy()
                            .tobytes() + lse.cpu().numpy().tobytes())
        rounds = [(_mean_ms(kernel, reps), _mean_ms(sdpa, reps))
                  for _ in range(3)]
        out[layout] = dict(
            rounds=rounds, max_abs_err=float(err.max()),
            queued=(_mean_ms(kernel, reps, queued=True),
                    _mean_ms(sdpa, reps, queued=True)),
            profiled_ms=_profiled_ms(kernel), bits=bits.hexdigest()[:16])
    return out


def dtype_of(text: str) -> str:
    """The operands' dtype of a --shape: float32 for the float32 presets,
    else bfloat16."""
    return "float32" if text in FLOAT32_PRESETS else "bfloat16"


def parse_shape(text: str) -> tuple:
    """A preset's (B, H, KV, S, D), or B,H,KV,S,D as written."""
    if text in PRESETS:
        return PRESETS[text]
    shape = tuple(int(x) for x in text.split(","))
    if len(shape) != 5:
        raise ValueError(f"--shape {text!r}: a preset "
                         f"({', '.join(PRESETS)}) or B,H,KV,S,D")
    return shape


def parent_refusal(shape: str):
    """Why ``--parent`` cannot run at ``--shape`` `shape`, or None: above
    D = 2048 (more than one walk) a parent before the walks runs
    widebody, through another launcher and a workspace this wrapper does
    not allocate."""
    if parse_shape(shape)[4] > _bwd_ablate.ONE_WALK:
        return ("--parent runs D <= 2048 only: above it a parent before the "
                "walks runs widebody")
    return None


def default_variants(shapes) -> list:
    """The variants run when --variants is not given: every one, or base
    and the ``cl_*`` ones when a shape is above D = 256 (whose other
    variants change bodies it does not run, or its D = 256 body alone)."""
    if any(parse_shape(s)[4] > 256 for s in shapes):
        return ["base", *(n for n in PATCHES if n.startswith("cl_"))]
    return list(PATCHES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", action="append",
                    help="a preset (yi, zamba2, danube, whisper, wide, "
                         "wide_f32, d512, d512_f32, d2304, d2304_f32) "
                         "or B,H,KV,S,D; repeatable (default: the four "
                         "model presets)")
    ap.add_argument("--variants",
                    help="comma-separated variants (default: all, or base "
                         "and the cl_* ones above D = 256)")
    ap.add_argument("--parent", help="another flash_attention.cu, timed "
                    "as variant 'parent' first and last")
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = args.shape or list(MODEL_PRESETS)
    for s in shapes:
        parse_shape(s)
    if args.variant:                    # one variant, in its own process
        for s in shapes:
            for layout, r in time_variant(args.variant, parse_shape(s),
                                          dtype=dtype_of(s)).items():
                print(f"variant {args.variant}, {s} {dtype_of(s)}, "
                      f"{layout} layout: "
                      f"kernel / SDPA ms "
                      f"{[(round(a, 4), round(b, 4)) for a, b in r['rounds']]}"
                      f", kernel / SDPA "
                      f"{[round(a / b, 3) for a, b in r['rounds']]}, "
                      f"max|kernel - SDPA| {r['max_abs_err']:.3e}; "
                      f"device-only kernel / SDPA ms "
                      f"{tuple(round(x, 4) for x in r['queued'])}; one "
                      f"profiled kernel call "
                      + (f"{r['profiled_ms']:.4f} ms"
                         if r["profiled_ms"] is not None
                         else "not measured")
                      + f"; o and lse bits {r['bits']}", flush=True)
        return 0
    if args.parent:
        for s in shapes:
            if parent_refusal(s):
                raise SystemExit(parent_refusal(s))
    names = ([n for n in args.variants.split(",") if n] if args.variants
             else default_variants(shapes))
    for n in names:
        if n not in PATCHES:
            raise SystemExit(f"unknown variant {n!r}: {', '.join(PATCHES)}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(f"card: {card[0] if card else 'nvidia-smi gave nothing'}",
          flush=True)
    t0 = time.perf_counter()
    extra = ["parent"] if args.parent else []
    notes = build(dict.fromkeys([*extra, "base", *names]), args.parent)
    print(f"built {len(notes)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, lines in notes.items():
        print(f"ptxas, variant {name}: "
              + ("; ".join(lines) if lines else
                 "no C7520 warning and no spill line in the forward bodies"),
              flush=True)
    order = [*extra, "base", *(n for n in names if n != "base"), "base",
             *extra]
    shape_args = [a for s in shapes for a in ("--shape", s)]
    for name in order:
        r = subprocess.run(["timeout", "-k", "5", "120", sys.executable,
                            "-m", "repro_torch.launch.fwd_ablate",
                            *shape_args, "--variant", name],
                           capture_output=True, text=True)
        print(r.stdout.strip() or f"variant {name}: exit {r.returncode} "
              f"{r.stderr.strip()[-500:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
