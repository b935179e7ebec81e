"""Where the flash backward's time goes: `flash_attention_bwd` at one
shape, timed with source variants of its tensor-core passes that each drop
or change one piece of work.

Each variant is ``csrc/flash_attention.cu`` with a text patch inside one
body's namespace (``bf16bwd`` for D <= 128, ``widebwd`` for the D = 256
body, the ``wide_*`` variants, ``f32bwd`` for the float32 body at D <=
128, the ``f32_*`` variants, ``f32widebwd`` for the float32 body at
D = 256, the ``f32w_*`` variants, ``clusterbwd`` for the cluster
backward's exchange above D = 256, the ``cl_*`` variants, which both
dtypes' cluster bodies share), built with nvcc (``-Xptxas -v``) into
``build/repro_torch/ablate/`` and run in a process of its own (a variant
whose waits can no longer be met would hang; each process has a time
limit), in the order base, the variants, base.  The variants that drop
work give wrong gradients by design: they are timed, never checked.  The
build prints the backward bodies' registers and spill bytes and ptxas'
C7520 warnings (wgmma serialized).

    base           the kernel as it is
    no_handoff     dq's share computed but never handed to the writer, and
                   the diagonal tiles not finished: the five products alone
    no_finish      the diagonal tiles' last shares not finished
    no_order       no counter waits: the adds to a tile in any order
    no_turns       the consumers issue S^T and dP^T without taking turns
    wide_one_slot  the D = 256 body with one Q / dO slot (two in the
                   kernel): a slot's share is added before it is loaded
                   again, with nothing between
    wide_store     the D = 256 body's shares stored over the accumulator's
                   tile, not added to it: the same bytes, no reduction
    wide_no_order  the D = 256 body without its counter waits
    wide_no_dq     the D = 256 body's dq shares computed and staged, never
                   added to the accumulator, the diagonal tiles not waiting
    wide_no_stage  as wide_no_dq, and the shares not staged either: the
                   five products, the softmax and the protocol alone
    wide_no_exp    the D = 256 body with P = S * scale - lse, no ex2
    wide_no_mma    the D = 256 body without its dq, dv and dk products (S
                   and dP alone on the tensor cores)
    f32_no_dq      the float32 body's dq shares computed and staged, never
                   added to the accumulator (no counter waits, the
                   diagonal tiles not waiting): what the hand-off costs
    f32_no_exp     the float32 body with P = S * scale - lse, no expf
    f32_no_sdp     the float32 body without its S and dP products
    f32_no_kv      the float32 body without its dv and dk products
    f32_no_dqmm    the float32 body without its dq product (the shares
                   still staged and added)
    f32w_no_dq, f32w_no_exp, f32w_no_sdp, f32w_no_kv, f32w_no_dqmm
                   the same five on the float32 D = 256 body (f32widebwd)
    cl_no_sum      the cluster backward (D > 256) with its exchange's reads
                   cut: each block keeps its own partial S and dP, the
                   arrivals and waits as they are
    cl_no_sync     the cluster backward without the exchange's arrivals
                   and waits (the reads and sums as they are, racing)
    cl_no_xch      the cluster backward with neither: the D = 256 bodies
                   on their slices alone
    cl_one_slice   the cluster backward's walks (above D = 2048) without
                   their other slices: S and dP over the owned slice
                   alone, as at one walk (no other slice loaded or
                   multiplied): what the recomputed S and dP cost

Shapes (--shape, a preset or B,H,KV,S,D):

    yi    4, 32, 4, 2048, 128   (yi-6b's training shape, the default)
    wide  4, 8, 2, 2048, 256    (yi's batch and GQA group of 4 at a
                                 Gemma-style head dim: the D = 256 body)
    f32   4, 32, 4, 2048, 128   (yi's shape in float32 operands, as a
                                 float32 model trains: the f32bwd body)
    wide_f32  4, 8, 2, 2048, 256   (the wide shape in float32 operands:
                                    the f32widebwd body)
    d512  1, 8, 2, 2048, 512    (the wide shape at B 1 and D = 512: the
                                 cluster backward, two blocks a cluster)
    d512_f32  1, 8, 2, 2048, 512   (the same in float32 operands)
    d2304 1, 2, 1, 2048, 2304   (a head dim above 2048: 9 slices, clusters
                                 of 5 blocks in two walks)
    d2304_f32  1, 2, 1, 2048, 2304  (the same in float32 operands)

The presets run bfloat16 operands, except f32, wide_f32, d512_f32 and
d2304_f32, which run float32; a shape written out runs bfloat16.  A shape
above D = 256 runs the ``cl_*`` variants by default.

Run on a card (CUDA events, the mean of 20 calls, three rounds each, on
the (B, H, S, D) views of (B, S, H, D) tensors from a seeded generator;
each process also times SDPA's backward on the same inputs, one autograd
call on a retained graph, and prints a digest of dq's, dk's and dv's
bits):

    PYTHONPATH=src python -m repro_torch.launch.bwd_ablate \\
        [--shape wide|f32|wide_f32] [--variants base,wide_no_dq] \\
        [--parent OTHER/src/repro_torch/kernels/csrc/flash_attention.cu]

--parent adds a variant "parent": that file as it is (say, a parent
commit's, unpacked with ``git archive``), run first and last (parent,
base, the variants, base, parent); equal digests show equal bits.  Its
``flash_attention_bwd_launch`` must take the arguments this wrapper
passes, with the scratch this wrapper allocates: so D <= 2048 only (one
walk; above it a parent before the walks runs simplebwd, whose scratch is
another).  The float32 presets up to 2048 qualify too.
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

OUT = _build.BUILD_DIR / "ablate"

#: (B, H, KV, S, D) of the presets
PRESETS = {"yi": (4, 32, 4, 2048, 128), "wide": (4, 8, 2, 2048, 256),
           "f32": (4, 32, 4, 2048, 128), "wide_f32": (4, 8, 2, 2048, 256),
           "d512": (1, 8, 2, 2048, 512), "d512_f32": (1, 8, 2, 2048, 512),
           "d2304": (1, 2, 1, 2048, 2304), "d2304_f32": (1, 2, 1, 2048, 2304)}
#: the presets that run float32 operands (the others bfloat16)
FLOAT32_PRESETS = ("f32", "wide_f32", "d512_f32", "d2304_f32")
#: the widest head dim of one walk: a parent's cluster bodies run it with
#: this wrapper's scratch
ONE_WALK = 2048

#: the namespace each body's source lives in (the cluster backward's
#: exchange: the helpers both D = 256 bodies call above D = 256)
NAMESPACES = {"narrow": "bf16bwd", "wide": "widebwd", "f32": "f32bwd",
              "f32w": "f32widebwd", "cl": "clusterbwd"}

_HANDOFF = "        if (!last) share(bh, qi, kt, act);"
_FINISH = "        if (last && act) finish(bh, qi, kt);"
_WIDE_WAIT = "          wait_count(cnt, kt);\n"
_WIDE_NO_ADD = ("        if (meta[4 * slot + 3]) return;\n",
                "        return;\n")
_WIDE_DIAG_WAIT = ("            if (tid == 0) wait_count(sem + bh * nQ + qi, "
                   "kt);\n")
PATCHES = {
    "base": [],
    "no_handoff": [(_HANDOFF, ""), (_FINISH, "")],
    "no_finish": [(_FINISH, "")],
    "no_order": [("          wait_count(cnt, kt);\n", ""),
                 ("if (tid == 0) wait_count(sem + bh * nQ + qi, kt);", "")],
    "no_turns": [("bar_sync(1 + w);", ""), ("bar_arrive(2 - w);", ""),
                 ("if (w == 1) bar_arrive(1);", ""),
                 ("if (w == 0) bar_sync(1);", "")],
    "wide_one_slot": [("constexpr int STAGES = 2;",
                       "constexpr int STAGES = 1;")],
    "wide_store": [("          if (kt == 0) bulk_store(dst + r * QT * 64, src, "
                    "2 * G::CHUNK);\n          else bulk_add(",
                    "          if (kt >= 0) bulk_store(dst + r * QT * 64, src, "
                    "2 * G::CHUNK);\n          else bulk_add(")],
    "wide_no_order": [(_WIDE_WAIT, ""), (_WIDE_DIAG_WAIT, "")],
    "wide_no_dq": [_WIDE_NO_ADD, (_WIDE_DIAG_WAIT, "")],
    "wide_no_stage": [_WIDE_NO_ADD, (_WIDE_DIAG_WAIT, ""),
                      ("          stage(slot);\n", "")],
    "wide_no_exp": [("              float p = ex2(fmaf(st[i], scale_log2, "
                     "-l2));\n",
                     "              float p = fmaf(st[i], scale_log2, -l2);"
                     "\n")],
    "wide_no_mma": [("        dq_product(dst);                         // dq's "
                     "share: dS K\n"
                     "        accumulate(dv_acc, pt, dos);             // dv += "
                     "P^T dO\n"
                     "        accumulate(dk_acc, dst, qs);             // dk += "
                     "dS^T Q\n", "")],
    "f32_no_dq": [("      int* cnt = sem + p_bh * nQ + p_qi;\n",
                   "      mbar_arrive(freed);\n      ++n_sh;\n      if (n_sh > 0) "
                   "return;\n      int* cnt = sem + p_bh * nQ + p_qi;\n"),
                  ("            if (tid == 0) wait_count(sem + bh * nQ + qi, "
                   "kt);\n", "")],
    "f32_no_exp": [("? expf(fmaf(x[r][c], scale, -ls)) : 0.f;",
                    "? fmaf(x[r][c], scale, -ls) : 0.f;")],
    "f32_no_sdp": [("        for (int ch = 0; ch < T::NC; ++ch) {",
                    "        for (int ch = 0; ch < 0; ++ch) {")],
    "f32_no_kv": [("        for (int i = 0; i < QT; ++i) {",
                   "        for (int i = 0; i < 0; ++i) {")],
    "f32_no_dqmm": [("        for (int j = 0; j < KT; ++j) {",
                     "        for (int j = 0; j < 0; ++j) {")],
}
# the cluster backward's exchange: its reads of the ranks' partials, and
# its arrivals and waits
_CL_SUM = ("  for (int p = 0; p < C; ++p) {\n    const uint32_t ra = mapa(a, p);",
           "  for (int p = 0; p < 0; ++p) {\n    const uint32_t ra = mapa(a, p);")
_CL_SYNC = [("      if (p != r) arrive(mapa(bar, p));\n", "      ;\n"),
            ("  wait(bar, (it >> 1) & 1);\n", "")]
# the walks' other slices (above D = 2048): none
_CL_ONE_SLICE = [("  return (slices - rank + C - 1) / C;\n", "  return 1;\n"),
                 ("  return ns - (walk < ns ? 1 : 0);\n", "  return 0;\n")]
PATCHES.update({"cl_no_sum": [_CL_SUM], "cl_no_sync": _CL_SYNC,
                "cl_no_xch": [_CL_SUM, *_CL_SYNC],
                "cl_one_slice": _CL_ONE_SLICE})
# the float32 D = 256 body: the same five cuts (its S and dP split D)
PATCHES.update({
    "f32w_no_dq": PATCHES["f32_no_dq"],
    "f32w_no_exp": [("? expf(fmaf(z[c], scale, -ls)) : 0.f;",
                     "? fmaf(z[c], scale, -ls) : 0.f;")],
    "f32w_no_sdp": [("        for (int t = 0; t < D / 4 / PARTS; ++t) {",
                     "        for (int t = 0; t < 0; ++t) {")],
    "f32w_no_kv": PATCHES["f32_no_kv"],
    "f32w_no_dqmm": PATCHES["f32_no_dqmm"],
})


def body_of(name: str) -> str:
    """The body a variant patches: "wide" (the D = 256 body), "f32" (the
    float32 body), "f32w" (the float32 D = 256 body), "cl" (the cluster
    backward's exchange) or "narrow" (bfloat16 D <= 128)."""
    for body in ("wide", "f32", "f32w", "cl"):
        if name.startswith(body + "_"):
            return body
    return "narrow"


def span(src: str, body: str) -> tuple:
    """(start, end) of a body's namespace in the source."""
    ns = NAMESPACES[body]
    return src.index(f"namespace {ns} {{"), src.index(f"}}  // namespace {ns}")


def variant_source(name: str, parent=None) -> str:
    """The source of one variant (raises if a patch does not apply exactly
    once inside its body's namespace); "parent" is the file `parent` as it
    is."""
    if name == "parent":
        return open(parent).read()
    src = (_build.CSRC / "flash_attention.cu").read_text()
    a, b = span(src, body_of(name))
    body = src[a:b]
    for old, new in PATCHES[name]:
        if body.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} not once in the "
                             "source")
        body = body.replace(old, new)
    return src[:a] + body + src[b:]


def backward_notes(log: str) -> list:
    """From an ``nvcc -Xptxas -v`` log: ptxas' C7520 warnings and, per
    backward body (``flash_bwd_kernel<D>``, ``<256>`` for
    ``flash_bwd_kernel_d256``, ``f32<D>`` for ``flash_bwd_f32_kernel<D>``),
    its registers and spill bytes; ``f32<256>`` for
    ``flash_bwd_f32_wide_kernel``, and ``<256 cluster>`` and ``f32<256
    cluster>`` for the two with CL = true (the cluster backward), with
    `` walks`` after the walks' instantiations."""
    out, fn = [], None
    for line in log.splitlines():
        body = re.search(r"flash_bwd_kernelILi(\d+)E", line)
        f32 = re.search(r"flash_bwd_f32_kernelILi(\d+)E", line)
        name = (f"<{body[1]}>" if body else f"f32<{f32[1]}>" if f32 else
                "<256 cluster walks>"
                if "flash_bwd_kernel_d256ILb1ELb1E" in line else
                "<256 cluster>" if "flash_bwd_kernel_d256ILb1E" in line else
                "<256>" if "flash_bwd_kernel_d256" in line else
                "f32<256 cluster walks>"
                if "flash_bwd_f32_wide_kernelILb1ELb1E" in line else
                "f32<256 cluster>" if "flash_bwd_f32_wide_kernelILb1E" in line
                else "f32<256>" if "flash_bwd_f32_wide_kernel" in line
                else None)
        if "C7520" in line:
            out.append("C7520: " + line.strip()[-160:])
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
    """One nvcc per variant, all started together; {variant: the backward
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
        notes[name] = backward_notes(log)
    return notes


def _mean_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_variant(name: str, shape, reps: int = 20,
                 dtype: str = "bfloat16") -> dict:
    """Three rounds of (backward ms, SDPA's backward ms) with the
    variant's library, on the (B, H, S, D) views of (B, S, H, D) tensors
    of `dtype` from a seeded generator, and a digest of the gradients'
    bits."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    _build._libs["flash_attention"] = ctypes.CDLL(str(OUT / f"{name}.so"))
    B, H, KV, S, D = shape
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).to(getattr(torch, dtype)).transpose(1, 2)
        for h in (H, KV, KV, H))
    o, lse = FA.flash_attention_fwd(q, k, v)
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do)
    bits = hashlib.sha1(b"".join(g.contiguous().view(torch.int16).cpu()
                                 .numpy().tobytes() for g in grads))
    lib_in = [x.detach().requires_grad_() for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)

    def kernel():
        return FA.flash_attention_bwd(q, k, v, o, lse, do)

    def sdpa():
        return torch.autograd.grad(lib_out, lib_in, do, retain_graph=True)

    rounds = [(_mean_ms(kernel, reps), _mean_ms(sdpa, reps))
              for _ in range(3)]
    return dict(rounds=rounds, bits=bits.hexdigest()[:16])


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
    simplebwd, whose scratch is not the one this wrapper allocates.
    (Every body up to 2048, the float32 ones included, takes this
    wrapper's.)"""
    if parse_shape(shape)[4] > ONE_WALK:
        return ("--parent runs D <= 2048 only: above it a parent before the "
                "walks takes another scratch")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="yi",
                    help="a preset (yi, wide, f32, wide_f32, d512, "
                         "d512_f32, d2304, d2304_f32) or B,H,KV,S,D "
                         "(default: "
                         "yi, yi-6b's training shape)")
    ap.add_argument("--variants", help="comma-separated variants (default: "
                    "those of the shape's body)")
    ap.add_argument("--parent", help="another flash_attention.cu, run as "
                    "variant 'parent' first and last")
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shape = parse_shape(args.shape)
    dtype = "float32" if args.shape in FLOAT32_PRESETS else "bfloat16"
    if args.variant:                    # one variant, in its own process
        r = time_variant(args.variant, shape, dtype=dtype)
        print(f"variant {args.variant}, {args.shape} {dtype}: backward / "
              f"SDPA's "
              f"backward ms "
              f"{[(round(a, 4), round(b, 4)) for a, b in r['rounds']]}, "
              f"ratio {[round(a / b, 3) for a, b in r['rounds']]}; dq, dk, "
              f"dv bits {r['bits']}", flush=True)
        return 0
    if args.parent and parent_refusal(args.shape):
        raise SystemExit(parent_refusal(args.shape))
    wide = 128 < shape[4] <= 256
    mine = ("cl" if shape[4] > 256 else
            ("f32w" if wide else "f32") if dtype == "float32" else
            "wide" if wide else "narrow")
    names = ([n for n in args.variants.split(",") if n] if args.variants
             else [n for n in PATCHES if n != "base" and body_of(n) == mine])
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
                 "no C7520 warning and no spill line in the backward bodies"),
              flush=True)
    order = [*extra, "base", *(n for n in names if n != "base"), "base",
             *extra]
    for name in order:
        r = subprocess.run(["timeout", "-k", "5", "120", sys.executable,
                            "-m", "repro_torch.launch.bwd_ablate",
                            "--shape", args.shape, "--variant", name],
                           capture_output=True, text=True)
        print(r.stdout.strip() or f"variant {name}: exit {r.returncode} "
              f"{r.stderr.strip()[-500:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
