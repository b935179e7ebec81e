"""Where the flash backward's time goes: `flash_attention_bwd` at one
shape, timed with source variants of its tensor-core pass that each drop
one piece of work.

Each variant is ``csrc/flash_attention.cu`` with a text patch inside the
``bf16bwd`` namespace, built with nvcc into ``build/repro_torch/ablate/``
and run in a process of its own (a variant whose waits can no longer be
met would hang; each process has a time limit).  The variants give wrong
gradients by design: they are timed, never checked.

    base        the kernel as it is
    no_handoff  dq's share computed but never handed to the writer, and
                the diagonal tiles not finished: the five products alone
    no_finish   the diagonal tiles' last shares not finished
    no_order    no counter waits: the adds to a tile in any order
    no_turns    the consumers issue S^T and dP^T without taking turns

Run on a card (CUDA events, the mean of 20 calls, three rounds each):

    PYTHONPATH=src python -m repro_torch.launch.bwd_ablate [--shape B,H,KV,S,D]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time

from repro_torch.kernels import _build

OUT = _build.BUILD_DIR / "ablate"

_HANDOFF = "        if (!last) share(bh, qi, kt, act);"
_FINISH = "        if (last && act) finish(bh, qi, kt);"
PATCHES = {
    "base": [],
    "no_handoff": [(_HANDOFF, ""), (_FINISH, "")],
    "no_finish": [(_FINISH, "")],
    "no_order": [("          wait_count(cnt, kt);\n", ""),
                 ("if (tid == 0) wait_count(sem + bh * nQ + qi, kt);", "")],
    "no_turns": [("bar_sync(1 + w);", ""), ("bar_arrive(2 - w);", ""),
                 ("if (w == 1) bar_arrive(1);", ""),
                 ("if (w == 0) bar_sync(1);", "")],
}


def variant_source(name: str) -> str:
    """The source of one variant (raises if a patch no longer applies)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    a, b = src.index("namespace bf16bwd {"), src.index(
        "}  // namespace bf16bwd")
    body = src[a:b]
    for old, new in PATCHES[name]:
        if old not in body:
            raise ValueError(f"variant {name}: {old!r} not in the source")
        body = body.replace(old, new)
    return src[:a] + body + src[b:]


def build(names) -> None:
    """One nvcc per variant, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(name))
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.CSRC),
               "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")


def time_variant(name: str, shape, reps: int = 20) -> list:
    """Three rounds of the mean ms of `reps` backward calls with the
    variant's library, on the (B, H, S, D) views of (B, S, H, D) tensors
    from a seeded generator."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as FA
    _build._libs["flash_attention"] = ctypes.CDLL(str(OUT / f"{name}.so"))
    B, H, KV, S, D = shape
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).bfloat16().transpose(1, 2)
        for h in (H, KV, KV, H))
    o, lse = FA.flash_attention_fwd(q, k, v)
    out = []
    for _ in range(3):
        FA.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            FA.flash_attention_bwd(q, k, v, o, lse, do)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="4,32,4,2048,128",
                    help="B,H,KV,S,D (default: yi-6b's training shape)")
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.shape.split(","))
    if args.variant:                    # one variant, in its own process
        ms = time_variant(args.variant, shape)
        print(f"variant {args.variant}: backward ms "
              f"{[round(x, 4) for x in ms]}", flush=True)
        return 0
    t0 = time.perf_counter()
    build(PATCHES)
    print(f"built {len(PATCHES)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in PATCHES:
        r = subprocess.run(["timeout", "-k", "5", "60", sys.executable, "-m",
                            "repro_torch.launch.bwd_ablate", "--shape",
                            args.shape, "--variant", name],
                           capture_output=True, text=True)
        print(r.stdout.strip() or f"variant {name}: exit {r.returncode} "
              f"{r.stderr.strip()[-500:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
