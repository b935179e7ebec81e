"""What h2o-danube's own forward body buys: `flash_attention` at a head
dim of 120, timed with the D = 128 body built at that width
(`flash_fwd_bf16_kernel<128, 120>`: a 120-column P V product and
accumulator) and with the runtime-width body that every other narrow
multiple of 8 takes (`flash_fwd_bf16_kernel<128, 0>`: all 128 columns,
the stores checked against the width).

Each variant is ``csrc/flash_attention.cu`` with a text patch, built
with nvcc into ``build/repro_torch/fwd_ablate/`` and run in a process of
its own, in the order base, runtime_width, runtime_width, base.  Both
give the same answer; each process prints its largest difference from
SDPA.

    base           the kernel as it is
    runtime_width  width 120 through the runtime-width body

Run on a card (CUDA events, the mean of 20 calls, three rounds each, on
the model's (B, S, H, D) layout and on contiguous (B, H, S, D) tensors;
each process also times `scaled_dot_product_attention` on the same
inputs):

    PYTHONPATH=src python -m repro_torch.launch.fwd_ablate [--shape B,H,KV,S,D]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time

from repro_torch.kernels import _build

OUT = _build.BUILD_DIR / "fwd_ablate"

PATCHES = {
    "base": [],
    "runtime_width": [
        ("  if constexpr (D == 128)\n"
         "    if (width == 120) fn = flash_fwd_bf16_kernel<128, 120>;\n",
         "")],
}


def variant_source(name: str) -> str:
    """The source of one variant (raises if a patch no longer applies)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} not once in the "
                             "source")
        src = src.replace(old, new)
    return src


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


def time_variant(name: str, shape, reps: int = 20) -> dict:
    """Per layout, three rounds of (kernel ms, SDPA ms) with the variant's
    library and the largest |kernel - SDPA|, on bf16 tensors from a seeded
    generator: "model", the (B, H, S, D) views of the model's (B, S, H, D)
    tensors; "contiguous", (B, H, S, D) tensors (as `chip_smoke.py`
    times them)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    _build._libs["flash_attention"] = ctypes.CDLL(str(OUT / f"{name}.so"))
    B, H, KV, S, D = shape
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    model = [torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(
        np.float32), device=dev).bfloat16().transpose(1, 2)
        for h in (H, KV, KV)]
    out = {}
    for layout, (q, k, v) in (("model", model), ("contiguous", [
            t.contiguous() for t in model])):
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        err = (FA.flash_attention(q, k, v).float() - sdpa().float()).abs()
        rounds = [(_mean_ms(lambda: FA.flash_attention(q, k, v), reps),
                   _mean_ms(sdpa, reps)) for _ in range(3)]
        out[layout] = dict(rounds=rounds, max_abs_err=float(err.max()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="4,32,8,2048,120",
                    help="B,H,KV,S,D (default: h2o-danube-3-4b's prefill "
                         "shape)")
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.shape.split(","))
    if args.variant:                    # one variant, in its own process
        for layout, r in time_variant(args.variant, shape).items():
            print(f"variant {args.variant}, {layout} layout: kernel / SDPA "
                  f"ms {[(round(a, 4), round(b, 4)) for a, b in r['rounds']]}"
                  f", kernel / SDPA "
                  f"{[round(a / b, 3) for a, b in r['rounds']]}, "
                  f"max|kernel - SDPA| {r['max_abs_err']:.3e}", flush=True)
        return 0
    t0 = time.perf_counter()
    build(PATCHES)
    print(f"built {len(PATCHES)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("base", "runtime_width", "runtime_width", "base"):
        r = subprocess.run(["timeout", "-k", "5", "120", sys.executable,
                            "-m", "repro_torch.launch.fwd_ablate",
                            "--shape", args.shape, "--variant", name],
                           capture_output=True, text=True)
        print(r.stdout.strip() or f"variant {name}: exit {r.returncode} "
              f"{r.stderr.strip()[-500:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
