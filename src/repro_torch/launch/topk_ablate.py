"""Where the chunked top-k body's time goes: `topk_fused`'s select pass
at one wide shape, timed with source variants of ``csrc/query_fused.cu``
that each change or drop one piece of the chunked body
(`topk_select_chunked_kernel`).

Each variant is built with nvcc into ``build/repro_torch/topk_ablate/``
and timed in a process of its own.  The variants that drop work give
wrong answers by design: they are timed, never checked.

    base         the kernel as it is
    rows_2       2 rows a thread instead of 4 (16 sums in registers)
    copy_4       4-byte copies into column-major slots (the body for K
                 % 4 != 0 or rows off 16 bytes) instead of 16-byte ones
    eager_merge  a merge after every tile with a survivor, not once a
                 buffer holds 32
    no_seed      the lists not seeded from each block's first tile
    no_filter    no filter and no merge after the tiles (the sums and the
                 streaming alone, and the block's last flush)

Run on a card (CUDA events, the mean of 10 calls, three rounds each; the
base variant also times both passes and `torch.topk(q @ Zn.T)`):

    PYTHONPATH=src python -m repro_torch.launch.topk_ablate [--K 300]
        [--m 262144] [--nq 64] [--k 10]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time

from repro_torch.kernels import _build

OUT = _build.BUILD_DIR / "topk_ablate"

_FILTER = "    filter(true, r0, rows);\n    pending = true;"
PATCHES = {
    "base": [],
    "rows_2": [("constexpr int RC = 4;", "constexpr int RC = 2;")],
    "copy_4": [("  p->vec = p->body == BODY_CHUNKED && vec && K % 4 == 0;",
                "  p->vec = false;")],
    "eager_merge": [("constexpr int MERGE_AT = 32;",
                     "constexpr int MERGE_AT = 1;")],
    "no_seed": [("    if (now.t == t0) {", "    if (false) {")],
    # the sums must stay live, or the compiler drops them
    "no_filter": [(_FILTER,
                   "    {\n      float x = 0.f;\n      for (int i = 0; i < Q; ++i)"
                   "\n        for (int r = 0; r < RC; ++r) x += acc[i][r];"
                   "\n      if (x == 1.2345e-7f) S.cnt[0] = 1;\n    }"
                   "\n    pending = true;")],
}


def variant_source(name: str) -> str:
    """The source of one variant (raises if a patch no longer applies)."""
    src = (_build.CSRC / "query_fused.cu").read_text()
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


def _mean_ms(torch, fn, reps: int = 10) -> list:
    out = []
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(round(a.elapsed_time(b) / reps, 4))
    return out


def time_variant(name: str, K: int, m: int, nq: int, k: int) -> dict:
    """The select pass's ms (three rounds) with the variant's library on
    m random unit rows of width K from a seeded generator, nq queries
    drawn from them; for base also both passes and the library call."""
    import torch

    from repro_torch.kernels import query_fused as QF
    _build._libs["query_fused"] = ctypes.CDLL(str(OUT / f"{name}.so"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Zn = QF.normalize_rows(torch.randn((m, K), generator=gen, device=dev))
    qn = torch.arange(0, m, max(1, m // nq), dtype=torch.int32,
                      device=dev)[:nq]
    q = Zn[qn.long()].contiguous()
    out = {"select_ms": _mean_ms(torch, lambda: QF._topk_select(
        Zn, q, qn, None, k=k, row_offset=0, exclude_self=True, eps=QF.EPS))}
    if name == "base":
        out["topk_fused_ms"] = _mean_ms(
            torch, lambda: QF.topk_fused(Zn, q, qn, k=k))
        out["library_ms"] = _mean_ms(
            torch, lambda: torch.topk(q @ Zn.T, k, dim=1))
        out["info"] = QF.select_info(Zn, k=k, nq=nq)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--K", type=int, default=300)
    ap.add_argument("--m", type=int, default=1 << 18)
    ap.add_argument("--nq", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shape = ["--K", str(args.K), "--m", str(args.m), "--nq", str(args.nq),
             "--k", str(args.k)]
    if args.variant:                    # one variant, in its own process
        res = time_variant(args.variant, args.K, args.m, args.nq, args.k)
        print(f"variant {args.variant}: " + ", ".join(
            f"{key} {val}" for key, val in res.items()), flush=True)
        return 0
    t0 = time.perf_counter()
    build(PATCHES)
    print(f"built {len(PATCHES)} variants in "
          f"{time.perf_counter() - t0:.1f} s; K={args.K} m={args.m} "
          f"nq={args.nq} k={args.k}", flush=True)
    for name in PATCHES:
        r = subprocess.run(["timeout", "-k", "5", "120", sys.executable,
                            "-m", "repro_torch.launch.topk_ablate", *shape,
                            "--variant", name],
                           capture_output=True, text=True)
        print(r.stdout.strip() or f"variant {name}: exit {r.returncode} "
              f"{r.stderr.strip()[-500:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
