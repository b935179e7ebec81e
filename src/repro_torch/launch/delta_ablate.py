"""Where `gee_delta_renorm`'s time goes: the kernel at the smoke's shapes,
timed with source variants of ``csrc/query_fused.cu`` that each change or
drop one piece of `delta_renorm_kernel`, and beside a parent's kernel.

Each variant is built with nvcc (``-Xptxas -v``) into
``build/repro_torch/delta_ablate/`` and timed in a process of its own (a
variant whose waits can no longer be met would hang; each process has a
time limit).  The variants that drop work give wrong answers by design:
they are timed, never checked.

    base       the kernel as it is
    copy_only  no delta and no norm: the producer's bulk copies alone, Z
               into the stage and from it to both outputs (the card's
               rate for these bytes through this ring, the yardstick for
               the gap to the datasheet bound)
    no_delta   no range search and no adds (the norms and both stores)
    no_norm    no norm chains and no division (Zn = Z_new, K >= 4)
    stages_2   a ring of two stages instead of four
    stages_3   a ring of three
    tile_8k    tiles of about 8,192 floats (32 KB) instead of 4,096
    one_block  one block an SM instead of two
    divide_zeros
               every element through __fdiv_rn, zeros too
    branch_zeros
               the division branched around for zeros (not run on 1)
    not_held   the values read from the stage again for Zn and the
               stage let go after Zn, not after the squares
    blocks_3_stages_3, tile_3k_blocks_3, tile_2k_blocks_4,
    tile_2k_blocks_5
               more blocks an SM, each with a ring of fewer or smaller
               stages (the occupancy API has the last word)

Shapes: the smoke's delta shapes, each with a seeded 400-entry delta of
sorted rows (the size of a 200-edge delta's contributions): shard 0 of
the main SBM (n_local = 2,423,786, K = 16; uniform random Z, and
"sparse" with 7 of 8 entries zero, as a GEE embedding with few
labelled neighbours a node has), 262,144 rows at K = 200, and the sweep
at n_local = 1,048,576, K = 16, 64, 128, 129, 172, 200, 256, 512, and
("chunked", not run by default) 4,096 rows at K = 20,000, too wide for
three stages, so each row streams through the ring in column chunks,
twice.  Times are CUDA-event means of 20 calls, three rounds, with the
stream held by a spin kernel while the calls are queued (device time
alone); the base variant also times the library's clone + `index_put_`
+ `F.normalize` the same way and prints the launcher's plan
(`query_fused.delta_info`).  Every variant prints SHA-256 digests of
Z_new's and Zn's bits; those that keep the arithmetic (all but
copy_only, no_delta and no_norm) must agree at every shape, and the run
ends non-zero where they do not or where ptxas reports a spill in the
base kernel.

    PYTHONPATH=src python -m repro_torch.launch.delta_ablate \\
        [--variants base,copy_only] [--shapes main,sweep] \\
        [--parent REV | --parent OTHER/csrc/query_fused.cu]

--parent adds a variant "parent", run first and last: a commit's
``query_fused.cu`` (by ``git show``, with its ``common.cuh``) or a file
as it is (built against its own directory's headers).  Its
``delta_renorm_launch`` must take the arguments this wrapper passes.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.kernels import _build

OUT = _build.BUILD_DIR / "delta_ablate"
SRC_REL = "src/repro_torch/kernels/csrc"


def _const(name: str, value: int):
    """A patch that sets `constexpr int name` to value."""
    line = re.search(rf"constexpr int {name} = \d+;",
                     (_build.CSRC / "query_fused.cu").read_text())[0]
    return line, f"constexpr int {name} = {value};"


def _tile(floats):
    return _const("DELTA_TILE_FLOATS", floats)


def _blocks(n):
    return _const("DELTA_BLOCKS_PER_SM", n)


def _stages(n):
    return _const("DELTA_STAGES", n)


_RANGE = ("  const int p = from + lane;\n"
          "  const int v = p < m ? __ldg(rows + p) : INT_MAX;\n")
_NO_SEARCH = (_RANGE, "  if (m >= 0) return make_int2(from, from);\n" + _RANGE)
PATCHES = {
    "base": [],
    "copy_only": [
        _NO_SEARCH,
        ("          store_groups(tj, stage + (size_t)s * stage_floats, Znew);\n",
         "          store_groups(tj, stage + (size_t)s * stage_floats, Znew),\n"
         "              store_groups(tj, stage + (size_t)s * stage_floats, "
         "Zn);\n"),
        ("    const int2 r2 = rng[s];\n",
         "    const int2 r2 = rng[s];\n"
         "    if (r2.x >= 0) {\n"
         "      __syncwarp();\n"
         "      if (lane == 0) {\n"
         "        mbar_arrive(smem_addr(added + s));\n"
         "        mbar_arrive(smem_addr(empty + s));\n"
         "      }\n"
         "      continue;\n"
         "    }\n")],
    "no_delta": [_NO_SEARCH],
    "no_norm": [("    for (int r = tid; norm && r < t.nr; r += "
                 "DELTA_CONSUMERS) {\n",
                 "    for (int r = tid; r < 0; r += DELTA_CONSUMERS) {\n"),
                ("        z[q] = quotient(a.v[q], next ? d1 : d0);\n",
                 "        z[q] = a.v[q];\n")],
    "divide_zeros": [("  const float q = __fdiv_rn(z != 0.f ? z : 1.f, d);\n"
                      "  return z != 0.f ? q : z;",
                      "  return __fdiv_rn(z, d);")],
    "branch_zeros": [("  const float q = __fdiv_rn(z != 0.f ? z : 1.f, d);\n"
                      "  return z != 0.f ? q : z;",
                      "  return z == 0.f ? z : __fdiv_rn(z, d);")],
    "stages_2": [("constexpr int DELTA_STAGES = 4;",
                  "constexpr int DELTA_STAGES = 2;"),
                 ("constexpr int DELTA_MIN_STAGES = 3;",
                  "constexpr int DELTA_MIN_STAGES = 2;")],
    "stages_3": [_stages(3)],
    "tile_8k": [_tile(8192)],
    "one_block": [_blocks(1)],
    "not_held": [("    const bool held = end - g0 <= 4LL * DELTA_GROUPS * "
                  "DELTA_CONSUMERS;\n", "    const bool held = false;\n")],
    "blocks_3_stages_3": [_blocks(3), _stages(3)],
    "tile_3k_blocks_3": [_tile(3072), _blocks(3)],
    "tile_2k_blocks_4": [_tile(2048), _blocks(4)],
    "tile_2k_blocks_5": [_tile(2048), _blocks(5)],
}
#: the variants whose Z_new and Zn must have the base kernel's bits
EXACT = ("base", "parent", "stages_2", "stages_3", "tile_8k", "one_block",
         "not_held", "divide_zeros", "branch_zeros",
         "blocks_3_stages_3", "tile_3k_blocks_3", "tile_2k_blocks_4",
         "tile_2k_blocks_5")
#: (name, n_local, K)
SHAPES = {"main": [("main", 2_423_786, 16)],
          "sparse": [("main_sparse", 2_423_786, 16)],
          "wide": [("K200", 262_144, 200)],
          "sweep": [(f"sweep_K{K}", 1 << 20, K)
                    for K in (16, 64, 128, 129, 172, 200, 256, 512)],
          "chunked": [("K20000", 4096, 20_000)]}


def variant_source(name: str) -> str:
    """The source of one variant (raises if a patch does not apply exactly
    once)."""
    src = (_build.CSRC / "query_fused.cu").read_text()
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} not once in the "
                             "source")
        src = src.replace(old, new)
    return src


def parent_source(parent: str) -> Path:
    """The parent's query_fused.cu in a directory of its own with the
    headers it includes: a file as it is (its directory's headers), or a
    commit's by `git show`."""
    if os.path.isfile(parent):
        return Path(parent).resolve()
    d = OUT / "parent_src"
    d.mkdir(parents=True, exist_ok=True)
    for f in ("query_fused.cu", "common.cuh"):
        text = subprocess.run(["git", "show", f"{parent}:{SRC_REL}/{f}"],
                              capture_output=True, text=True, check=True,
                              cwd=_build.CSRC.parents[3]).stdout
        (d / f).write_text(text)
    return d / "query_fused.cu"


def kernel_notes(log: str) -> list:
    """(registers, spill bytes stored + loaded) of `delta_renorm_kernel`
    from an ``nvcc -Xptxas -v`` log, one pair per entry found."""
    out, fn = [], False
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = "delta_renorm" in line
        elif fn and "spill stores" in line:
            sp = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            out.append([None, sum(sp)])
        elif fn and "Used" in line and "registers" in line:
            out[-1][0] = int(re.search(r"Used (\d+) registers", line)[1])
            fn = False
    return out


def build(names, parent=None) -> dict:
    """One nvcc per variant, all started together; {variant: ptxas notes
    of the delta kernel}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name == "parent":
            cu = parent_source(parent)
        else:
            cu = OUT / f"{name}.cu"
            cu.write_text(variant_source(name))
        inc = cu.parent if name == "parent" else _build.CSRC
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               "-I", str(inc), "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    notes = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        notes[name] = kernel_notes(log)
    return notes


def _device_ms(torch, fn, reps: int = 20) -> list:
    """Three rounds of ms a call: `reps` calls queued behind a spin kernel,
    between two CUDA events (the device's time alone)."""
    out = []
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(round(a.elapsed_time(b) / reps, 4))
    return out


def delta_inputs(torch, n_local: int, K: int, dev, seed: int = 0,
                 sparse: bool = False):
    """Z (n_local, K) from a seeded generator and a 400-entry delta of
    sorted local rows, classes and values.  sparse: 7 of 8 entries of Z
    zero, as in a GEE embedding where a node has few labelled
    neighbours."""
    import numpy as np
    gen = torch.Generator(device=dev).manual_seed(seed)
    Z = torch.rand((n_local, K), generator=gen, device=dev)
    if sparse:
        Z = Z * (torch.rand((n_local, K), generator=gen, device=dev) < 0.125)
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n_local, 400)).astype(np.int32)
    cls = rng.integers(0, K, 400).astype(np.int32)
    val = (rng.random(400, dtype=np.float32) / 64).astype(np.float32)
    return Z, *(torch.as_tensor(x, device=dev) for x in (rows, cls, val))


def bound_ms(n_local: int, K: int, m: int) -> float:
    """Bytes over the H100's 3.35 TB/s: Z read, Z_new and Zn written, the
    delta's 12 bytes an entry read."""
    from repro_torch.launch import roofline as RL
    return RL.bound_s(3 * n_local * K * 4 + 12 * m, m, RL.FP32_FLOPS)[0] \
        * 1e3


def time_variant(name: str, shapes) -> list:
    """Per shape: (tag, ms rounds, digests, extras) with the variant's
    library."""
    import torch

    from repro_torch.kernels import query_fused as QF
    _build._libs["query_fused"] = ctypes.CDLL(str(OUT / f"{name}.so"))
    dev = torch.device("cuda")
    out = []
    for tag, n_local, K in shapes:
        Z, r, c, v = delta_inputs(torch, n_local, K, dev,
                                  sparse=tag.endswith("_sparse"))
        zn_, zn2 = QF.gee_delta_renorm(Z, r, c, v)
        torch.cuda.synchronize()
        dig = [hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]
               for x in (zn_, zn2)]
        del zn_, zn2
        extra = {}
        if name == "base":
            def lib():
                Zx = Z.clone().index_put_((r.long(), c.long()), v,
                                          accumulate=True)
                return torch.nn.functional.normalize(Zx, dim=1, eps=1e-9)
            extra["library_ms"] = _device_ms(torch, lib, 5)
            extra["bound_ms"] = round(bound_ms(n_local, K, r.shape[0]), 4)
            extra["plan"] = QF.delta_info(Z)
        ms = _device_ms(torch, lambda: QF.gee_delta_renorm(Z, r, c, v))
        out.append((tag, ms, dig, extra))
        del Z, r, c, v
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", help="comma-separated variants (default: "
                    "all)")
    ap.add_argument("--shapes", default="main,sparse,wide,sweep",
                    help="comma-separated: main, sparse, wide, sweep, "
                    "chunked")
    ap.add_argument("--parent", help="a commit or another query_fused.cu, "
                    "run as variant 'parent' first and last")
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = [s for key in args.shapes.split(",") for s in SHAPES[key]]
    if args.variant:                    # one variant, in its own process
        for tag, ms, dig, extra in time_variant(args.variant, shapes):
            print(f"variant {args.variant} {tag}: ms {ms}; Z_new {dig[0]} "
                  f"Zn {dig[1]}" + "".join(f"; {k} {v}"
                                           for k, v in extra.items()),
                  flush=True)
        return 0
    names = ([n for n in args.variants.split(",") if n] if args.variants
             else list(PATCHES))
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
    for name, found in notes.items():
        print(f"ptxas, variant {name}, delta_renorm_kernel: "
              + "; ".join(f"{r_} registers, {s_} B spilled"
                          for r_, s_ in found), flush=True)
    ok = bool(notes["base"]) and all(s_ == 0 for _, s_ in notes["base"])
    order = [*extra, "base", *(n for n in names if n != "base"), "base",
             *extra]
    digests = {}
    for name in order:
        r = subprocess.run(["timeout", "-k", "5", "300", sys.executable,
                            "-m", "repro_torch.launch.delta_ablate",
                            "--shapes", args.shapes, "--variant", name],
                           capture_output=True, text=True)
        print(r.stdout.strip() or f"variant {name}: exit {r.returncode} "
              f"{r.stderr.strip()[-500:]}", flush=True)
        ok &= r.returncode == 0
        for line in r.stdout.splitlines():
            m = re.match(r"variant (\S+) (\S+): .*Z_new (\w+) Zn (\w+)", line)
            if m and m[1] in EXACT:
                digests.setdefault(m[2], set()).add((m[3], m[4]))
    same = all(len(d) == 1 for d in digests.values())
    print(f"digests of the exact variants equal at every shape: {same}",
          flush=True)
    return 0 if ok and same else 1


if __name__ == "__main__":
    sys.exit(main())
