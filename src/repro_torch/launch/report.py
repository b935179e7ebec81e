"""Render the dry run's tables from artifacts/dryrun_torch/*.json.

The port of `repro.launch.report`, reading the port's records (written
by `repro_torch.launch.dryrun`).  The memory budget is one card's
device memory, `roofline.HBM_BYTES`.

    PYTHONPATH=src python -m repro_torch.launch.report [--section dryrun|roofline]

Prints markdown to stdout.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.roofline import HBM_BYTES

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "dryrun_torch")
BUDGET = f"fits {HBM_BYTES / 1e9:g}GB"


def _load(mesh: str):
    d = os.path.join(ART, mesh)
    if not os.path.isdir(d):
        return {}
    out = {}
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            out[fn[:-5]] = json.load(open(os.path.join(d, fn)))
    return out


def _fmt(x, unit=""):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    for div, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(x) >= div:
            return f"{x / div:.2f}{suf}{unit}"
    return f"{x:.3g}{unit}"


def dryrun_table(mesh: str, recs=None) -> str:
    """The dry-run table of `mesh`'s records (or of `recs`, a {name:
    record} dict)."""
    recs = _load(mesh) if recs is None else recs
    lines = [
        f"### {mesh}",
        "",
        "| arch | shape | compile s | bytes/dev (arg+tmp) | "
        f"collectives (AG/AR/RS/A2A/CP counts) | {BUDGET} |",
        "|---|---|---|---|---|---|",
    ]
    for r in recs.values():
        if r.get("tag"):
            continue              # hillclimb variants live in §Perf
        if "memory_analysis" not in r:
            ma = {"argument_size_in_bytes": r.get("arg_bytes", 0),
                  "temp_size_in_bytes": r.get("temp_bytes", 0)}
        else:
            ma = r["memory_analysis"]
        tot = (ma.get("argument_size_in_bytes", 0)
               + ma.get("temp_size_in_bytes", 0))
        c = r.get("collectives", {})

        def cnt(k, c=c):
            return c.get(k, {}).get("count", 0)

        cs = (f"{cnt('all-gather')}/{cnt('all-reduce')}/"
              f"{cnt('reduce-scatter')}/{cnt('all-to-all')}/"
              f"{cnt('collective-permute')}")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r.get('compile_s', 0):.1f} "
            f"| {tot/1e9:.2f} GB | {cs} "
            f"| {'Y' if tot <= HBM_BYTES else 'N'} |")
    return "\n".join(lines)


def roofline_table(mesh: str = "pod16x16", recs=None) -> str:
    recs = _load(mesh) if recs is None else recs
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant "
        "| MODEL_FLOPS | useful ratio | MFU |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs.values():
        if "compute_s" not in r or r.get("tag"):
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | **{r['dominant']}** "
            f"| {_fmt(r.get('model_flops_global'))} "
            f"| {r.get('useful_flops_ratio', 0):.2f} "
            f"| {r.get('mfu', 0):.3f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--section", default="all")
    args = ap.parse_args(argv)
    if args.section in ("dryrun", "all"):
        print("## §Dry-run tables\n")
        for mesh in ("pod16x16", "pod2x16x16"):
            print(dryrun_table(mesh))
            print()
    if args.section in ("roofline", "all"):
        print("## §Roofline table (single-pod)\n")
        print(roofline_table())


if __name__ == "__main__":
    main()
