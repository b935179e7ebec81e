"""Kernel-geometry hillclimbing: the kernel-tune variants of
`repro.launch.hillclimb`.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --list
    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        gee-scatter-tune gee-topk-tune [--quick] [--device cpu]

Each variant runs one tuner of `launch.autotune` (coordinate descent
over `tile_n` for `gee_scatter`, over the select grid for `topk_fused`)
and prints the best geometry beside the default, with times and shares
of the card's roofline.  The reference's cell and GEE variants re-lower
dry-run cells; they come with the port's dry run.
"""
from __future__ import annotations

import argparse

#: variant -> the tuner it runs
VARIANTS = {"gee-scatter-tune": "scatter", "gee-topk-tune": "topk"}

#: --quick workload shrink for the kernel tuners (the whole descent and
#: report in seconds)
_KERNEL_QUICK = {
    "scatter": dict(n=1_000, s=8_000, K=8, space={"tile_n": (64, 128)},
                    iters=1),
    "topk": dict(m=2_000, K=8, nq=16, k=5, space={"max_grid": (16, 64)},
                 iters=1),
}


def _run_kernel_tune(fn: str, quick: bool, device: str) -> dict:
    from repro_torch.launch.autotune import tune_scatter, tune_topk
    tuner = {"scatter": tune_scatter, "topk": tune_topk}[fn]
    kw = _KERNEL_QUICK[fn] if quick else {}
    out = tuner(device=device, **kw)
    d = out["default_point"]
    print(f"best[{fn}]: {out['best']}  {out['seconds'] * 1e3:.4f} ms  "
          f"{out['achieved_gbps']:.2f} GB/s "
          f"({out['roofline_frac'] * 100:.2f}% of HBM, "
          f"{out['best_point']['bound_share']:.3f} of the "
          f"{out['best_point']['bound_by']} bound); default {d['cfg']} "
          f"{d['seconds'] * 1e3:.4f} ms ({d['bound_share']:.3f}) "
          f"[{out['mode']}]")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variant", nargs="*", help=list(VARIANTS))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="tiny kernel-tune workloads")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.list or not args.variant:
        for k in VARIANTS:
            print(k)
        return
    for name in args.variant:
        if name not in VARIANTS:
            ap.error(f"unknown variant {name!r}; known: {list(VARIANTS)}")
    for name in args.variant:
        _run_kernel_tune(VARIANTS[name], args.quick, args.device)


if __name__ == "__main__":
    main()
