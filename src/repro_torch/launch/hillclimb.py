"""Hillclimbing driver: the port of `repro.launch.hillclimb`.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --list
    PYTHONPATH=src python -m repro_torch.launch.hillclimb qwen110-base grok-nofsdp gee-ring
    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        gee-scatter-tune gee-topk-tune [--quick] [--device cpu]

Cell variants (`qwen110-*`, `grok-*`) re-trace one dry-run cell
(`launch.dryrun.run_cell`) with one change and record its roofline
terms under a tag; GEE variants (`gee-ring`, `gee-a2a`, `gee-rs`,
`gee-repl`) trace GEE at Friendster scale in one mode
(`launch.dryrun.run_gee`); both run on the host over a fake 256-rank
mesh.  The kernel-tune variants run one tuner of `launch.autotune`
(coordinate descent over `tile_n` for `gee_scatter`, over the select
grid for `topk_fused`) and print the best geometry beside the default,
with times and shares of the card's roofline.
"""
from __future__ import annotations

import argparse

#: variant -> what it runs (the reference's table)
VARIANTS = {
    # --- qwen110 train: memory term ------------------------------------
    "qwen110-base": dict(kind="cell", arch="qwen1.5-110b",
                         shape="train_4k", kw={}),
    "qwen110-tri": dict(kind="cell", arch="qwen1.5-110b", shape="train_4k",
                        kw=dict(impl="triangular", tag="tri")),
    "qwen110-accum8": dict(kind="cell", arch="qwen1.5-110b",
                           shape="train_4k",
                           kw=dict(accum_steps=8, tag="accum8")),
    "qwen110-seqshard": dict(kind="cell", arch="qwen1.5-110b",
                             shape="train_4k",
                             kw=dict(seq_shard_acts=True, tag="seqshard")),
    "qwen110-tri-accum8": dict(kind="cell", arch="qwen1.5-110b",
                               shape="train_4k",
                               kw=dict(impl="triangular", accum_steps=8,
                                       tag="tri-accum8")),
    "qwen110-accum8-seqshard": dict(
        kind="cell", arch="qwen1.5-110b", shape="train_4k",
        kw=dict(accum_steps=8, seq_shard_acts=True,
                tag="accum8-seqshard")),
    "qwen110-accum16-seqshard": dict(
        kind="cell", arch="qwen1.5-110b", shape="train_4k",
        kw=dict(accum_steps=16, seq_shard_acts=True,
                tag="accum16-seqshard")),
    # prefill cell where attention flops dominate: triangular matters
    "qwen110-prefill-base": dict(kind="cell", arch="qwen1.5-110b",
                                 shape="prefill_32k", kw={}),
    "qwen110-prefill-tri": dict(kind="cell", arch="qwen1.5-110b",
                                shape="prefill_32k",
                                kw=dict(impl="triangular", tag="tri")),
    "grok-seqshard": dict(kind="cell", arch="grok-1-314b",
                          shape="train_4k",
                          kw=dict(seq_shard_acts=True, tag="seqshard")),
    # --- grok train: collective term ------------------------------------
    "grok-base": dict(kind="cell", arch="grok-1-314b", shape="train_4k",
                      kw={}),
    "grok-tri": dict(kind="cell", arch="grok-1-314b", shape="train_4k",
                     kw=dict(impl="triangular", tag="tri")),
    "grok-nofsdp": dict(kind="cell", arch="grok-1-314b", shape="train_4k",
                        kw=dict(fsdp=False, tag="nofsdp")),
    "grok-accum8": dict(kind="cell", arch="grok-1-314b", shape="train_4k",
                        kw=dict(accum_steps=8, tag="accum8")),
    "grok-int8": dict(kind="cell", arch="grok-1-314b", shape="train_4k",
                      kw=dict(compress_grads=True, tag="int8")),
    "grok-tri-accum8": dict(kind="cell", arch="grok-1-314b",
                            shape="train_4k",
                            kw=dict(impl="triangular", accum_steps=8,
                                    tag="tri-accum8")),
    # --- GEE friendster: the paper's workload ---------------------------
    "gee-ring": dict(kind="gee", mode="ring"),
    "gee-a2a": dict(kind="gee", mode="a2a"),
    "gee-rs": dict(kind="gee", mode="reduce_scatter"),
    "gee-repl": dict(kind="gee", mode="replicated"),
    # --- kernel-geometry autotune (`launch.autotune`) -------------------
    "gee-scatter-tune": dict(kind="kernel", fn="scatter"),
    "gee-topk-tune": dict(kind="kernel", fn="topk"),
}

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
        v = VARIANTS[name]
        if v["kind"] == "kernel":
            _run_kernel_tune(v["fn"], args.quick, args.device)
            continue
        from repro_torch.launch.dryrun import run_cell, run_gee
        if v["kind"] == "gee":
            run_gee(mode=v["mode"])
        else:
            run_cell(v["arch"], v["shape"], **v["kw"])


if __name__ == "__main__":
    main()
