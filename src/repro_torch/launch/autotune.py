"""Kernel-geometry autotuning against the card's roofline.

The port of `repro.launch.autotune`.  A geometry candidate's figure of
merit is its time, and beside it the share of the least time the card
could take for the same work (`roofline.bound_s`): the bytes the call
must move over HBM_BW, or its operations over the fp32 peak, whichever
is larger.  The byte models are the kernel table's bounds (PERF.md §6),
not the reference's packed-tile formulas.

Search: greedy coordinate descent, one knob at a time holding the others
at the incumbent, until a full round improves nothing.  The port's
knobs:

  gee_scatter  tile_n, rows per thread block (`EncoderConfig.tile_n`;
               the port's row-offset layout has no `edge_block`);
  topk_fused   the select pass's grid (`max_grid`, a cap on the
               occupancy's choice), the counterpart of `block_rows`.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb gee-scatter-tune
    PYTHONPATH=src python -m repro_torch.launch.hillclimb gee-topk-tune

On the card the tuners time the kernels.  On the CPU (`device="cpu"`)
they time the kernels' plain versions and report mode "plain (cpu)":
those times, and the shares of the card's roofline computed from them,
say nothing about the kernels.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.roofline import HBM_BW, bound_s

#: geometry spaces swept by the coordinate descent (ascending so the
#: sweep output reads as a size scan)
SCATTER_SPACE: Dict[str, Tuple[int, ...]] = {
    "tile_n": (64, 128, 256, 512),
}
TOPK_SPACE: Dict[str, Tuple[int, ...]] = {
    "max_grid": (32, 64, 128, 256, 512, 1024),
}
#: the geometry the port runs without tuning (`EncoderConfig.tile_n`;
#: the occupancy's grid)
SCATTER_DEFAULT = {"tile_n": 256}
TOPK_DEFAULT: Dict[str, Optional[int]] = {"max_grid": None}


def _ready(out) -> None:
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def median_time(fn: Callable[[], object], *, warmup: int = 1,
                iters: int = 3) -> float:
    """Median wall seconds per call, the device synchronized after each
    (a call on the card returns before its kernels finish)."""
    for _ in range(warmup):
        _ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _ready(fn())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def scatter_traffic_bytes(S: int, T: int, tile_n: int, K: int) -> int:
    """Bytes one `gee_scatter` call must move: class and value per
    contribution (8 S), one int64 offset per row of the T tiles plus one
    (8 (T tile_n + 1)), and Z written once (4 K T tile_n)."""
    return 8 * S + 8 * (T * tile_n + 1) + 4 * K * T * tile_n


def topk_traffic_bytes(m: int, K: int, nq: int, k: int) -> int:
    """Bytes one `topk_fused` call must move: the (m, K) rows once, the
    queries and their ids once, the (nq, k) answers once.  The select
    pass's candidate lists are scratch and not counted."""
    return m * K * 4 + nq * K * 4 + nq * 4 + nq * k * 8


def topk_ops(m: int, K: int, nq: int) -> float:
    """fp32 operations of the scores: a multiply and an add per term."""
    return 2.0 * nq * m * K


def _coordinate_descent(space: Dict[str, Tuple[int, ...]],
                        measure: Callable[[dict], float],
                        start: dict, *, log: Callable = print) -> dict:
    """Greedy per-knob sweep to a local optimum of `measure` (seconds,
    lower is better).  Returns {'best': cfg, 'seconds': t, 'trace':
    [(cfg, t), ...]} with every point measured."""
    best = dict(start)
    trace = []
    best_t = measure(best)
    trace.append((dict(best), best_t))
    improved = True
    while improved:
        improved = False
        for knob, points in space.items():
            for p in points:
                if p == best[knob]:
                    continue
                cand = {**best, knob: p}
                t = measure(cand)
                trace.append((dict(cand), t))
                if t < best_t:
                    best, best_t = cand, t
                    improved = True
            log(f"  {knob}: best so far {best} -> {best_t * 1e3:.2f} ms")
    return {"best": best, "seconds": best_t, "trace": trace}


def _mode(dev: torch.device) -> str:
    return "cuda" if dev.type == "cuda" else "plain (cpu)"


def _point(cfg: dict, seconds: float, nbytes: int, ops: float) -> dict:
    b, by = bound_s(nbytes, ops)
    return {"cfg": dict(cfg), "seconds": seconds, "moved_bytes": nbytes,
            "bound_s": b, "bound_by": by,
            "bound_share": b / seconds if seconds > 0 else 0.0}


def _finish(out: dict, measure: Callable[[dict], float], default: dict,
            cost: Callable[[dict], Tuple[int, float]], mode: str, *,
            log: Callable) -> dict:
    """Add the default geometry's time (measured once more unless the
    descent did) and each of best and default's bound, share of the bound
    and achieved HBM rate."""
    times = {tuple(sorted(c.items())): t for c, t in out["trace"]}
    key = tuple(sorted(default.items()))
    t_def = times[key] if key in times else measure(default)
    for name, cfg, t in (("best", out["best"], out["seconds"]),
                         ("default", default, t_def)):
        pt = _point(cfg, t, *cost(cfg))
        out[name + "_point"] = pt
        log(f"  {name} {cfg}: {t * 1e3:.4f} ms, bound "
            f"{pt['bound_s'] * 1e3:.4f} ms ({pt['bound_by']}), "
            f"{pt['bound_share']:.3f} of it [{mode}]")
    best = out["best_point"]
    gbps = best["moved_bytes"] / best["seconds"] / 1e9 \
        if best["seconds"] > 0 else 0.0
    out.update(moved_bytes=best["moved_bytes"], achieved_gbps=gbps,
               roofline_frac=gbps * 1e9 / HBM_BW, mode=mode)
    return out


def tune_scatter(n: int = 20_000, s: int = 200_000, K: int = 16, *,
                 space: Optional[Dict[str, Tuple[int, ...]]] = None,
                 iters: int = 2, log: Callable = print,
                 device="cuda") -> dict:
    """Tune `tile_n` for the `gee_scatter` kernel on an Erdos-Renyi
    graph of (n, s), 20% labelled: each geometry's plan is built once
    (the cuda backend's `pack_edges`), then the kernel alone is timed
    on its resolved contributions."""
    from repro_torch.encoder import Embedder, EncoderConfig
    from repro_torch.graph import erdos_renyi, make_labels
    from repro_torch.kernels.gee_scatter import gee_scatter
    dev = resolve_device(device)
    space = dict(SCATTER_SPACE if space is None else space)
    g = erdos_renyi(n, s, seed=0)
    Y = make_labels(g.n, K, 0.2, np.random.default_rng(0))
    mode = _mode(dev)
    log(f"scatter tune: n={n} s={s} K={K} mode={mode}")

    plans: dict = {}

    def plan(tile_n: int):
        if tile_n not in plans:
            e = Embedder(EncoderConfig(K=K, tile_n=tile_n), backend="cuda",
                         device=dev, plan_cache=None).fit(g, Y)
            cls, val = e.backend.resolve(e._plan, e._Yj, e.Wv_)
            plans[tile_n] = (e._plan.data["row_ptr"], cls, val,
                             e._plan.data["T"],
                             int((val != 0).sum().item()))
        return plans[tile_n]

    def measure(cfg: dict) -> float:
        row_ptr, cls, val, T, _ = plan(cfg["tile_n"])
        return median_time(
            lambda: gee_scatter(row_ptr, cls, val, num_tiles=T,
                                tile_n=cfg["tile_n"], kdim=K), iters=iters)

    def cost(cfg: dict) -> Tuple[int, float]:
        _, cls, _, T, nnz = plan(cfg["tile_n"])
        return scatter_traffic_bytes(cls.numel(), T, cfg["tile_n"], K), nnz

    out = _coordinate_descent(space, measure,
                              {"tile_n": space["tile_n"][0]}, log=log)
    return _finish(out, measure, SCATTER_DEFAULT, cost, mode, log=log)


def tune_topk(m: int = 50_000, K: int = 16, nq: int = 64, k: int = 10, *,
              space: Optional[Dict[str, Tuple[int, ...]]] = None,
              iters: int = 2, log: Callable = print,
              device="cuda") -> dict:
    """Tune the select pass's grid (`max_grid`) for `topk_fused` over an
    (m, K) slice of random unit rows, nq queries drawn from them."""
    from repro_torch.kernels.query_fused import normalize_rows, topk_fused
    dev = resolve_device(device)
    space = dict(TOPK_SPACE if space is None else space)
    rng = np.random.default_rng(0)
    Zn = normalize_rows(torch.as_tensor(
        rng.normal(size=(m, K)).astype(np.float32), device=dev))
    qnodes = torch.as_tensor(rng.integers(0, m, nq).astype(np.int32),
                             device=dev)
    q = Zn[qnodes.long()].contiguous()
    mode = _mode(dev)
    log(f"topk tune: m={m} K={K} nq={nq} k={k} mode={mode}")

    def measure(cfg: dict) -> float:
        return median_time(
            lambda: topk_fused(Zn, q, qnodes, k=k,
                               max_grid=cfg["max_grid"]), iters=iters)

    def cost(cfg: dict) -> Tuple[int, float]:
        return topk_traffic_bytes(m, K, nq, k), topk_ops(m, K, nq)

    out = _coordinate_descent(space, measure,
                              {"max_grid": space["max_grid"][0]}, log=log)
    return _finish(out, measure, TOPK_DEFAULT, cost, mode, log=log)
