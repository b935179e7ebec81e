"""The hardware model of one NVIDIA H100, and roofline terms.

The port of `repro.launch.roofline` with the card's figures in place of
TPU v5e's.  Each constant is the NVIDIA H100 80GB HBM3 (SXM5, 700 W)
datasheet figure, dense rates without sparsity; a card set below 700 W
runs slower under load, so a share of these peaks is stated beside the
card's power limit.

Conventions, as in the reference:
  * compute_term_s = flops / PEAK_FLOPS, memory_term_s = bytes / HBM_BW,
    collective_term_s = wire bytes / ICI_BW, all per device (one rank's
    local ops, as the dry run's `costs.Recorder` counts them);
  * collective bytes: for every all-gather / all-reduce / reduce-scatter
    / all-to-all / collective-permute the RESULT's per-rank bytes;
    all-reduce weighs 2x (ring send + recv), reduce-scatter its result x
    (group size - 1), the others 1x: a structural lower bound;
  * MODEL_FLOPS = 6 N D for training (forward + backward), 2 N D forward
    only, with D the global tokens of the step and N the (active)
    parameter count.

One ICI_BW for every collective: NVLink's 900 GB/s inside one 8-card
HGX node.  A 16-wide model axis spans two such nodes, whose link is
slower; the term does not model that.

`bound_s` is the least time for one kernel's work: the larger of its
bytes (each input read once, each output written once) over HBM_BW and
its operations over the peak of their type (FP32_FLOPS outside the
tensor cores, PEAK_FLOPS for bf16 on them).  `chip_smoke.py` and
`launch.autotune` take every bound from it.

`parse_collectives` and `build` read the dry run's record (the
reference's read XLA's HLO and compiled executable).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

#: dense bf16 / fp16 on the tensor cores, FLOP/s
PEAK_FLOPS = 989e12
#: fp32 outside the tensor cores (an FMA counts as two operations)
FP32_FLOPS = 67e12
#: device memory rate, bytes/s
HBM_BW = 3.35e12
#: NVLink 4, all 18 links of one card together, bytes/s
ICI_BW = 900e9
#: device memory, bytes
HBM_BYTES = 80e9

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def shape_bytes(shape_str: str) -> int:
    """'f32[16,128]{1,0}' or '(f32[2], bf16[4,4])' -> total bytes."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_WIRE_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def parse_collectives(trace: Iterable[dict]) -> Dict[str, dict]:
    """Per collective kind: {'count', 'bytes', 'wire_bytes'} (per rank),
    from the dry run's recorded collectives ({"kind", "bytes", "group"}
    each: `costs.Recorder.collectives`).

    reduce-scatter's RESULT is the scattered shard (input / P), so its
    wire cost is result_bytes x (group_size - 1)."""
    out = {k: {"count": 0, "bytes": 0, "wire_bytes": 0.0}
           for k in _COLL_KINDS}
    for c in trace:
        kind, b = c["kind"], int(c["bytes"])
        w = b * _WIRE_WEIGHT[kind]
        if kind == "reduce-scatter":
            w = b * max(int(c.get("group", 2)) - 1, 1)
        out[kind]["count"] += 1
        out[kind]["bytes"] += b
        out[kind]["wire_bytes"] += w
    return out


def bound_s(nbytes: float, flops: float, peak: float = FP32_FLOPS
            ) -> Tuple[float, str]:
    """(least seconds for the work, "bytes" or "operations": the term
    that sets it)."""
    t_bytes = nbytes / HBM_BW
    t_ops = flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float          # per-device wire bytes
    collectives: dict
    model_flops_global: float
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Optimistic (perfect-overlap) step time = max of terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        tot = self.flops_per_device * self.chips
        return self.model_flops_global / tot if tot else 0.0

    @property
    def mfu(self) -> float:
        """MODEL_FLOPS / (step_s * chips * peak) — roofline fraction."""
        denom = self.step_s * self.chips * PEAK_FLOPS
        return self.model_flops_global / denom if denom else 0.0

    @property
    def hbm_fit(self) -> bool:
        return (self.arg_bytes + self.temp_bytes) <= HBM_BYTES

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "arch", "shape", "mesh", "chips", "flops_per_device",
            "bytes_per_device", "collective_bytes", "model_flops_global",
            "arg_bytes", "temp_bytes", "out_bytes")}
        d["collectives"] = self.collectives
        for k in ("compute_s", "memory_s", "collective_s", "dominant",
                  "step_s", "useful_flops_ratio", "mfu", "hbm_fit"):
            d[k] = getattr(self, k)
        return d


def model_flops(cfg, shape) -> float:
    """6*N*D train / 2*N*D fwd-only, N = active params."""
    from repro_torch.models.model import count_params_analytic
    n = count_params_analytic(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch        # decode: one token per seq


def build(arch: str, shape, mesh_name: str, chips: int, record: dict,
          cfg=None) -> Roofline:
    """A Roofline from a dry-run record: its per-rank `flops` and
    `bytes`, its `collectives` trace and its `memory_analysis` bytes."""
    colls = parse_collectives(record["collectives"])
    wire = sum(c["wire_bytes"] for c in colls.values())
    ma = record["memory_analysis"]
    mf = model_flops(cfg, shape) if cfg is not None else 0.0
    return Roofline(
        arch=arch, shape=shape.name if hasattr(shape, "name") else shape,
        mesh=mesh_name, chips=chips,
        flops_per_device=float(record["flops"]),
        bytes_per_device=float(record["bytes"]),
        collective_bytes=wire, collectives=colls,
        model_flops_global=mf,
        arg_bytes=ma.get("argument_size_in_bytes", 0),
        temp_bytes=ma.get("temp_size_in_bytes", 0),
        out_bytes=ma.get("output_size_in_bytes", 0))
