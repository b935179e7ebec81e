"""Backend registry: every execution strategy behind one interface.

The port of `repro.encoder.backends`.  A backend turns a `Plan` plus
the *current* labels into Z; all compute the same Z and differ in where
the scatter runs:

  numpy       `ref_python.gee_numpy` on the host — the oracle.
  torch       `core.gee` scatter-add with `index_put_` on the
              Embedder's device (the `xla` analog).
  cuda        the scatter kernel (`kernels.gee_scatter`, the `pallas`
              analog): contributions sorted ONCE at plan time by
              destination row (one offset per row, no padding) with
              their *source node*, so label changes
              re-resolve class and value on the device and never
              re-pack.  On a CPU device it runs the kernel's plain
              version.
  streaming   chunked accumulate: O(chunk) edge data on the device.
  distributed:M   `core.distributed.gee_sharded` for M in {replicated,
              reduce_scatter, a2a, ring}: collectives over the ranks
              of a `torch.distributed` mesh (the reference's names);
              the plan pads edges and rows to the mesh and measures the
              exact zero-drop capacity factor once.

The single-device names differ from the reference's on purpose, so the
two packages' strategies are never confused.  Every backend but the
distributed ones supports `EncoderConfig.row_partition` (an
(n_local, K) accumulator over the contributions bucketed by owned
destination).  Each builds its plan in two halves, `plan_host` (what
the persistent plan cache stores) and `plan_finalize` (the uploads),
as the reference's do.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.encoder.config import EncoderConfig
from repro_torch.encoder.plan import Plan, effective_weights, owned_contributions
from repro_torch.graph.edges import Graph

_REGISTRY: Dict[str, Type["Backend"]] = {}


def register_backend(name: str):
    """Class decorator: make a Backend constructible by name."""
    def deco(cls: Type["Backend"]) -> Type["Backend"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_backend(name: str) -> "Backend":
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))}") from None


def list_backends() -> list[str]:
    return sorted(_REGISTRY)


def partition_backends() -> list[str]:
    """Registered backends with the owned-rows accumulate path
    (`EncoderConfig.row_partition`): the suggestion list of the
    plan-time rejection of a backend without one."""
    return sorted(n for n, c in _REGISTRY.items()
                  if c.supports_row_partition)


def _contributions(graph: Graph, config: EncoderConfig,
                   w_eff: np.ndarray) -> tuple:
    """(dst rows, label-donor src, weight) per contribution: both
    directions of every edge, or the owned subset under a partition
    (rows remapped to [0, hi - lo))."""
    if config.row_partition is not None:
        return owned_contributions(graph, w_eff, *config.row_partition)
    u, v = np.asarray(graph.u, np.int32), np.asarray(graph.v, np.int32)
    return (np.concatenate([u, v]), np.concatenate([v, u]),
            np.concatenate([w_eff, w_eff]).astype(np.float32))


class Backend:
    """One execution strategy: label-free `plan`, label-dependent
    `embed`.

    A plan is built in two halves, as in the reference:

      plan_host      the expensive label-free artifacts (numpy arrays and
                     scalars), which the persistent plan cache stores;
      plan_finalize  the cheap per-process half: uploads to the device,
                     chunk views.

    A cache hit hands `plan` the stored host dict and skips `plan_host`.
    """

    name: str = "?"
    #: scatter-path backends reproduce the oracle to float tolerance;
    #: the bucketed collective modes also depend on capacity padding
    exact: bool = True
    #: bump when the plan_host layout changes: older disk entries then
    #: read as misses, never as wrong plans
    plan_version: int = 1
    #: whether plan_host's output may be persisted across processes
    persistable: bool = True
    #: whether this backend has the owned-rows accumulate path
    #: (`EncoderConfig.row_partition`)
    supports_row_partition: bool = False

    def cache_context(self, *, mesh=None) -> str:
        """Runtime context baked into the persistent-cache key (the
        distributed backends' rank count)."""
        return ""

    def plan_host(self, graph: Graph, config: EncoderConfig,
                  w_eff: np.ndarray, device: torch.device, *,
                  mesh=None) -> Dict:
        """The backend's label-free host artifacts ("w_eff" is added by
        `plan` where it is one)."""
        return {}

    def plan_finalize(self, plan: Plan, graph: Graph,
                      device: torch.device, *, mesh=None) -> None:
        """Fill plan.data from (graph, plan.host): the uploads."""
        raise NotImplementedError

    def plan(self, graph: Graph, config: EncoderConfig,
             device: torch.device, host: Optional[Dict] = None, *,
             mesh=None) -> Plan:
        """Build the plan; `host` (from the persistent cache) skips the
        expensive half.  Unscaled, w_eff IS graph.w and is not stored;
        partitioned plans fold it into their owned contributions."""
        built = host is None
        if built:
            w_eff = effective_weights(graph, config)
            keep_w = config.laplacian and config.row_partition is None
            host = {**({"w_eff": w_eff} if keep_w else {}),
                    **self.plan_host(graph, config, w_eff, device,
                                     mesh=mesh)}
        if config.row_partition is not None:
            w_eff = graph.w
        elif not built:
            w_eff = (host["w_eff"] if "w_eff" in host
                     else effective_weights(graph, config))
        p = Plan(backend=self.name, config=config, n=graph.n, s=graph.s,
                 w_eff=np.asarray(w_eff, np.float32), host=host,
                 **Plan.anchors(graph))
        self.plan_finalize(p, graph, device, mesh=mesh)
        return p

    def embed(self, plan: Plan, Yj: torch.Tensor, Wv: torch.Tensor
              ) -> Tuple[torch.Tensor, dict]:
        """Return (Z (n_local, K) float32 on Yj's device, info dict)."""
        raise NotImplementedError


def _owned_plan_host(graph: Graph, config: EncoderConfig,
                     w_eff: np.ndarray) -> Dict:
    """Host half of a partitioned plan: contributions bucketed by owned
    destination, rows remapped to [0, n_local)."""
    rows, src, w = owned_contributions(graph, w_eff, *config.row_partition)
    return {"o_rows": rows, "o_src": src, "o_w": w}


def _owned(p: Plan) -> tuple:
    h = p.host
    return (np.asarray(h["o_rows"], np.int32),
            np.asarray(h["o_src"], np.int32),
            np.asarray(h["o_w"], np.float32))


class _OwnedHostBackend(Backend):
    """A backend whose only host artifact is the partitioned plan's
    owned contributions."""

    supports_row_partition = True

    def plan_host(self, graph, config, w_eff, device, *, mesh=None):
        if config.row_partition is None:
            return {}
        return _owned_plan_host(graph, config, w_eff)


@register_backend("numpy")
class NumpyBackend(_OwnedHostBackend):
    """`ref_python.gee_numpy` on the host; Z is moved to the device."""

    def plan_finalize(self, p, graph, device, *, mesh=None):
        if p.config.row_partition is None:
            p.data = {"u": np.asarray(graph.u), "v": np.asarray(graph.v)}
        else:
            rows, src, w = _owned(p)
            p.data = {"rows": rows, "src": src, "w": w}

    def embed(self, plan, Yj, Wv):
        from repro_torch.core.ref_python import gee_numpy, gee_numpy_owned
        Y = Yj.cpu().numpy()
        d = plan.data
        if plan.config.row_partition is not None:
            Z = gee_numpy_owned(d["rows"], d["src"], d["w"], Y,
                                Wv.cpu().numpy(), plan.config.K,
                                plan.n_local)
        else:
            Z = gee_numpy(d["u"], d["v"], plan.w_eff, Y, plan.config.K,
                          plan.n)
        return torch.from_numpy(Z).to(Yj.device), {}


@register_backend("torch")
class TorchBackend(_OwnedHostBackend):
    """`core.gee` scatter-add on the device, with the Embedder-owned
    Wv; under a row partition `core.gee.gee_owned`."""

    def plan_finalize(self, p, graph, device, *, mesh=None):
        if p.config.row_partition is None:
            p.data = {"u": torch.as_tensor(graph.u, device=device),
                      "v": torch.as_tensor(graph.v, device=device),
                      "w": torch.as_tensor(p.w_eff, device=device)}
        else:
            rows, src, w = _owned(p)
            p.data = {"rows": torch.as_tensor(rows, device=device),
                      "src": torch.as_tensor(src, device=device),
                      "w": torch.as_tensor(w, device=device)}

    def embed(self, plan, Yj, Wv):
        from repro_torch.core.gee import gee, gee_owned
        d, K = plan.data, plan.config.K
        if plan.config.row_partition is not None:
            return gee_owned(d["rows"], d["src"], d["w"], Yj, Wv, K=K,
                             n_local=plan.n_local), {}
        return gee(d["u"], d["v"], d["w"], Yj, K=K, n=plan.n, Wv=Wv), {}


@register_backend("cuda")
class CudaBackend(Backend):
    """The destination-tiled scatter kernel.

    The host half is the row-offset layout of the (destination, source
    node, weight) contributions, all label-free (`pack_edges`): one
    int64 offset per row (`row_ptr`) and flat `src` and `w_packed`
    buffers of exactly S slots.  They are sorted on the plan's device
    and stay there as tensors (the cache copies them to the host when
    it stores them; a hit uploads them again), so a plan that is not
    stored never crosses the host link twice.  Each embed resolves
    class and value per slot from the current (Y, Wv) and launches
    `gee_scatter`.  Under a row partition the owned contributions feed
    the same packing over the local rows [0, hi - lo)."""

    supports_row_partition = True

    def plan_host(self, graph, config, w_eff, device, *, mesh=None):
        from repro_torch.kernels.ops import pack_edges
        dst, src, w = _contributions(graph, config, w_eff)
        n_rows = (graph.n if config.row_partition is None
                  else config.row_partition[1] - config.row_partition[0])
        row_ptr, srcb, wb, T = pack_edges(
            torch.as_tensor(dst, device=device),
            torch.as_tensor(src, device=device),
            torch.as_tensor(w, device=device), n_rows, config.tile_n)
        return {"row_ptr": row_ptr, "src": srcb, "w_packed": wb,
                "T": np.int64(T)}

    def plan_finalize(self, p, graph, device, *, mesh=None):
        h = p.host
        p.data = {"row_ptr": torch.as_tensor(h["row_ptr"], device=device),
                  "src": torch.as_tensor(h["src"], device=device),
                  "w": torch.as_tensor(h["w_packed"], device=device),
                  "T": int(h["T"])}

    @staticmethod
    def resolve(plan, Yj, Wv) -> Tuple[torch.Tensor, torch.Tensor]:
        """(class int32, value float32) per packed slot under the labels
        Yj: an unlabelled donor gives class 0 and value 0."""
        src = plan.data["src"]
        Ys = Yj.index_select(0, src)
        cls = torch.clamp_min(Ys, 0).to(torch.int32)
        val = torch.where(Ys >= 0, Wv.index_select(0, src) * plan.data["w"],
                          torch.zeros((), dtype=torch.float32,
                                      device=Yj.device))
        return cls, val

    def embed(self, plan, Yj, Wv):
        from repro_torch.kernels.gee_scatter import gee_scatter
        d, cfg = plan.data, plan.config
        cls, val = self.resolve(plan, Yj, Wv)
        Z = gee_scatter(d["row_ptr"], cls, val, num_tiles=d["T"],
                        tile_n=cfg.tile_n, kdim=cfg.K)
        return Z[:plan.n_local], {"tiles": d["T"]}


@register_backend("streaming")
class StreamingBackend(_OwnedHostBackend):
    """Accumulate over bucket-padded host chunks: each chunk is moved to
    the device, folded into Z and released, so only O(chunk) edge data
    plus Z lives there.  Under a row partition the chunks are owned
    (row, src, w) triples and Z is (n_local, K); those bucketed triples
    are the persisted host half, the chunking is per process."""

    def plan_finalize(self, p, graph, device, *, mesh=None):
        from repro_torch.graph.edges import chunk_edges
        if p.config.row_partition is None:
            cols = (np.asarray(graph.u, np.int32),
                    np.asarray(graph.v, np.int32), p.w_eff)
        else:
            cols = _owned(p)
        # tails pad with (0, 0, 0.0): w = 0 is a no-op for any labeling
        p.data = {"chunks": list(chunk_edges(*cols, p.config.chunk_size))}

    def embed(self, plan, Yj, Wv):
        from repro_torch.core.gee import gee_streaming, gee_streaming_owned
        cfg, dev = plan.config, Yj.device
        chunks = ((torch.as_tensor(a, device=dev),
                   torch.as_tensor(b, device=dev),
                   torch.as_tensor(c, device=dev))
                  for (a, b, c) in plan.data["chunks"])
        if cfg.row_partition is not None:
            Z = gee_streaming_owned(chunks, Yj, K=cfg.K,
                                    n_local=plan.n_local, Wv=Wv)
        else:
            Z = gee_streaming(chunks, Yj, K=cfg.K, n=plan.n, Wv=Wv)
        return Z, {"chunks": len(plan.data["chunks"])}


class DistributedBackend(Backend):
    """Collectives over the ranks of an edge mesh (`core.distributed`).

    The plan measures, for the bucketed modes, the exact zero-drop
    capacity factor from the owner histogram (an O(s) host pass done
    once, not per fit); it depends on the rank count, so that count is
    in the cache key (`cache_context`).  `plan_finalize` pads the edges
    and rows to the mesh and keeps this rank's slice of the edges on its
    device.  `embed` returns the full Z on every rank (the row-sharded
    modes all-gather), so `transform` and `predict` keep global node
    ids.  Without a mesh the plan takes `edge_mesh(device)`."""

    mode = "ring"
    exact = False          # the bucketed modes depend on capacity padding

    @staticmethod
    def _mesh(mesh, device):
        from repro_torch.core.distributed import edge_mesh
        return mesh if mesh is not None else edge_mesh(device)

    def cache_context(self, *, mesh=None) -> str:
        from repro_torch.core.distributed import world_size
        return f"nd={world_size(mesh)}"

    def plan_host(self, graph, config, w_eff, device, *, mesh=None):
        from repro_torch.core.distributed import (exact_capacity_factor,
                                                  world_size)
        cf = config.capacity_factor
        if cf is None and self.mode in ("a2a", "ring"):
            cf = exact_capacity_factor(graph, world_size(mesh))
        return {"capacity_factor": cf if cf is not None else 2.0}

    def plan_finalize(self, p, graph, device, *, mesh=None):
        from repro_torch.core.distributed import edge_slice, pad_rows
        mesh = self._mesh(mesh, device)
        nd = mesh.size()
        g = Graph(np.asarray(graph.u), np.asarray(graph.v), p.w_eff,
                  graph.n)
        u, v, w = edge_slice(g, nd, mesh.get_local_rank())
        p.data = {"mesh": mesh, "n_pad": pad_rows(graph.n, nd),
                  "capacity_factor": float(p.host["capacity_factor"]),
                  "u": torch.as_tensor(u, device=device),
                  "v": torch.as_tensor(v, device=device),
                  "w": torch.as_tensor(w, device=device)}

    def embed(self, plan, Yj, Wv):
        from repro_torch.core.distributed import gather_rows, gee_sharded
        d, cfg = plan.data, plan.config
        Y_pad = torch.cat([Yj.to(torch.int32), torch.full(
            (d["n_pad"] - plan.n,), -1, dtype=torch.int32,
            device=Yj.device)])
        Z, dropped = gee_sharded(
            d["u"], d["v"], d["w"], Y_pad, K=cfg.K, n=d["n_pad"],
            mesh=d["mesh"], mode=self.mode,
            capacity_factor=d["capacity_factor"])
        if self.mode != "replicated":
            Z = gather_rows(Z, d["mesh"])
        return Z[:plan.n], {"dropped": int(dropped)}


for _mode in ("replicated", "reduce_scatter", "a2a", "ring"):
    # replicated / reduce_scatter are scatter + collective paths (float
    # tolerance); a2a / ring bucket with capacity padding
    register_backend(f"distributed:{_mode}")(
        type(f"Distributed{_mode.title().replace('_', '')}Backend",
             (DistributedBackend,),
             {"mode": _mode,
              "exact": _mode in ("replicated", "reduce_scatter")}))


# -- backend="auto": the plan-time selection policy -------------------------

#: edge count past which one device should stream chunks instead of
#: holding the whole edge list (the reference's threshold, set for the
#: TPU; kept until the port measures its own)
AUTO_STREAMING_EDGES = 32_000_000


def _rule_multi_device(n, s, device_kind, device_count):
    return "distributed:reduce_scatter" if device_count > 1 else None


def _rule_out_of_core(n, s, device_kind, device_count):
    return "streaming" if s >= AUTO_STREAMING_EDGES else None


def _rule_cuda_kernel(n, s, device_kind, device_count):
    return "cuda" if device_kind == "cuda" else None


#: ordered (name, rule) pairs; the first rule returning a name wins,
#: fallback "torch".  Data, not code: mutate to change the policy.
AUTO_POLICY: List[Tuple[str, Callable]] = [
    ("multi_device", _rule_multi_device),
    ("out_of_core", _rule_out_of_core),
    ("cuda_kernel", _rule_cuda_kernel),
]


def resolve_auto(n: int, s: int, *, device_kind: Optional[str] = None,
                 device_count: Optional[int] = None, mesh=None) -> str:
    """Resolve `backend="auto"` for a graph of (n, s) on a device kind
    ("cuda" or "cpu"; default: the mesh's, else "cuda").  device_count
    defaults to the ranks of `mesh`, else of the initialized default
    process group, else 1: an SPMD program's devices are its ranks, not
    the cards a process can see."""
    from repro_torch.core.distributed import world_size
    if device_kind is None:
        device_kind = mesh.device_type if mesh is not None else "cuda"
    if device_count is None:
        device_count = world_size(mesh)
    for _, rule in AUTO_POLICY:
        name = rule(n, s, device_kind, device_count)
        if name is not None:
            return name
    return "torch"
