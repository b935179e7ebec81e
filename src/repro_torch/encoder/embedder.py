"""Embedder: the one front door for GEE, in PyTorch.

    cfg = EncoderConfig(K=16)
    emb = Embedder(cfg, backend="cuda").fit(graph, Y)   # device="cuda"
    Z   = emb.transform()                 # (n, K) numpy
    emb.partial_fit(delta_graph)          # O(batch) exact update
    emb.refit(Y_new)                      # reuse the plan

The port of `repro.encoder.Embedder`.  The Embedder lives on one
explicit device, "cuda" by default; it refuses to be built for a card
that is not there.  The distributed backends run over `mesh` (an
`edge_mesh` of the same device type; by default a one-rank mesh).  It
owns the projection weights Wv: `make_w(Y, K)` is computed at fit time
and used by every later `partial_fit`.

`plan` is a two-tier cache, as the reference's: tier 1 matches the very
same edge arrays in O(1); tier 2 (`plan_cache`: "auto", a directory, a
`PlanDiskCache`, or None) is the persistent cache keyed on the graph's
content fingerprint, so a fresh process skips the plan's host half.
Telemetry carries the reference's names: the spans ``encoder.plan``,
``encoder.fit`` and ``encoder.refine`` and the ``repro_encoder_*``
series (plan-cache events, plan, fit, refine, partial-fit and transform
seconds, fit edges/s, delta edges).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.gee import (gee_apply_delta, gee_apply_delta_owned,
                                  kmeans_refine_round, make_w)
from repro_torch.device import resolve_device
from repro_torch.encoder.backends import (Backend, get_backend,
                                          partition_backends, resolve_auto)
from repro_torch.encoder.config import EncoderConfig
from repro_torch.encoder.plan import Plan, owned_contributions
from repro_torch.encoder.plan_cache import PlanDiskCache, resolve_cache
from repro_torch.graph.edges import Graph
from repro_torch.graph.sources import as_graph


class NotFittedError(RuntimeError):
    pass


def _host_arrays(host: dict) -> dict:
    """A plan's host half as numpy, for the disk (the cuda backend's
    arrays are tensors on the device they were sorted on)."""
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in host.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Embedder:
    """Unified GEE embedding API over pluggable backends.

    Fitted state (sklearn-style trailing underscore):
      Z_        (n_local, K) float32 embedding (tensor on `device`).
      labels_   the labels Z was built under (numpy int32, -1 unknown).
      Wv_       per-node projection weights Z was built with (tensor).
    """

    def __init__(self, config: EncoderConfig, *,
                 backend: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda", mesh=None,
                 plan_cache: Union[str, PlanDiskCache, None] = "auto"):
        self.config = config
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"mesh of {mesh.device_type} ranks for an "
                             f"Embedder on {self.device}")
        self.mesh = mesh
        spec = backend if backend is not None else config.backend
        self._backend_spec = spec
        #: resolved Backend; None until the first plan() when spec="auto"
        self.backend: Optional[Backend] = (
            None if spec == "auto" else get_backend(spec))
        self.plan_cache: Optional[PlanDiskCache] = resolve_cache(plan_cache)
        self._plan: Optional[Plan] = None
        self._deltas_applied = 0       # partial_fits since the last embed
        self._Yj = self._Yfit = None
        self._Wv_host: Optional[np.ndarray] = None
        self.Z_: Optional[torch.Tensor] = None
        self.labels_: Optional[np.ndarray] = None
        self.Wv_: Optional[torch.Tensor] = None
        self.last_info_: dict = {}
        self.plan_stats = {"built": 0, "hits": 0,
                           "disk_hits": 0, "disk_stores": 0}

    def _bump_plan_stat(self, key: str) -> None:
        """plan_stats increment, mirrored into
        ``repro_encoder_plan_cache_total{event=...}``."""
        self.plan_stats[key] += 1
        obs.counter("repro_encoder_plan_cache_total",
                    event={"hits": "tier1_hit", "built": "built",
                           "disk_hits": "disk_hit",
                           "disk_stores": "disk_store"}[key])

    # -- planning ----------------------------------------------------------

    def _resolve_backend(self, graph: Graph) -> Backend:
        if self._backend_spec == "auto":
            name = resolve_auto(graph.n, graph.s,
                                device_kind=self.device.type,
                                mesh=self.mesh)
            if self.backend is None or self.backend.name != name:
                self.backend = get_backend(name)
        return self.backend

    def plan(self, graph) -> Plan:
        """Build (or reuse) the label-free preprocessing for `graph` (a
        Graph or a GraphSource).

        Tier 1: the plan matches iff it was built against the very same
        arrays.  Tier 2: on a tier-1 miss the graph's fingerprint, the
        resolved backend and the config key a persistent entry holding
        the plan's host half; a hit skips `plan_host` and only uploads.
        Stale or corrupt entries are rebuilt; `plan_cache=None` (or
        REPRO_PLAN_CACHE=off) turns the tier off."""
        graph = as_graph(graph)
        backend = self._resolve_backend(graph)
        rp = self.config.row_partition
        if rp is not None:
            if not backend.supports_row_partition:
                raise ValueError(
                    f"backend {backend.name!r} has no owned-rows "
                    "accumulate path (row_partition): the distributed:* "
                    "modes shard across the mesh's ranks instead; use "
                    "one of the partition-aware backends: "
                    f"{', '.join(partition_backends())}")
            if rp[1] > graph.n:
                raise ValueError(f"row_partition {rp} exceeds graph "
                                 f"n={graph.n}")
        if self._plan is not None and self._plan.matches(
                graph, backend.name, self.config):
            self._bump_plan_stat("hits")
            return self._plan
        graph.validate()
        # fitted state belonged to the old plan's graph
        self.Z_ = self.labels_ = self.Wv_ = None
        self._Yj = self._Yfit = self._Wv_host = None
        self._deltas_applied = 0
        self.last_info_ = {}
        with obs.span("encoder.plan", backend=backend.name, n=graph.n,
                      s=graph.s) as sp:
            meta = host = None
            cache = self.plan_cache if backend.persistable else None
            if cache is not None:
                meta = cache.describe(graph.fingerprint(), backend,
                                      self.config, mesh=self.mesh)
                host = cache.load(meta)
            if host is not None:
                self._bump_plan_stat("disk_hits")
                self._plan = backend.plan(graph, self.config, self.device,
                                          host=host, mesh=self.mesh)
                source = "disk"
            else:
                self._plan = backend.plan(graph, self.config, self.device,
                                          mesh=self.mesh)
                self._bump_plan_stat("built")
                if meta is not None and cache.store(
                        meta, _host_arrays(self._plan.host)):
                    self._bump_plan_stat("disk_stores")
                source = "built"
            sp.set(source=source)
        if obs.enabled():
            obs.observe("repro_encoder_plan_seconds", sp.duration,
                        backend=backend.name, source=source)
        return self._plan

    # -- fitting -----------------------------------------------------------

    def fit(self, graph, Y) -> "Embedder":
        """Embed `graph` (a Graph or a GraphSource) under labels `Y`
        (int, -1 = unknown)."""
        return self._embed(self.plan(graph), Y)

    def refit(self, Y=None) -> "Embedder":
        """Re-embed under new labels with the cached plan; Y=None keeps
        the current labels.  Refused after `partial_fit` (the plan holds
        the ORIGINAL edges: a refit would drop every applied delta)."""
        if self._plan is None or self.Z_ is None:
            raise NotFittedError("refit() requires a fitted state (fit() "
                                 "first)")
        self._check_no_pending_deltas("refit")
        self._bump_plan_stat("hits")
        return self._embed(self._plan, self.labels_ if Y is None else Y)

    def _check_no_pending_deltas(self, what: str) -> None:
        if self._deltas_applied:
            raise RuntimeError(
                f"{what}() after {self._deltas_applied} partial_fit(s) "
                "would re-embed the plan's ORIGINAL edge multiset and "
                "silently discard the applied deltas; fit() on the live "
                "graph instead")

    def _check_labels(self, plan: Plan, Y) -> np.ndarray:
        Y = np.asarray(Y, np.int32)
        if Y.shape != (plan.n,):
            raise ValueError(f"Y shape {Y.shape} != ({plan.n},)")
        if Y.size and Y.max() >= self.config.K:
            raise ValueError(f"label {Y.max()} >= K={self.config.K}")
        return Y

    def _set_labels(self, Y: np.ndarray) -> None:
        self.labels_ = Y.copy()
        self._Yj = torch.as_tensor(self.labels_, device=self.device)
        self._Yfit = self._Yj      # supervised set: pinned by refine()

    def _embed(self, plan: Plan, Y) -> "Embedder":
        Y = self._check_labels(plan, Y)
        name = self.backend.name
        with obs.span("encoder.fit", metric="repro_encoder_fit_seconds",
                      mlabels={"backend": name}, backend=name, n=plan.n,
                      s=plan.s) as sp:
            self._set_labels(Y)
            self.Wv_ = make_w(self._Yj, self.config.K)
            self._Wv_host = self.Wv_.cpu().numpy()
            self.Z_, self.last_info_ = self.backend.embed(plan, self._Yj,
                                                          self.Wv_)
            sp.fence(self.Z_)       # bill the device work to the fit
        if obs.enabled() and plan.s and sp.duration > 0:
            obs.gauge("repro_encoder_fit_edges_per_s",
                      plan.s / sp.duration, backend=name)
        self._deltas_applied = 0
        return self

    def load_state(self, graph: Graph, *, Z, labels, Wv) -> "Embedder":
        """Plan `graph` and install a fitted state computed elsewhere
        (e.g. the reference package's `Z_`, `labels_`, `Wv_` as numpy),
        so deltas and queries continue from it."""
        plan = self.plan(graph)
        Y = self._check_labels(plan, labels)
        Z = torch.tensor(np.asarray(Z, np.float32), device=self.device)
        if tuple(Z.shape) != (plan.n_local, self.config.K):
            raise ValueError(f"Z shape {tuple(Z.shape)} != "
                             f"({plan.n_local}, {self.config.K})")
        Wv = np.asarray(Wv, np.float32)
        if Wv.shape != (plan.n,):
            raise ValueError(f"Wv shape {Wv.shape} != ({plan.n},)")
        self._set_labels(Y)
        self._Wv_host = Wv.copy()
        self.Wv_ = torch.as_tensor(self._Wv_host, device=self.device)
        self.Z_ = Z
        self._deltas_applied = 0
        return self

    def _check_delta(self, delta: Graph, what: str) -> None:
        if self.Z_ is None:
            raise NotFittedError(f"{what}() before fit()")
        if self.config.laplacian:
            raise ValueError(
                f"{what} is exact only for laplacian=False: degree "
                "scaling makes Z nonlinear in the edge multiset — refit "
                "on the updated graph instead")
        if delta.n != self.n_:
            raise ValueError(f"delta graph has n={delta.n}, fitted "
                             f"n={self.n_}")
        delta.validate()

    def partial_fit(self, delta: Graph, *, sign: float = 1.0
                    ) -> "Embedder":
        """Fold an edge delta into Z exactly (Z is linear in the edge
        multiset).  sign=+1 inserts, sign=-1 deletes.  Uses the owned
        (labels_, Wv_) pair."""
        self._check_delta(delta, "partial_fit")
        if delta.s == 0:
            return self
        t0 = obs.tick()
        dev, K = self.device, self.config.K
        rp = self.config.row_partition
        if rp is not None:
            rows, src, w = owned_contributions(delta, delta.w, *rp)
            if rows.shape[0] == 0:
                return self
            self.Z_ = gee_apply_delta_owned(
                self.Z_, torch.as_tensor(rows, device=dev),
                torch.as_tensor(src, device=dev),
                torch.as_tensor(w, device=dev), self._Yj, self.Wv_, K=K,
                sign=sign)
        else:
            self.Z_ = gee_apply_delta(
                self.Z_, torch.as_tensor(delta.u, device=dev),
                torch.as_tensor(delta.v, device=dev),
                torch.as_tensor(delta.w, device=dev), self._Yj, self.Wv_,
                K=K, sign=sign)
        self._deltas_applied += 1
        self._record_partial_fit(t0, delta.s)
        return self

    def partial_fit_norm(self, delta: Graph, *, sign: float = 1.0
                         ) -> torch.Tensor:
        """`partial_fit` fused with renormalization
        (`kernels.query_fused.gee_delta_renorm`): fold the delta into Z
        AND return Zn, the unit-normalized fitted rows (a shard's query
        cache), with Z read once.  Classes and values resolve on the
        host from the fitted (labels_, Wv_) pair; the delta goes to the
        kernel as one short list sorted by local row."""
        self._check_delta(delta, "partial_fit_norm")
        from repro_torch.kernels.query_fused import gee_delta_renorm
        t0 = obs.tick()
        rp = self.config.row_partition
        if delta.s == 0:
            rows = src = np.zeros(0, np.int32)
            w = np.zeros(0, np.float32)
        elif rp is not None:
            rows, src, w = owned_contributions(delta, delta.w, *rp)
        else:
            u, v = np.asarray(delta.u), np.asarray(delta.v)
            rows = np.concatenate([u, v]).astype(np.int32)
            src = np.concatenate([v, u]).astype(np.int32)
            w = np.concatenate([delta.w, delta.w]).astype(np.float32)
        Ys = self.labels_[src]
        clsv = np.maximum(Ys, 0).astype(np.int32)
        val = (np.where(Ys >= 0, self._Wv_host[src] * w, np.float32(0))
               * np.float32(sign)).astype(np.float32)
        order = np.argsort(rows, kind="stable")
        dev = self.device
        self.Z_, Zn = gee_delta_renorm(
            self.Z_, torch.as_tensor(rows[order], device=dev),
            torch.as_tensor(clsv[order], device=dev),
            torch.as_tensor(val[order], device=dev))
        if rows.shape[0]:
            self._deltas_applied += 1
        self._record_partial_fit(t0, delta.s)
        return Zn

    def _record_partial_fit(self, t0: float, s: int) -> None:
        """Registry metrics for one applied delta (obs on only: the
        device is synchronized so the latency is real)."""
        if not obs.enabled():
            return
        _sync(self.device)
        obs.observe("repro_encoder_partial_fit_seconds", obs.tock(t0),
                    backend=self.backend.name)
        obs.counter("repro_encoder_delta_edges_total", s)

    # -- refinement --------------------------------------------------------

    def refine(self, seed: int = 0) -> "Embedder":
        """Unsupervised GEE clustering (embed -> k-means -> reassign,
        `config.refine_iters` rounds) through the configured backend and
        the cached plan.  Labels supervised at fit time stay pinned;
        unknowns bootstrap from a `torch.Generator` seeded with `seed`
        (other bits than the reference's `jax.random`).  One
        ``encoder.refine`` span."""
        if self._plan is None or self._Yfit is None:
            raise NotFittedError("refine() before fit()")
        self._require_full_rows("refine")
        self._check_no_pending_deltas("refine")
        cfg = self.config
        gen = torch.Generator().manual_seed(int(seed))
        with obs.span("encoder.refine",
                      metric="repro_encoder_refine_seconds",
                      backend=self.backend.name,
                      iters=cfg.refine_iters) as sp:
            rand = torch.randint(0, cfg.K, (self._plan.n,), generator=gen,
                                 dtype=torch.int32).to(self.device)
            Y0 = self._Yfit
            labels = torch.where(Y0 >= 0, Y0, rand)
            for _ in range(cfg.refine_iters):
                Z, _ = self.backend.embed(self._plan, labels,
                                          make_w(labels, cfg.K))
                labels = kmeans_refine_round(Z, labels, Y0, cfg.K,
                                             cfg.kmeans_iters)
            self.labels_ = labels.cpu().numpy()
            self._Yj = labels
            self.Wv_ = make_w(labels, cfg.K)
            self._Wv_host = self.Wv_.cpu().numpy()
            self.Z_, self.last_info_ = self.backend.embed(
                self._plan, labels, self.Wv_)
            sp.fence(self.Z_)
        return self

    # -- queries -----------------------------------------------------------

    @property
    def n_(self) -> int:
        if self._plan is None:
            raise NotFittedError("not fitted")
        return self._plan.n

    def _require_full_rows(self, what: str) -> None:
        if self.config.row_partition is not None:
            raise RuntimeError(
                f"{what}() needs the full embedding, but this Embedder "
                f"owns only rows {self.config.row_partition} "
                "(row_partition) — run it on an unpartitioned Embedder")

    def _rows(self, nodes) -> torch.Tensor:
        """Z rows for GLOBAL node ids, bounds-checked."""
        if self.Z_ is None:
            raise NotFittedError("not fitted")
        if nodes is None:
            return self.Z_
        nodes = np.asarray(nodes)
        lo, hi = self.config.row_partition or (0, self.n_)
        if nodes.size and (nodes.min() < lo or nodes.max() >= hi):
            owned = " owned" if self.config.row_partition else ""
            raise IndexError(f"node ids must be in{owned} [{lo}, {hi}), "
                             f"got range [{nodes.min()}, {nodes.max()}]")
        return self.Z_[torch.as_tensor(nodes - lo, device=self.device)]

    def transform(self, nodes=None) -> np.ndarray:
        """Z rows for `nodes` (all fitted rows if None), in
        config.dtype, as numpy.  Node ids are always GLOBAL."""
        t0 = obs.tick()
        Z = self._rows(nodes)
        out = Z.to(getattr(torch, self.config.dtype)).cpu().numpy()
        if obs.enabled():
            obs.observe("repro_encoder_transform_seconds", obs.tock(t0))
        return out

    def predict(self, nodes=None) -> np.ndarray:
        """argmax-Z class prediction (the first maximum, as jnp.argmax)."""
        return torch.argmax(self._rows(nodes), dim=1).to(
            torch.int32).cpu().numpy()

    def to_features(self, d_model: int, *,
                    generator: Optional[torch.Generator] = None,
                    blend: float = 0.5) -> np.ndarray:
        """Project the fitted Z into an (n, d_model) feature table, the
        GEE -> LM bridge (embedding-table initialization).

        Rows of Z are unit-normalized, rotated K -> d_model by a fixed
        random near-isometry and blended with scaled Gaussian noise: the
        scale of a 1/sqrt(d) init, with nodes that GEE places together
        given similar rows.  ``blend`` in [0, 1]: 1 = pure structure,
        0 = pure noise.  The rotation, then the noise, are drawn from
        `generator` (default: a CPU `torch.Generator` seeded with 0;
        other bits than the reference's `jax.random`)."""
        if self.Z_ is None:
            raise NotFittedError("to_features() before fit()")
        self._require_full_rows("to_features")
        gen = (generator if generator is not None
               else torch.Generator().manual_seed(0))
        K, n = self.config.K, self.n_
        R = torch.randn((K, d_model), generator=gen, device=gen.device,
                        dtype=torch.float32).to(self.device) / np.sqrt(K)
        noise = torch.randn((n, d_model), generator=gen, device=gen.device,
                            dtype=torch.float32).to(self.device)
        Z = self.Z_ / torch.clamp_min(
            torch.linalg.vector_norm(self.Z_, dim=1, keepdim=True), 1e-9)
        scale = 1.0 / np.sqrt(d_model)
        table = scale * (blend * (Z @ R) * np.sqrt(d_model)
                         + (1 - blend) * noise)
        return table.to(torch.float32).cpu().numpy()
