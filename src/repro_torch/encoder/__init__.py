"""repro_torch.encoder — the GEE embedding API in PyTorch.

    from repro_torch.encoder import Embedder, EncoderConfig
    emb = Embedder(EncoderConfig(K=5), device="cpu").fit(graph, Y)

Backends: numpy, torch, cuda, streaming, distributed:{replicated,
reduce_scatter, a2a, ring}, or "auto" (resolved at plan time from (n,
s, device kind, rank count) via `AUTO_POLICY`).  The
persistent plan cache (`plan_cache.PlanDiskCache`, REPRO_PLAN_CACHE to
relocate or disable) lets a fresh process skip a known graph's host
planning.
"""
from repro_torch.encoder.backends import (AUTO_POLICY, Backend, get_backend,
                                          list_backends, register_backend,
                                          resolve_auto)
from repro_torch.encoder.config import EncoderConfig
from repro_torch.encoder.embedder import Embedder, NotFittedError
from repro_torch.encoder.plan import Plan
from repro_torch.encoder.plan_cache import PlanDiskCache, default_cache

__all__ = ["AUTO_POLICY", "Backend", "Embedder", "EncoderConfig",
           "NotFittedError", "Plan", "PlanDiskCache", "default_cache",
           "get_backend", "list_backends", "register_backend",
           "resolve_auto"]
