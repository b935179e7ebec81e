"""repro_torch.encoder — the GEE embedding API in PyTorch.

    from repro_torch.encoder import Embedder, EncoderConfig
    emb = Embedder(EncoderConfig(K=5), device="cpu").fit(graph, Y)

Backends: numpy, torch, cuda, streaming, or "auto" (resolved at plan
time from (n, s, device kind, device count) via `AUTO_POLICY`).
"""
from repro_torch.encoder.backends import (AUTO_POLICY, Backend, get_backend,
                                          list_backends, register_backend,
                                          resolve_auto)
from repro_torch.encoder.config import EncoderConfig
from repro_torch.encoder.embedder import Embedder, NotFittedError
from repro_torch.encoder.plan import Plan

__all__ = ["AUTO_POLICY", "Backend", "Embedder", "EncoderConfig",
           "NotFittedError", "Plan", "get_backend", "list_backends",
           "register_backend", "resolve_auto"]
