"""GEE math in PyTorch (`gee`), its host oracles (`ref_python`) and the
collective modes over `torch.distributed` (`distributed`).

New code goes through the front door, ``repro_torch.encoder.Embedder``.
The per-strategy functions below are the backends' internals,
re-exported here lazily (PEP 562) as the reference's ``repro.core``
does:

    gee_refine, gee_streaming, gee_apply_delta, gee_dense_oracle,
    make_w                      <- repro_torch.core.gee
    gee_distributed, gee_sharded, edge_mesh, exact_capacity_factor
                                <- repro_torch.core.distributed
    gee_numpy, gee_python       <- repro_torch.core.ref_python

(``repro_torch.core.gee`` stays the submodule.)
"""
from __future__ import annotations

import importlib

_FORWARDS = {
    "gee_refine": "repro_torch.core.gee",
    "gee_streaming": "repro_torch.core.gee",
    "gee_apply_delta": "repro_torch.core.gee",
    "gee_dense_oracle": "repro_torch.core.gee",
    "make_w": "repro_torch.core.gee",
    "gee_distributed": "repro_torch.core.distributed",
    "gee_sharded": "repro_torch.core.distributed",
    "edge_mesh": "repro_torch.core.distributed",
    "exact_capacity_factor": "repro_torch.core.distributed",
    "gee_numpy": "repro_torch.core.ref_python",
    "gee_python": "repro_torch.core.ref_python",
}

__all__ = sorted(_FORWARDS)


def __getattr__(name: str):
    if name in _FORWARDS:
        return getattr(importlib.import_module(_FORWARDS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
