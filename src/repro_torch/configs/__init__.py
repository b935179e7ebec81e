"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

Lists only the architectures the port can run.  Any other id of the
reference's registry raises `NotImplementedError` (not ported yet); an
id neither package knows raises `KeyError`.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, PAPER_GRAPHS,
    GraphSpec, ModelConfig, MoEConfig, SSMConfig, ShapeSpec, XLSTMConfig,
)

# arch-id -> module, for the archs the port runs
_REGISTRY: dict[str, str] = {
    "yi-6b": "repro_torch.configs.yi_6b",
}
# the reference's other arch ids, still to port
_NOT_PORTED = ("xlstm-1.3b", "yi-9b", "h2o-danube-3-4b", "qwen1.5-110b",
               "chameleon-34b", "whisper-medium", "zamba2-1.2b",
               "qwen2-moe-a2.7b", "grok-1-314b")


def list_archs() -> list[str]:
    return list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported yet; "
                                  f"ported: {list_archs()}")
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch]).CONFIG


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]
