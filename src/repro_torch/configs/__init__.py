"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The reference's registry, in its order: every arch it runs, the port
runs.  An unknown id raises `KeyError`.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, PAPER_GRAPHS,
    GraphSpec, ModelConfig, MoEConfig, SSMConfig, ShapeSpec, XLSTMConfig,
)

# arch-id -> module (exact ids from the assignment)
_REGISTRY: dict[str, str] = {
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
}


def list_archs() -> list[str]:
    return list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch]).CONFIG


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, including inapplicable-marked ones."""
    cells = []
    for arch in _REGISTRY:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            cells.append((arch, shape.name))
    return cells
