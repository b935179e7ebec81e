"""Weights carried over from the JAX package.

The port cannot draw `jax.random`'s bits, so to compare the two packages
on the same model the tests build the reference's `init_params` tree,
turn it into numpy, and carry it over with `params_from_jax`.  Both then
compute the same function.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import ParamTree, dtype_of, spec_leaves
from repro_torch.models.model import param_specs


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def params_from_jax(cfg, tree: Dict[str, Any], *, device="cuda") -> ParamTree:
    """The port's parameters from the reference's `init_params` tree (a
    nested dict of arrays, keyed and stacked as `param_specs` builds it).
    Every leaf's shape is checked; a missing or extra key raises."""
    device = resolve_device(device)
    specs = dict(spec_leaves(param_specs(cfg)))
    flat = dict(_flatten(tree))
    missing = sorted(set(specs) - set(flat))
    extra = sorted(set(flat) - set(specs))
    if missing or extra:
        raise KeyError(f"{cfg.name}: parameter keys differ from the "
                       f"port's: missing {missing}, extra {extra}")
    out: Dict[str, Any] = {}
    for path, spec in specs.items():
        # a float32 copy: exact for float32 and bfloat16 leaves alike
        arr = np.array(flat[path], dtype=np.float32)
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {tuple(spec.shape)}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.as_tensor(arr).to(
            device=device, dtype=dtype_of(spec.dtype or cfg.param_dtype))
    return ParamTree(out)
