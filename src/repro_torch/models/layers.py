"""Shared model building blocks + the ParamSpec system.

The port of `repro.models.layers`.  Every parameter is declared as a
ParamSpec (shape, logical axis names, init rule); `init_from_specs`
materializes a spec tree on one device as a `ParamTree`, the
`nn.Module` that holds a model's parameters under the reference's keys
(``params["stack"]["attn"]["wq"]``).  The logical axis names are kept
for parity with the reference; the port runs on one card, so nothing
reads them and the reference's activation-sharding hook (`ashard`) has
no counterpart.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


# ---------------------------------------------------------------------------
# ParamSpec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple               # logical axis name per dim (or None)
    init: str = "normal"   # normal | zeros | ones | mamba_a | dt_bias | pos
    dtype: Any = None            # None -> config param_dtype
    fan_in: int = 0              # 0 -> last-but-one dim (normal init scale)

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], tree):
    """Apply `fn` to every ParamSpec of a nested dict."""
    if is_spec(tree):
        return fn(tree)
    return {k: tree_map_specs(fn, v) for k, v in tree.items()}


def spec_leaves(tree, prefix=()):
    """(key path, spec) for every leaf, keys in sorted order (the order of
    `jax.tree_util.tree_flatten` over the reference's dicts)."""
    if is_spec(tree):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from spec_leaves(tree[k], prefix + (k,))


def stack_spec(spec: ParamSpec, n: int, axis_name: str = "layers") -> ParamSpec:
    return ParamSpec((n,) + spec.shape, (axis_name,) + spec.logical,
                     spec.init, spec.dtype, spec.fan_in)


def stack_specs(tree, n: int, axis_name: str = "layers"):
    return tree_map_specs(lambda s: stack_spec(s, n, axis_name), tree)


def count_specs(tree) -> int:
    return int(sum(math.prod(s.shape) for _, s in spec_leaves(tree)))


# ---------------------------------------------------------------------------
# Parameter container
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested dict of tensors as an `nn.Module`: each dict becomes a
    ParamTree, each tensor a Parameter, created without gradient (serving
    needs none); `tree.requires_grad_(True)` makes the tree trainable.
    ``tree["attn"]["wq"]`` reads like the reference's pytree.  A layer's
    view of a stacked leaf (`take`) passes its gradient into the stacked
    Parameter."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, ParamTree):
                self.add_module(k, v)
            elif isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)


def take(tree, i: int) -> Dict[str, Any]:
    """Layer i of a stacked tree: a nested dict of views (no copy)."""
    return {k: take(tree[k], i) if isinstance(tree[k], (ParamTree, dict))
            else tree[k][i] for k in tree.keys()}


# float32 elements drawn at a time for a leaf stored in another dtype:
# a 34 B-parameter bfloat16 model has 17 B-element leaves, whose float32
# draw in one piece would not fit beside the model on an 80 GB card
_DRAW_CHUNK = 1 << 26


def _draw(spec: ParamSpec, gen: torch.Generator,
          w: torch.Tensor) -> torch.Tensor:
    """Fill the float32 tensor `w` by `spec`'s random init rule."""
    if spec.init == "pos":
        # sinusoidal-ish small init for learned positions
        return w.normal_(0.0, 0.02, generator=gen)
    if spec.init == "mamba_a":
        # A_log init: log of uniform [1, 16] (mamba2 convention)
        return w.uniform_(1.0, 16.0, generator=gen).log_()
    if spec.init == "dt_bias":
        # softplus^-1 of dt ~ uniform[1e-3, 1e-1]
        return w.uniform_(1e-3, 1e-1, generator=gen).expm1_().log_()
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    # truncated-normal, 1/sqrt(fan_in)
    fan_in = spec.fan_in
    if fan_in == 0:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, default_dtype,
               device) -> torch.Tensor:
    dtype = dtype_of(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if dtype == torch.float32:
        return _draw(spec, gen, torch.empty(
            spec.shape, dtype=torch.float32, device=device))
    # drawn in float32 and rounded, a chunk of the flat leaf at a time
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), _DRAW_CHUNK):
        hi = min(lo + _DRAW_CHUNK, flat.numel())
        flat[lo:hi] = _draw(spec, gen, torch.empty(
            hi - lo, dtype=torch.float32, device=device))
    return out


def zeros_from_specs(specs, *, device):
    """A nested dict of zero tensors from a nested dict of ParamSpecs (a
    cache's), each in its spec's dtype; None stays None."""
    if specs is None:
        return None
    if is_spec(specs):
        return torch.zeros(specs.shape, dtype=dtype_of(specs.dtype),
                           device=device)
    return {k: zeros_from_specs(v, device=device) for k, v in specs.items()}


def _unflatten(pairs):
    out: Dict[str, Any] = {}
    for path, val in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return out


def init_from_specs(tree, gen: torch.Generator, default_dtype="float32", *,
                    device) -> ParamTree:
    """Materialize a spec tree on `device`, drawing from `gen` (a
    generator on that device) leaf by leaf in sorted key order.  The same
    distributions as the reference; not its bits (`torch.Generator` is
    not `jax.random`)."""
    return ParamTree(_unflatten(
        (path, _init_leaf(s, gen, default_dtype, device))
        for path, s in spec_leaves(tree)))


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    """Normalize in float32, cast back, then scale in x's dtype (the
    reference's rounding order)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


def norm_specs(cfg, dim: int):
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((dim,), ("embed",), "ones"),
                "bias": ParamSpec((dim,), ("embed",), "zeros")}
    return {"scale": ParamSpec((dim,), ("embed",), "ones")}


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def head_norm_specs(cfg, n_heads: int, dim: int):
    """Per-head RMS norm (qk-norm)."""
    return {"scale": ParamSpec((n_heads, dim), ("heads", None), "ones")}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates
    in float32 and casts back once."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    ang = positions[..., None].to(torch.float32) * freqs        # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1f = x[..., :half].to(torch.float32)
    x2f = x[..., half:].to(torch.float32)
    out = torch.cat([x1f * cos - x2f * sin, x1f * sin + x2f * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_specs(cfg, d_model: int, d_ff: int):
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
            "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
            "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
        }
    return {
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "b_up": ParamSpec((d_ff,), ("mlp",), "zeros"),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
        "b_down": ParamSpec((d_model,), ("embed",), "zeros"),
    }


def apply_mlp(cfg, p, x):
    cdt = x.dtype
    if cfg.act == "swiglu":
        g = x @ p["w_gate"].to(cdt)
        u = x @ p["w_up"].to(cdt)
        return (F.silu(g) * u) @ p["w_down"].to(cdt)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"].to(cdt) + p["b_up"].to(cdt), approximate="tanh")
    return h @ p["w_down"].to(cdt) + p["b_down"].to(cdt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg):
    v = cfg.padded_vocab
    sp = {"tokens": ParamSpec((v, cfg.d_model), ("vocab", "embed"),
                              fan_in=cfg.d_model)}
    if cfg.learned_pos:
        sp["positions"] = ParamSpec((8192, cfg.d_model), (None, "embed"), "pos")
    return sp


def embed_tokens(cfg, p, tokens, positions=None):
    x = p["tokens"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    if "positions" in p and positions is not None:
        pos_emb = p["positions"][torch.clamp(
            positions.long(), max=p["positions"].shape[0] - 1)]
        x = x + pos_emb.to(x.dtype)
    return x


def unembed_specs(cfg):
    return {"w": ParamSpec((cfg.d_model, cfg.padded_vocab),
                           ("embed", "vocab"))}


def unembed(cfg, p, x):
    return x @ p["w"].to(x.dtype)
