"""h2o-danube-3-4b — llama+mistral mix, SWA [arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
Sliding-window attention (mistral-style, 4096 window) -> sub-quadratic
decode (window-bounded KV cache) -> long_500k applies.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    head_dim=120,
    swa_window=4096,
    sub_quadratic=True,
)
