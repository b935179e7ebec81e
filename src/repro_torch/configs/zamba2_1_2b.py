"""zamba2-1.2b — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
38 Mamba2 layers with ONE shared (weight-tied) attention+FFN block
applied every `attn_every` mamba layers (zamba2's distinguishing trick).
SSM backbone -> sub-quadratic -> long_500k applies.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    ssm=SSMConfig(state=64, conv=4, expand=2, head_dim=64, chunk=256),
    attn_every=6,                # shared attn block after every 6 mamba layers
    sub_quadratic=True,
)
