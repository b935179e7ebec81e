"""yi-9b — llama-arch GQA [arXiv:2403.04652; hf].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
    sub_quadratic=False,          # full attention -> long_500k skipped
    decode_seq_shard=True,        # kv=4 < model axis 16 -> flash-decoding SP
)
