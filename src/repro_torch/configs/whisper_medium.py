"""whisper-medium — enc-dec, conv frontend (stub) [arXiv:2212.04356].

24L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865.
24 encoder + 24 decoder layers; learned positions, LayerNorm + GELU.
The conv1d audio frontend is a STUB: input_specs() provides precomputed
frame embeddings (batch, n_frames=1500, d_model) per the brief.
vocab 51865 is padded to 51968 (multiple of 128) for model-axis sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    use_rope=False,
    learned_pos=True,            # learned absolute positions
    enc_layers=24,
    dec_layers=24,
    n_frames=1500,
    sub_quadratic=False,
)
