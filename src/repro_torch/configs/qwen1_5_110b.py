"""qwen1.5-110b — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    sub_quadratic=False,
    decode_seq_shard=True,        # kv=8 < model 16 and 1.4 TB cache at 32k
    param_dtype="bfloat16",       # 110B: f32 params+states would be 1.7 TB
    state_dtype="float32",
)
