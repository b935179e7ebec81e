"""grok-1-314b — 8 experts top-2 [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
314B params: bf16 params + bf16 adam states to fit 256 x 16 GB HBM
(2+2+2+2 = 8 B/param = 2.5 TB -> 9.8 GB/chip).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=0, expert_d_ff=32768),
    sub_quadratic=False,
    decode_seq_shard=True,
    param_dtype="bfloat16",
    state_dtype="bfloat16",
)
