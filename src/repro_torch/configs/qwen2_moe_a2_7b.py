"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (MHA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4.
d_ff=1408 is the per-expert hidden dim; the 4 shared experts form one
always-on block of 4*1408=5632 hidden.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, num_shared=4,
                  expert_d_ff=1408, shared_d_ff=4 * 1408),
    sub_quadratic=False,
)
