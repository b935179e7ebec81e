"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
carry their own up-projections (mlstm_expand), there is no separate FFN.
Attention-free -> sub-quadratic -> long_500k applies.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=512,
    norm="layernorm",
    act="gelu",
    use_rope=False,
    xlstm=XLSTMConfig(slstm_every=8, mlstm_expand=2, mlstm_chunk=256),
    sub_quadratic=True,
    notes="sLSTM every 8th block, mLSTM elsewhere; recurrent-state decode",
)
