"""chameleon-34b — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion means image patches are VQ-quantized into ordinary tokens in
the shared 65536 vocab — the modality frontend is a STUB (token ids are
the input; the VQ tokenizer is out of scope per the brief).  Backbone is
a dense GQA decoder with qk-norm (chameleon's stabilizer).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    sub_quadratic=False,
    decode_seq_shard=True,
    param_dtype="bfloat16",
)
