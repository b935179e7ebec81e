"""Configuration dataclasses: the port's copy of `repro.configs.base`.

Every architecture in the assigned pool is described by a ModelConfig;
every benchmark shape by a ShapeSpec.  Configs are plain frozen
dataclasses of the standard library, so this is the reference's file
with one change: `param_count` counts with `repro_torch.models.model`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""
    num_experts: int
    top_k: int
    num_shared: int = 0          # always-on shared experts (qwen2-moe style)
    expert_d_ff: int = 0         # hidden dim per routed expert
    shared_d_ff: int = 0         # hidden dim of the shared expert block
    capacity_factor: float = 1.25    # tokens kept per expert bucket;
    # set >= num_experts/top_k for dropless routing (serving equivalence)
    router_jitter: float = 0.0
    # capacity factor only matters for dropping implementations; we use
    # dropless dense-gather einsum routing (see models/moe.py).


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""
    state: int = 64              # N: per-head state size
    conv: int = 4                # depthwise conv width
    expand: int = 2              # d_inner = expand * d_model
    head_dim: int = 64           # P: channels per SSM head
    chunk: int = 256             # chunked-scan block length


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block mix (arXiv:2405.04517)."""
    slstm_every: int = 8         # one sLSTM block every N blocks (rest mLSTM)
    mlstm_expand: int = 2        # up-projection factor for mLSTM
    mlstm_chunk: int = 256       # chunkwise-parallel block length


@dataclass(frozen=True)
class ShapeSpec:
    """A benchmark cell's input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, ShapeSpec] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture (exact dims from the public source)."""
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # --- block construction -------------------------------------------------
    head_dim: int = 0            # 0 -> d_model // n_heads
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    learned_pos: bool = False    # learned absolute positions (whisper)
    tie_embeddings: bool = False
    swa_window: int = 0          # >0: sliding-window attention
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    attn_every: int = 0          # zamba2: shared attn block every N ssm layers
    # --- encoder-decoder (whisper) ------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0          # 0 -> decoder-only with n_layers
    n_frames: int = 0            # audio frontend stub: frames fed to encoder
    # --- numerics / scale ---------------------------------------------------
    param_dtype: str = "float32"
    state_dtype: str = "float32"     # optimizer m/v dtype
    compute_dtype: str = "bfloat16"
    vocab_pad: int = 128         # pad vocab to a multiple of this
    remat: bool = True
    scan_layers: bool = True
    # --- serving ------------------------------------------------------------
    sub_quadratic: bool = False  # True -> long_500k applies
    decode_seq_shard: bool = False   # seq-sharded flash-decoding path
    attn_chunk: int = 1_024      # KV-block size for chunked (flash) attention
    notes: str = ""

    # -------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, self.vocab_pad)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def shapes(self) -> Tuple[ShapeSpec, ...]:
        """Shapes applicable to this arch (long_500k needs sub-quadratic)."""
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.sub_quadratic:
            out.append(LONG_500K)
        return tuple(out)

    def skipped_shapes(self) -> Tuple[str, ...]:
        return () if self.sub_quadratic else (LONG_500K.name,)

    # -------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (exact for our implementation)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)

    # -------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Family-preserving reduced config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=256,
            vocab_pad=8,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            decode_seq_shard=False,
            attn_chunk=32,
        )
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe, num_experts=4, top_k=2,
                num_shared=min(self.moe.num_shared, 1),
                expert_d_ff=32, shared_d_ff=64 if self.moe.shared_d_ff else 0)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state=8, head_dim=8, chunk=16)
        if self.xlstm is not None:
            kw["xlstm"] = replace(self.xlstm, slstm_every=2, mlstm_chunk=16)
        if self.attn_every:
            kw["attn_every"] = 2
        if self.is_encdec:
            kw["enc_layers"] = 2
            kw["dec_layers"] = 2
            kw["n_frames"] = 8
        if self.swa_window:
            kw["swa_window"] = 32
        return replace(self, **kw)


@dataclass(frozen=True)
class GraphSpec:
    """A GEE benchmark graph (paper Table I analogs + synthetic)."""
    name: str
    n: int                       # nodes
    s: int                       # edges
    K: int = 50                  # classes
    labeled_frac: float = 0.10   # paper: 10% of nodes labeled
    generator: str = "erdos_renyi"   # erdos_renyi | sbm | powerlaw
    seed: int = 0


# Paper Table I graphs (exact n, s) — used for the dry-run-scale roofline;
# benchmarks run scaled-down versions that fit one CPU core.
PAPER_GRAPHS: dict[str, GraphSpec] = {
    "twitch": GraphSpec("twitch", 168_000, 6_800_000),
    "soc-pokec": GraphSpec("soc-pokec", 1_600_000, 30_000_000),
    "soc-livejournal": GraphSpec("soc-livejournal", 6_400_000, 69_000_000),
    "soc-orkut": GraphSpec("soc-orkut", 3_000_000, 117_000_000),
    "orkut-groups": GraphSpec("orkut-groups", 3_000_000, 327_000_000),
    "friendster": GraphSpec("friendster", 65_000_000, 1_800_000_000),
}
