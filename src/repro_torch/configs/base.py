"""Config system of the port, a copy of `repro/configs/base.py`.

Every assigned architecture is a `ModelConfig`; the paper's own workload (the
classification view) is a `HazyConfig`. Configs are plain frozen dataclasses so
they can be constructed without touching any device. The sharding knobs
(`head_pad_to`, `logical_rules`, ...) are kept so the two packages read the
same configs; the one-GPU port runs attention on the real heads.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A decoder-only / enc-dec transformer-family backbone.

    Field semantics follow the assignment table; `family` selects the block
    assembly in models/transformer.py.
    """

    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm (rwkv6) | hybrid (jamba) | audio | vlm

    # Core dims
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # Attention details
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen1.5
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0

    # MoE (family == moe, or hybrid MoE layers)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0     # llama4-scout has 1 shared expert
    moe_capacity_factor: float = 1.25
    moe_every: int = 1              # MoE on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0

    # RWKV6 (family == ssm)
    rwkv_head_size: int = 64

    # Mamba (family == hybrid; jamba interleave)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0          # 0 => ceil(d_model / 16)
    attn_every: int = 8             # attention at layers where i % attn_every == attn_offset
    attn_offset: int = 3

    # Enc-dec (family == audio / whisper)
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500     # whisper frame count (stub frontend)

    # VLM (family == vlm / pixtral)
    num_image_tokens: int = 0       # stub patch embeddings prepended to the text

    # Numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""        # "" = dtype; "float8_e4m3fn" halves KV HBM
    norm_eps: float = 1e-5
    remat_policy: str = "full"      # none | dots | full (full fits v5e HBM; see §Perf)
    microbatches: int = 1           # gradient-accumulation steps per train step
    # Analysis-only: replace inner lax.scans (ssm chunks, loss chunks) with
    # python loops so cost_analysis counts every iteration (XLA counts while
    # bodies exactly once — see launch/analysis.py).
    unroll_inner_scans: bool = False
    scan_layers: bool = True

    # Sharding knobs
    head_pad_to: int = 0            # pad q (and MHA kv) heads to this count in-step; 0 = no pad
    mha_kv_padding: bool = True     # §Perf H3: shard MHA kv by padded heads
    logical_rules: str = "tp"       # tp | fsdp (small archs)

    # Notes for DESIGN.md / provenance
    source: str = ""

    @property
    def num_q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def padded_heads(self) -> int:
        return self.head_pad_to if self.head_pad_to else self.num_heads

    @property
    def cache_dtype(self) -> str:
        return self.kv_cache_dtype or self.dtype

    @property
    def mha_padded(self) -> bool:
        """MHA archs pad kv heads alongside q: attention is then fully
        head-sharded with zero kv gathers (§Perf H3)."""
        return (self.mha_kv_padding and bool(self.head_pad_to)
                and self.num_kv_heads == self.num_heads)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank if self.mamba_dt_rank else -(-self.d_model // 16)

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def padded_vocab(self, multiple: int = 512) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return i % self.moe_every == self.moe_offset

    def is_attn_layer(self, i: int) -> bool:
        """For hybrid (jamba): which layers are attention (rest are mamba)."""
        if self.family != "hybrid":
            return True
        return i % self.attn_every == self.attn_offset


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment table."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Reduced shapes for smoke tests (same kinds, CPU-sized).
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeConfig("long_500k", 128, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class HazyConfig:
    """The paper's classification-view workload (core contribution)."""

    name: str = "hazy_view"
    num_entities: int = 1 << 16
    feature_dim: int = 256
    # Hölder conjugates (p, q); (inf, 1) for l1-normalized text (paper §3.2).
    holder_p: float = float("inf")
    holder_q: float = 1.0
    alpha: float = 1.0              # SKIING alpha (paper uses 1.0 everywhere)
    policy: str = "eager"           # eager | lazy | hybrid
    method: str = "svm"             # svm | logistic | ridge
    learning_rate: float = 0.1
    l2_reg: float = 1e-4
    buffer_frac: float = 0.01       # hybrid buffer = 1% of entities (paper §4.2)
    band_capacity_frac: float = 1 / 64  # jit-path static band capacity
    dtype: str = "float32"
    feature_dtype: str = "bfloat16"
