"""Assigned-architecture registry: exact configs + reduced smoke twins.

Sources are cited per the assignment table ([hf:...] / [arXiv:...]).
`head_pad_to` pads q-heads in-step to a multiple of the 16-way model axis
(math-exact zero padding, see models/layers.py) for archs whose head count
does not divide 16.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, SHAPES

ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


_register(ModelConfig(
    name="granite-3-2b", family="dense", num_layers=40, d_model=2048,
    num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=49155,
    source="hf:ibm-granite/granite-3.0-2b-base",
))

_register(ModelConfig(
    name="tinyllama-1.1b", family="dense", num_layers=22, d_model=2048,
    num_heads=32, num_kv_heads=4, head_dim=64, d_ff=5632, vocab_size=32000,
    source="arXiv:2401.02385",
))

_register(ModelConfig(
    name="qwen3-14b", family="dense", num_layers=40, d_model=5120, microbatches=2,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=17408, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, head_pad_to=48,
    source="hf:Qwen/Qwen3-14B",
))

_register(ModelConfig(
    name="qwen1.5-32b", family="dense", num_layers=64, d_model=5120, microbatches=4,
    num_heads=40, num_kv_heads=40, head_dim=128, d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, head_pad_to=48,
    # MHA x 64 layers: the 32k cache is >21 GiB/chip in bf16 — f8 KV (§Perf H3)
    kv_cache_dtype="float8_e4m3fn",
    source="hf:Qwen/Qwen1.5-32B",
))

_register(ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", num_layers=48, d_model=5120, microbatches=2,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=202048,
    num_experts=16, num_experts_per_tok=1, num_shared_experts=1,
    head_pad_to=48, rope_theta=5e5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))

_register(ModelConfig(
    name="dbrx-132b", family="moe", num_layers=40, d_model=6144, microbatches=4,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=10752, vocab_size=100352,
    num_experts=16, num_experts_per_tok=4, rope_theta=5e5,
    source="hf:databricks/dbrx-base",
))

_register(ModelConfig(
    name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
    num_heads=40, num_kv_heads=40, head_dim=64, d_ff=8960, vocab_size=65536,
    rwkv_head_size=64, head_pad_to=48,
    source="arXiv:2404.05892",
))

_register(ModelConfig(
    name="whisper-tiny", family="audio", num_layers=4, num_encoder_layers=4,
    d_model=384, num_heads=6, num_kv_heads=6, head_dim=64, d_ff=1536,
    vocab_size=51865, encoder_seq_len=1500, head_pad_to=16,
    source="arXiv:2212.04356",
))

_register(ModelConfig(
    name="pixtral-12b", family="vlm", num_layers=40, d_model=5120, microbatches=2,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=131072,
    num_image_tokens=1024, rope_theta=1e6,
    source="hf:mistralai/Pixtral-12B-2409",
))

_register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096, microbatches=8,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=65536,
    num_experts=16, num_experts_per_tok=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=3,
    source="arXiv:2403.19887",
))


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family twin for CPU smoke tests."""
    full = ARCHS[name]
    common = dict(
        name=full.name + "-smoke", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, head_pad_to=0,
        remat_policy="none", microbatches=1,
    )
    if full.family == "hybrid":
        common.update(num_layers=8, attn_every=4, attn_offset=1,
                      num_experts=4, num_experts_per_tok=2, moe_every=2, moe_offset=1)
    elif full.family == "moe":
        common.update(num_experts=4,
                      num_experts_per_tok=min(2, full.num_experts_per_tok),
                      num_shared_experts=full.num_shared_experts)
    elif full.family == "ssm":
        common.update(rwkv_head_size=16, num_heads=4, num_kv_heads=4)
    elif full.family == "audio":
        common.update(num_layers=2, num_encoder_layers=2, encoder_seq_len=16,
                      num_kv_heads=4)
    elif full.family == "vlm":
        common.update(num_image_tokens=8)
    return dataclasses.replace(full, **common)


# which shape cells run for which arch (per spec: skip long_500k for pure
# full-attention archs; note the skip in DESIGN.md)
LONG_CTX_ARCHS = ("rwkv6-3b", "jamba-v0.1-52b")


def cells():
    """All runnable (arch, shape) dry-run cells."""
    out = []
    for name in ARCHS:
        for sname in SHAPES:
            if sname == "long_500k" and name not in LONG_CTX_ARCHS:
                continue
            out.append((name, sname))
    return out
