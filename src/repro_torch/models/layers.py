"""Shared transformer layers of the port: norms, RoPE, GQA attention, MLP,
embedding; the counterpart of `repro/models/layers.py`.

Parameters are the reference's trees (nested dicts of tensors, the same
names, shapes and layouts), so a reference tree carries across as it is
(`core/convert.py`). Both attention forms go through the port's
hand-written kernels: `causal_attention` through `kernels/flash_attention`,
`decode_attention` through `kernels/decode_attention` (a CUDA tensor
launches the kernel, a CPU tensor runs its plain version). The q/k/v/o
projections, the MLP and the unembedding are plain products, as in the
reference, where XLA and not a Pallas kernel computes them.

The reference pads q heads to `cfg.padded_heads` for TPU sharding; padded
heads meet zero `wo` rows, so the padding is exact and the port runs
attention on the `num_heads` real heads. Then the kernels' mapping
kv head = q head // group equals `_kv_repeat_idx` for every dense config.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.params import ParamSpec

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5):
    """f32 input: in f32 throughout. Any other dtype: the sum of squares
    accumulates in f32 (the products of two bf16 are exact in f32), and the
    (…, 1) rescale factor and the scale are applied in the input dtype,
    rounding where the reference rounds."""
    if x.dtype == torch.float32:
        var = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * scale.float()
    d = x.shape[-1]
    xf = x.float()
    ss = (xf * xf).sum(-1)
    rs = torch.rsqrt(ss / d + eps)[..., None]
    return x * rs.to(x.dtype) * scale.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    d = x.shape[-1]
    xf = x.float()
    mu = (xf.sum(-1) / d)[..., None]
    ss = ((xf * xf).sum(-1) / d)[..., None]
    var = torch.clamp(ss - mu.square(), min=0.0)
    rs = torch.rsqrt(var + eps)
    y = (x - mu.to(x.dtype)) * rs.to(x.dtype)
    return y * scale.to(x.dtype) + bias.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim // 2, dtype=torch.float32,
                        device=device) / (head_dim // 2)
    return theta ** -exps  # (hd/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq). Angles and rotation in f32, out in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs       # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_params(cfg: ModelConfig) -> Params:
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_axes = (("embed", "kv_heads", "head_dim") if cfg.mha_padded
               else ("embed", "kv_heads", "kv_head_dim"))
    p: Params = {
        "wq": ParamSpec((d, nq, hd), cfg.param_dtype,
                        ("embed", "heads", "head_dim"), "fan_in"),
        "wk": ParamSpec((d, nkv, hd), cfg.param_dtype, kv_axes, "fan_in"),
        "wv": ParamSpec((d, nkv, hd), cfg.param_dtype, kv_axes, "fan_in"),
        "wo": ParamSpec((nq, hd, d), cfg.param_dtype,
                        ("heads", "head_dim", "embed"), "fan_in"),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((nq, hd), cfg.param_dtype, ("heads", "head_dim"),
                            "zeros")
        p["bk"] = ParamSpec((nkv, hd), cfg.param_dtype,
                            ("kv_heads", "head_dim"), "zeros")
        p["bv"] = ParamSpec((nkv, hd), cfg.param_dtype,
                            ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), cfg.param_dtype, (None,), "ones")
        p["k_norm"] = ParamSpec((hd,), cfg.param_dtype, (None,), "ones")
    return p


def _kv_repeat_idx(cfg: ModelConfig) -> torch.Tensor:
    """Index of the kv head used by each real q head (the reference's
    mapping restricted to the `num_heads` real heads)."""
    qpk = cfg.num_heads // cfg.num_kv_heads
    return torch.tensor([min(j // qpk, cfg.num_kv_heads - 1)
                         for j in range(cfg.num_heads)], dtype=torch.long)


def project_qkv(p: Params, cfg: ModelConfig, x, positions):
    """q (b, s, num_heads, hd), k and v (b, s, num_kv_heads, hd), RoPE
    applied to q and k."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def causal_attention(p: Params, cfg: ModelConfig, x, positions):
    """Full causal self-attention (train / prefill) through the
    `flash_attention` kernel, at any sequence length (the reference splits
    long sequences into query chunks; the kernel skips the blocks above the
    diagonal itself)."""
    q, k, v = project_qkv(p, cfg, x, positions)
    out = flash_ops.flash_attention(q, k, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def decode_attention(p: Params, cfg: ModelConfig, x, cache_k, cache_v,
                     cache_index: int):
    """Single-token decode at position `cache_index` (a host int). Writes
    the new k/v into `cache_{k,v}` (b, S, nkv, hd) at `cache_index` IN
    PLACE (the reference donates the cache to the same effect) and returns
    (y, cache_k, cache_v), the caches being the same storage; attention
    through the `decode_attention` kernel over rows 0..cache_index."""
    b = x.shape[0]
    positions = torch.full((b, 1), cache_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = project_qkv(p, cfg, x, positions)
    cache_k[:, cache_index] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cache_index] = v[:, 0].to(cache_v.dtype)
    out = decode_ops.decode_attention(q, cache_k, cache_v, cache_index)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(cfg: ModelConfig) -> Params:
    """The gated MLP of the dense family (the reference's `gated=True`)."""
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_in": ParamSpec((d, ff), cfg.param_dtype, ("embed", "mlp"),
                          "fan_in"),
        "w_gate": ParamSpec((d, ff), cfg.param_dtype, ("embed", "mlp"),
                            "fan_in"),
        "w_out": ParamSpec((ff, d), cfg.param_dtype, ("mlp", "embed"),
                           "fan_in"),
    }


def mlp(p: Params, x):
    """silu(x·w_gate) · (x·w_in), then ·w_out."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_params(cfg: ModelConfig) -> Params:
    vp, d = cfg.padded_vocab(), cfg.d_model
    return {
        "embedding": ParamSpec((vp, d), cfg.param_dtype, ("vocab", "embed"),
                               "normal"),
        "lm_head": ParamSpec((vp, d), cfg.param_dtype, ("vocab", "embed"),
                             "fan_in"),
    }


def embed(p: Params, tokens):
    return p["embedding"][tokens.long()]


def unembed(p: Params, x):
    return x @ p["lm_head"].T
