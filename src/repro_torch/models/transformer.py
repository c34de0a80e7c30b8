"""Model assembly of the port, the counterpart of
`repro/models/transformer.py`, for the `dense` family (decoder-only GQA
stacks such as tinyllama-1.1b, granite-3-2b and qwen3-14b) and the `ssm`
family (rwkv6-3b).

Parameters are the reference's tree: per-layer weights stacked along a
leading layers axis under `blocks.pos0`. The reference scans over that
axis; the port runs a Python loop over it (one kernel launch per layer
and attention or WKV form). The decode cache is the reference's
`{"blocks": {"pos0": ...}}` stacked on layers, updated in place: k/v of
shape (L, b, S, nkv, hd) for the dense family, the RWKV state
{S (L, b, H, K, K) f32, last, cm_last (L, b, 1, d)} for the ssm family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, rwkv6
from repro_torch.models.params import ParamSpec, tree_map_specs

Params = Dict[str, Any]

# what ports each family that this slice does not (ROADMAP.md)
PENDING = {
    "moe": "Queue 1 item 10 (the moe family: models/moe.py)",
    "hybrid": "Queue 1 item 10 (the hybrid family: models/mamba.py)",
    "audio": "Queue 1 item 10 (the audio family: encoder and "
             "cross-attention)",
    "vlm": "Queue 1 item 10 (the vlm family: image embeddings)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.family in PENDING:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; "
            f"ROADMAP.md {PENDING[cfg.family]}")
    if cfg.family not in ("dense", "ssm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.cache_dtype == "float8_e4m3fn":
        raise NotImplementedError(
            f"{cfg.name}: the f8 KV cache is not ported yet; ROADMAP.md "
            f"Queue 1 item 10")
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            f"{cfg.name}: attn_logit_softcap is not ported yet; ROADMAP.md "
            f"Queue 1 item 10")


def norm_params(cfg: ModelConfig) -> Params:
    """RMS norm for the dense family, layer norm (scale and bias) for the
    ssm family (the audio family's layer norm comes with it)."""
    p = {"scale": ParamSpec((cfg.d_model,), cfg.param_dtype, (None,),
                            "ones")}
    if cfg.family == "ssm":
        p["bias"] = ParamSpec((cfg.d_model,), cfg.param_dtype, (None,),
                              "zeros")
    return p


def apply_norm(cfg: ModelConfig, p: Params, x):
    if "bias" in p:
        return layers.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return layers.rms_norm(x, p["scale"], cfg.norm_eps)


def _stack(layer_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked leading dim to every ParamSpec in a layer tree."""
    return tree_map_specs(
        lambda s: ParamSpec((n,) + s.shape, s.dtype, (axis_name,) + s.axes,
                            s.init, s.scale),
        layer_tree)


def _layer_params(cfg: ModelConfig) -> Params:
    """The one layer kind each ported family stacks: attention and the
    gated MLP (dense), or the RWKV time and channel mix (ssm)."""
    p: Params = {"ln1": norm_params(cfg), "ln2": norm_params(cfg)}
    if cfg.family == "ssm":
        p["tm"] = rwkv6.time_mix_params(cfg)
        p["cm"] = rwkv6.channel_mix_params(cfg)
    else:
        p["attn"] = layers.attention_params(cfg)
        p["mlp"] = layers.mlp_params(cfg)
    return p


def _layer_apply(cfg: ModelConfig, p: Params, x, positions):
    """One pre-norm block: the mixer (attention or RWKV time mix), then
    the FFN (gated MLP or RWKV channel mix), each added to the residual
    stream. (The reference also returns the experts' aux loss, which is 0
    without experts.)"""
    h = apply_norm(cfg, p["ln1"], x)
    if cfg.family == "ssm":
        x = x + rwkv6.time_mix(p["tm"], cfg, h)
        h = apply_norm(cfg, p["ln2"], x)
        return x + rwkv6.channel_mix(p["cm"], h)
    x = x + layers.causal_attention(p["attn"], cfg, h, positions)
    h = apply_norm(cfg, p["ln2"], x)
    return x + layers.mlp(p["mlp"], h)


def _decode_layer_apply(cfg: ModelConfig, p: Params, c, x, index: int):
    """One decode block; `c` holds views of layer l's cache (k/v, or the
    RWKV state S, last and cm_last), written in place."""
    h = apply_norm(cfg, p["ln1"], x)
    if cfg.family == "ssm":
        x = x + rwkv6.time_mix_decode(p["tm"], cfg, h, c)
        h = apply_norm(cfg, p["ln2"], x)
        x = x + rwkv6.channel_mix(p["cm"], h, last=c["cm_last"])
        c["cm_last"].copy_(h)
        return x
    y, _, _ = layers.decode_attention(p["attn"], cfg, h, c["k"], c["v"],
                                      index)
    x = x + y
    h = apply_norm(cfg, p["ln2"], x)
    return x + layers.mlp(p["mlp"], h)


def _layer(tree, l: int):
    """Layer `l` of a tree stacked on a leading layers axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """Each ported family stacks one layer kind under `blocks.pos0`, the
    reference's key for the first (here only) position of its layer
    plan."""
    cfg: ModelConfig
    param_tree: Any

    def forward(self, params: Params, batch: Dict[str, Any],
                return_hidden: bool = False):
        """(logits (b, s, padded vocab) | final hidden (b, s, d), aux);
        aux, the experts' loss, is 0 for the dense and ssm families."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        blocks = params["blocks"]["pos0"]
        for l in range(cfg.num_layers):
            x = _layer_apply(cfg, _layer(blocks, l), x, positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = apply_norm(cfg, params["final_norm"], x)
        if return_hidden:
            return x, aux
        return layers.unembed(params["tok"], x), aux

    def _embed(self, params: Params, tokens):
        """Token embeddings; the ssm family's `ln0` follows them."""
        x = layers.embed(params["tok"], tokens)
        if self.cfg.family == "ssm":
            x = apply_norm(self.cfg, params["ln0"], x)
        return x

    def cache_specs(self, batch: int, cache_len: int):
        """ParamSpec tree of the decode cache (zeros): k/v of
        `cache_len` positions in `cfg.cache_dtype`, or the RWKV state,
        whose size `cache_len` does not change."""
        cfg = self.cfg
        if cfg.family == "ssm":
            block = {"pos0": rwkv6.rwkv_state_specs(cfg, batch)}
            return {"blocks": _stack(block, cfg.num_layers)}
        axes = ("batch", "kv_seq", "act_kv", None)
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        block = {"pos0": {
            "k": ParamSpec(shape, cfg.cache_dtype, axes, "zeros"),
            "v": ParamSpec(shape, cfg.cache_dtype, axes, "zeros")}}
        return {"blocks": _stack(block, cfg.num_layers)}

    def decode(self, params: Params, cache, token, index: int):
        """One decode step. token (b, 1) int; `index` the host int position
        (the ssm family's state does not read it). Writes each layer's new
        k/v, or its RWKV state, into `cache` in place and returns
        (logits (b, 1, padded vocab), cache)."""
        cfg = self.cfg
        x = self._embed(params, token)
        blocks, caches = params["blocks"]["pos0"], cache["blocks"]["pos0"]
        for l in range(cfg.num_layers):
            x = _decode_layer_apply(cfg, _layer(blocks, l),
                                    _layer(caches, l), x, index)
        x = apply_norm(cfg, params["final_norm"], x)
        return layers.unembed(params["tok"], x), cache


def build(cfg: ModelConfig) -> ModelDef:
    """The ModelDef of a dense or ssm config; raises NotImplementedError
    for the families and options not ported yet."""
    check_supported(cfg)
    tree = {
        "tok": layers.embed_params(cfg),
        "blocks": _stack({"pos0": _layer_params(cfg)}, cfg.num_layers),
        "final_norm": norm_params(cfg),
    }
    if cfg.family == "ssm":
        tree["ln0"] = norm_params(cfg)
    return ModelDef(cfg, tree)
