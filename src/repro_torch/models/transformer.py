"""Model assembly of the port, the counterpart of
`repro/models/transformer.py`, for the `dense` family (decoder-only GQA
stacks such as tinyllama-1.1b, granite-3-2b and qwen3-14b), the `moe`
family (llama4-scout-17b-a16e, dbrx-132b), the `ssm` family (rwkv6-3b)
and the `hybrid` family (jamba-v0.1-52b).

Parameters are the reference's tree. Its layer plan (`_layer_plan`) lists
the (mixer, FFN) kind of each position of a scan block: one position for
the dense, moe and ssm families, `attn_every` for the hybrid family
(attention at `attn_offset`, mamba elsewhere; MoE FFNs where
`cfg.is_moe_layer`). Each position's weights are stacked on the blocks
axis under `blocks.pos{i}`. The reference scans over blocks; the port
runs a Python loop over blocks and positions (one kernel launch per
attention or WKV layer). The decode cache is the reference's
`{"blocks": {"pos{i}": ...}}` stacked on blocks, updated in place: k/v of
shape (n_blocks, b, S, nkv, hd) at attention positions, the mamba state
{h (n_blocks, b, di, ds) f32, conv (n_blocks, b, k-1, di)} at mamba
positions, the RWKV state {S (n_blocks, b, H, K, K) f32, last, cm_last
(n_blocks, b, 1, d)} for the ssm family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, mamba, moe, rwkv6
from repro_torch.models.params import ParamSpec, tree_map_specs

Params = Dict[str, Any]

# what ports each family that this slice does not (ROADMAP.md)
PENDING = {
    "audio": "Queue 1 item 10 (the audio family: encoder and "
             "cross-attention)",
    "vlm": "Queue 1 item 10 (the vlm family: image embeddings)",
}
FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.family in PENDING:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; "
            f"ROADMAP.md {PENDING[cfg.family]}")
    if cfg.family not in FAMILIES:
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
    """RMS norm for the dense, moe and hybrid families, layer norm (scale
    and bias) for the ssm family (the audio family's layer norm comes with
    it)."""
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


def _layer_plan(cfg: ModelConfig):
    """[(mixer kind, FFN kind)] of each position of a scan block, and the
    number of blocks."""
    if cfg.family == "hybrid":
        period = cfg.attn_every
        assert cfg.num_layers % period == 0
        plan = [("attn" if pos % cfg.attn_every == cfg.attn_offset
                 else "mamba", "moe" if cfg.is_moe_layer(pos) else "dense")
                for pos in range(period)]
        return plan, cfg.num_layers // period
    if cfg.family == "ssm":
        return [("rwkv", "rwkv_cm")], cfg.num_layers
    ffn = "moe" if (cfg.num_experts and cfg.moe_every == 1) else "dense"
    return [("attn", ffn)], cfg.num_layers


def _layer_params(cfg: ModelConfig, kind: str, ffn: str) -> Params:
    """One layer: its two norms, the mixer (attention, mamba or the RWKV
    time mix) and the FFN (gated MLP, MoE or the RWKV channel mix)."""
    p: Params = {"ln1": norm_params(cfg), "ln2": norm_params(cfg)}
    if kind == "attn":
        p["attn"] = layers.attention_params(cfg)
    elif kind == "mamba":
        p["mixer"] = mamba.mamba_params(cfg)
    else:
        p["tm"] = rwkv6.time_mix_params(cfg)
    if ffn == "dense":
        p["mlp"] = layers.mlp_params(cfg)
    elif ffn == "moe":
        p["moe"] = moe.moe_params(cfg)
    else:
        p["cm"] = rwkv6.channel_mix_params(cfg)
    return p


def _ffn_apply(cfg: ModelConfig, ffn: str, p: Params, h, last=None):
    """(y, aux): the FFN of a layer on its normed input; aux is the
    experts' loss, None without experts."""
    if ffn == "dense":
        return layers.mlp(p["mlp"], h), None
    if ffn == "moe":
        return moe.moe(p["moe"], cfg, h)
    return rwkv6.channel_mix(p["cm"], h, last=last), None


def _layer_apply(cfg: ModelConfig, kind: str, ffn: str, p: Params, x,
                 positions):
    """One pre-norm layer: the mixer, then the FFN, each added to the
    residual stream. Returns (x, aux)."""
    h = apply_norm(cfg, p["ln1"], x)
    if kind == "attn":
        y = layers.causal_attention(p["attn"], cfg, h, positions)
    elif kind == "mamba":
        y = mamba.mamba(p["mixer"], cfg, h)
    else:
        y = rwkv6.time_mix(p["tm"], cfg, h)
    x = x + y
    y, aux = _ffn_apply(cfg, ffn, p, apply_norm(cfg, p["ln2"], x))
    return x + y, aux


def _decode_layer_apply(cfg: ModelConfig, kind: str, ffn: str, p: Params,
                        c, x, index: int):
    """One decode layer; `c` holds views of the layer's cache (k/v, the
    mamba state h and conv, or the RWKV state S, last and cm_last),
    written in place."""
    h = apply_norm(cfg, p["ln1"], x)
    if kind == "attn":
        y, _, _ = layers.decode_attention(p["attn"], cfg, h, c["k"], c["v"],
                                          index)
    elif kind == "mamba":
        y = mamba.mamba_decode(p["mixer"], cfg, h, c)
    else:
        y = rwkv6.time_mix_decode(p["tm"], cfg, h, c)
    x = x + y
    h = apply_norm(cfg, p["ln2"], x)
    y, _ = _ffn_apply(cfg, ffn, p, h, last=c.get("cm_last"))
    if ffn == "rwkv_cm":
        c["cm_last"].copy_(h)
    return x + y


def _layer(tree, l: int):
    """Block `l` of a tree stacked on a leading blocks axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


@dataclasses.dataclass(frozen=True)
class ModelDef:
    cfg: ModelConfig
    param_tree: Any

    def forward(self, params: Params, batch: Dict[str, Any],
                return_hidden: bool = False):
        """(logits (b, s, padded vocab) | final hidden (b, s, d), aux);
        aux, the experts' loss summed over the MoE layers (a block's
        first, as the reference sums them), is 0 without experts."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        plan, n_scan = _layer_plan(cfg)
        for l in range(n_scan):
            block, block_aux = _layer(params["blocks"], l), 0.0
            for i, (kind, ffn) in enumerate(plan):
                x, a = _layer_apply(cfg, kind, ffn, block[f"pos{i}"], x,
                                    positions)
                if a is not None:
                    block_aux = block_aux + a
            aux = aux + block_aux
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
        """ParamSpec tree of the decode cache (zeros): k/v of `cache_len`
        positions in `cfg.cache_dtype` at attention positions, the mamba
        or RWKV state (whose size `cache_len` does not change) at the
        others."""
        cfg = self.cfg
        axes = ("batch", "kv_seq", "act_kv", None)
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        plan, n_scan = _layer_plan(cfg)
        block = {}
        for i, (kind, _) in enumerate(plan):
            if kind == "attn":
                block[f"pos{i}"] = {
                    "k": ParamSpec(shape, cfg.cache_dtype, axes, "zeros"),
                    "v": ParamSpec(shape, cfg.cache_dtype, axes, "zeros")}
            elif kind == "mamba":
                block[f"pos{i}"] = mamba.mamba_state_specs(cfg, batch)
            else:
                block[f"pos{i}"] = rwkv6.rwkv_state_specs(cfg, batch)
        return {"blocks": _stack(block, n_scan)}

    def decode(self, params: Params, cache, token, index: int):
        """One decode step. token (b, 1) int; `index` the host int position
        (the mamba and RWKV states do not read it). Writes each layer's new
        k/v, or its state, into `cache` in place and returns
        (logits (b, 1, padded vocab), cache)."""
        cfg = self.cfg
        x = self._embed(params, token)
        plan, n_scan = _layer_plan(cfg)
        for l in range(n_scan):
            block, caches = (_layer(params["blocks"], l),
                             _layer(cache["blocks"], l))
            for i, (kind, ffn) in enumerate(plan):
                x = _decode_layer_apply(cfg, kind, ffn, block[f"pos{i}"],
                                        caches[f"pos{i}"], x, index)
        x = apply_norm(cfg, params["final_norm"], x)
        return layers.unembed(params["tok"], x), cache


def build(cfg: ModelConfig) -> ModelDef:
    """The ModelDef of a dense, moe, ssm or hybrid config; raises
    NotImplementedError for the families and options not ported yet."""
    check_supported(cfg)
    plan, n_scan = _layer_plan(cfg)
    block = {f"pos{i}": _layer_params(cfg, kind, ffn)
             for i, (kind, ffn) in enumerate(plan)}
    tree = {
        "tok": layers.embed_params(cfg),
        "blocks": _stack(block, n_scan),
        "final_norm": norm_params(cfg),
    }
    if cfg.family == "ssm":
        tree["ln0"] = norm_params(cfg)
    return ModelDef(cfg, tree)
