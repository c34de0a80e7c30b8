"""Model assembly of the port, the counterpart of
`repro/models/transformer.py`, for every family the reference builds: the
`dense` family (decoder-only GQA stacks such as tinyllama-1.1b,
granite-3-2b, qwen3-14b and qwen1.5-32b with its f8 KV cache), the `vlm`
family (pixtral-12b: image embeddings put in front of the tokens), the
`moe` family (llama4-scout-17b-a16e, dbrx-132b), the `ssm` family
(rwkv6-3b), the `hybrid` family (jamba-v0.1-52b) and the `audio` family
(whisper-tiny: a bidirectional encoder over precomputed frames and a
decoder with cross-attention).

Parameters are the reference's tree. Its layer plan (`_layer_plan`) lists
the (mixer, FFN) kind of each position of a scan block: one position for
the dense, vlm, moe and ssm families, `attn_every` for the hybrid family
(attention at `attn_offset`, mamba elsewhere; MoE FFNs where
`cfg.is_moe_layer`). Each position's weights are stacked on the blocks
axis under `blocks.pos{i}`; the audio family has `enc_blocks` and
`dec_blocks` instead. The reference scans over blocks; the port runs a
Python loop over blocks and positions (one kernel launch per attention or
WKV layer). The decode cache is the reference's `{"blocks": {"pos{i}":
...}}` stacked on blocks, updated in place: k/v of shape (n_blocks, b, S,
nkv, hd) in `cfg.cache_dtype` at attention positions, the mamba state
{h (n_blocks, b, di, ds) f32, conv (n_blocks, b, k-1, di)} at mamba
positions, the RWKV state {S (n_blocks, b, H, K, K) f32, last, cm_last
(n_blocks, b, 1, d)} for the ssm family; for the audio family
`{"dec": {"self": {k, v}, "cross": {k, v}}}` stacked on decoder layers,
the cross k/v (n_layers, b, encoder_seq_len, nkv, hd) in `cfg.dtype`.
`attn_logit_softcap` is read nowhere, as in the reference.

Under autograd each layer of the stack (each position of a block; each
decoder layer of the audio family) is rematerialized as the reference's
`_remat` does it, by `cfg.remat_policy`: "full" keeps only the layer's
inputs and recomputes the rest in the backward, "dots" keeps the outputs
of the matrix products and recomputes the rest, "none" keeps everything.
Without autograd (serving under `torch.no_grad`) layers are called as
they are.

Under `with mesh:` (a train state held in blocks, `models/sharding.py`)
the layers run tensor-parallel over "model" and gather the FSDP blocks
over "data" at use. The audio family's encoder attention,
cross-attention and `encode_kv` split over the q heads as the decoder's
causal attention does. The residual stream is the reference's `_SP`:
split over "model" along its sequence where `params.seq_parallel`
splits it (the stream of the blocks, the audio family's encoder and
decoder streams each by its own length), whole elsewhere. The forward
runs each stream under `with mesh_lib.stream(split):`; the embedding
reduce-scatters onto the rank's positions (the vlm family's image and
text embeddings are put together whole, then cut), the norms run on the
rank's positions with their scale and bias summed over "model" in the
backward, each layer gathers its input and reduce-scatters its output,
and the final hidden state (the encoder output) is gathered once after
the final norm (`enc_norm`), as the reference's `_FULL`. Under remat
"full" a layer then keeps only its rank's positions of the stream.
Decode under
`with mesh:` runs on the rank's blocks of params and cache: the cache in
the reference's layout (`cache_specs(padded=True)`, `layers.cache_axes`),
the RWKV state on the rank's heads, the mamba state on its d_inner
channels, the experts over "model" as in training, the audio family's
cross cache over the self cache's head axis (`fill_cross_cache` fills a
rank's block); the logits gathered whole over "model" for the argmax.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers, mamba, moe, rwkv6
from repro_torch.models.params import (ParamSpec, seq_parallel, spec_axes,
                                       torch_dtype, tree_map_specs)

Params = Dict[str, Any]


def norm_params(cfg: ModelConfig) -> Params:
    """RMS norm for the dense, vlm, moe and hybrid families, layer norm
    (scale and bias) for the audio and ssm families."""
    p = {"scale": ParamSpec((cfg.d_model,), cfg.param_dtype, (None,),
                            "ones")}
    if cfg.family in ("audio", "ssm"):
        p["bias"] = ParamSpec((cfg.d_model,), cfg.param_dtype, (None,),
                              "zeros")
    return p


def apply_norm(cfg: ModelConfig, p: Params, x):
    """The layer or RMS norm of `x`; on a stream split over "model" its
    scale and bias take the rank's positions' gradient, summed over
    "model" in the backward."""
    mesh = mesh_lib.state_mesh()
    if mesh_lib.stream_split():
        p = {k: mesh_lib.copy_to_group(v, mesh) for k, v in p.items()}
    if "bias" in p:
        return layers.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return layers.rms_norm(x, p["scale"], cfg.norm_eps)


# the products whose outputs the "dots" policy keeps (the reference's
# `dots_with_no_batch_dims_saveable`); everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """`fn` rematerialized under `cfg.remat_policy` ("none", "full" or
    "dots") when autograd records; `fn` itself otherwise. The recompute
    runs in the stream of the forward call (`mesh_lib.within_stream`)."""
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat_policy != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        return checkpoint(mesh_lib.within_stream(fn), *args,
                          use_reentrant=False, **kw)
    return run


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
        p["mlp"] = layers.mlp_params(cfg, gated=cfg.family != "audio")
    elif ffn == "moe":
        p["moe"] = moe.moe_params(cfg)
    else:
        p["cm"] = rwkv6.channel_mix_params(cfg)
    return p


def _ffn_apply(cfg: ModelConfig, ffn: str, p: Params, h, last=None):
    """(y, aux): the FFN of a layer on its normed input; aux is the
    experts' loss, None without experts."""
    if ffn == "dense":
        return layers.mlp(p["mlp"], h, cfg=cfg), None
    if ffn == "moe":
        return moe.moe(p["moe"], cfg, h)
    return rwkv6.channel_mix(p["cm"], h, last=last, cfg=cfg), None


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


def _enc_layer_apply(cfg: ModelConfig, p: Params, x):
    """One encoder layer of the audio family: bidirectional attention
    without RoPE, the ungated gelu MLP."""
    x = x + layers.bidir_attention(p["attn"], cfg,
                                   apply_norm(cfg, p["ln1"], x))
    return x + layers.mlp(p["mlp"], apply_norm(cfg, p["ln2"], x),
                          act=layers.gelu, cfg=cfg)


def _dec_layer_apply(cfg: ModelConfig, p: Params, x, enc, positions):
    """One decoder layer of the audio family over a whole sequence: causal
    self-attention, cross-attention to the encoder output `enc`, the
    ungated gelu MLP."""
    x = x + layers.causal_attention(p["attn"], cfg,
                                    apply_norm(cfg, p["ln1"], x), positions)
    x = x + layers.cross_attention(p["xattn"], cfg,
                                   apply_norm(cfg, p["ln_x"], x),
                                   layers.encode_kv(p["xattn"], cfg, enc))
    return x + layers.mlp(p["mlp"], apply_norm(cfg, p["ln2"], x),
                          act=layers.gelu, cfg=cfg)


def _dec_decode_apply(cfg: ModelConfig, p: Params, c, x, index: int,
                      kv_spec=None):
    """One decoder layer of the audio family at one position against its
    cache `c` ({"self", "cross"}): the self k/v written at `index`, the
    cross k/v read whole (the rank's block on a mesh, laid out as
    `kv_spec`'s heads)."""
    y, _, _ = layers.decode_attention(
        p["attn"], cfg, apply_norm(cfg, p["ln1"], x), c["self"]["k"],
        c["self"]["v"], index, kv_spec)
    x = x + y
    head_axes = () if kv_spec is None else spec_axes(kv_spec[2])
    x = x + layers.cross_decode_attention(
        p["xattn"], cfg, apply_norm(cfg, p["ln_x"], x), c["cross"]["k"],
        c["cross"]["v"], head_axes)
    return x + layers.mlp(p["mlp"], apply_norm(cfg, p["ln2"], x),
                          act=layers.gelu, cfg=cfg)


def _decode_layer_apply(cfg: ModelConfig, kind: str, ffn: str, p: Params,
                        c, x, index: int, kv_spec=None):
    """One decode layer; `c` holds views of the layer's cache (k/v, the
    mamba state h and conv, or the RWKV state S, last and cm_last),
    written in place; on a mesh `kv_spec` lays out the k/v blocks."""
    h = apply_norm(cfg, p["ln1"], x)
    if kind == "attn":
        y, _, _ = layers.decode_attention(p["attn"], cfg, h, c["k"], c["v"],
                                          index, kv_spec)
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


def _unstack(tree):
    """Every block of a tree stacked on a leading blocks axis, as a list
    of trees of views: one `unbind` a leaf, whose backward stacks the
    blocks' gradients once (indexing block by block would materialize a
    full-size gradient per block and sum them)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[l] for k, v in parts.items()} for l in range(n)]
    return tree.unbind(0)


@dataclasses.dataclass(frozen=True)
class ModelDef:
    cfg: ModelConfig
    param_tree: Any

    def forward(self, params: Params, batch: Dict[str, Any],
                return_hidden: bool = False):
        """(logits (b, s, padded vocab) | final hidden (b, s, d), aux);
        aux, the experts' loss summed over the MoE layers (a block's
        first, as the reference sums them), is 0 without experts. The
        batch holds `tokens` (b, s_text), and `frames` (b, encoder_seq_len,
        d) for the audio family or, optionally, `img_embeds` (b,
        num_image_tokens, d) for the vlm family, which then makes s
        num_image_tokens + s_text. Under `with mesh:` the stream of
        (b, s) positions is split over "model" where `seq_parallel` says;
        the hidden state returned is whole on the rank (`head_input`)."""
        cfg = self.cfg
        b, s = batch["tokens"].shape
        if cfg.family == "vlm" and "img_embeds" in batch:
            s += batch["img_embeds"].shape[1]
        with self._stream(b, s):
            if cfg.family == "audio":
                x = self._forward_encdec(params, batch)
                aux = torch.zeros((), dtype=torch.float32, device=x.device)
            else:
                x, aux = self._forward_blocks(params, batch, s)
            x = apply_norm(cfg, params["final_norm"], x)
            x = layers.head_input(x, cfg)
        if return_hidden:
            return x, aux
        logits = layers.unembed(params["tok"], x, cfg)
        mesh = mesh_lib.state_mesh()
        if mesh is not None and logits.shape[-1] != cfg.padded_vocab():
            logits = mesh_lib.gather_from_group(logits, mesh, "model", -1,
                                                same=True)
        return logits, aux

    def _stream(self, b: int, s: int):
        """`with` the residual stream of b sequences of s positions, split
        over "model" where `seq_parallel` splits it on the state mesh."""
        return mesh_lib.stream(seq_parallel((b, s, self.cfg.d_model),
                                            mesh_lib.state_mesh()))

    def _forward_blocks(self, params: Params, batch, s: int):
        """(residual stream after the last block, aux) of the layer
        plan's families, over `s` positions (the rank's on a split
        stream)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = torch.arange(s, device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        subs = [_remat(cfg, functools.partial(_layer_apply, cfg, kind, ffn))
                for kind, ffn in _layer_plan(cfg)[0]]
        for block in _unstack(params["blocks"]):
            block_aux = 0.0
            for i, sub in enumerate(subs):
                x, a = sub(block[f"pos{i}"], x, positions)
                if a is not None:
                    block_aux = block_aux + a
            aux = aux + block_aux
        return x, aux

    def _embed(self, params: Params, tokens):
        """Token embeddings; the ssm family's `ln0` follows them."""
        x = layers.embed(params["tok"], tokens, self.cfg)
        if self.cfg.family == "ssm":
            x = apply_norm(self.cfg, params["ln0"], x)
        return x

    def _embed_inputs(self, params: Params, batch):
        """The token embeddings, with the vlm family's image embeddings
        (cast to their dtype) in front of them where the batch has them:
        then put together whole and cut to the stream's layout."""
        if self.cfg.family == "vlm" and "img_embeds" in batch:
            with mesh_lib.stream(False):
                x = layers.embed(params["tok"], batch["tokens"], self.cfg)
            x = torch.cat([batch["img_embeds"].to(x.dtype), x], dim=1)
            return mesh_lib.to_stream(x, mesh_lib.state_mesh(), same=True)
        return self._embed(params, batch["tokens"])

    def encode(self, params: Params, frames):
        """The audio family's encoder output (b, encoder_seq_len, d): the
        first half of `forward`, whose `layers.encode_kv` with a decoder
        layer's `xattn` gives that layer's cross k/v. Under `with mesh:`
        its stream is split over "model" where `seq_parallel` says, and
        the output is whole on the rank (`layers.encoder_output`)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        enc = frames.to(dt)
        enc = enc + _sinusoidal(enc.shape[1], cfg.d_model, dt,
                                enc.device)[None]
        with self._stream(enc.shape[0], enc.shape[1]):
            enc = mesh_lib.to_stream(enc, mesh_lib.state_mesh(), same=True)
            for p in _unstack(params["enc_blocks"]):
                enc = _enc_layer_apply(cfg, p, enc)
            enc = apply_norm(cfg, params["enc_norm"], enc)
            return layers.encoder_output(enc, cfg)

    def _forward_encdec(self, params: Params, batch):
        """The audio family's residual stream after the last decoder
        layer: the encoder over `frames` (the stub front end's embeddings,
        cast to `cfg.dtype`, plus sinusoidal positions; bidirectional
        attention without RoPE, the ungated gelu MLP), then the decoder
        over the tokens (sinusoidal positions, causal self-attention with
        RoPE on top of them as the reference applies it, cross-attention
        to the encoder output)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        enc = self.encode(params, batch["frames"])
        s = batch["tokens"].shape[1]
        x = layers.embed(params["tok"], batch["tokens"], cfg)
        pe = _sinusoidal(s, cfg.d_model, dt, x.device)[None]
        x = x + mesh_lib.to_stream(pe, mesh_lib.state_mesh(), same=True)
        positions = torch.arange(s, device=x.device)[None, :]
        dec = _remat(cfg, functools.partial(_dec_layer_apply, cfg))
        for p in _unstack(params["dec_blocks"]):
            x = dec(p, x, enc, positions)
        return x

    def fill_cross_cache(self, params: Params, cache, frames, kv_spec=None):
        """Every decoder layer's cross k/v in `cache`, in place, from
        `encode` of `frames` (the cache's rows) and each layer's
        `encode_kv`; serving leaves them zero. Under `with mesh:` (params
        and cache the rank's blocks, `frames` its rows) the rank's block:
        the heads of the self cache's head axis in `kv_spec`
        (`layers.cache_spec`). Returns `cache`."""
        cfg = self.cfg
        enc = self.encode(params, frames)
        head_axes = () if kv_spec is None else spec_axes(kv_spec[2])
        cross = cache["dec"]["cross"]
        for l in range(cfg.num_layers):
            k, v = layers.cross_cache_block(
                _layer(params["dec_blocks"]["xattn"], l), cfg, enc,
                cross["k"].shape[3], head_axes)
            cross["k"][l].copy_(k)
            cross["v"][l].copy_(v)
        return cache

    def cache_specs(self, batch: int, cache_len: int, long_ctx: bool = False,
                    padded: bool = False):
        """ParamSpec tree of the decode cache (zeros): k/v of `cache_len`
        positions in `cfg.cache_dtype` at attention positions, the mamba
        or RWKV state (whose size `cache_len` does not change) at the
        others; the k/v's logical axes by `layers.cache_axes(cfg,
        long_ctx)`. An MHA-padded config's k/v hold the real heads, or
        with `padded` (the layout on a mesh, the reference's everywhere)
        `padded_heads`, the extra ones zero."""
        cfg = self.cfg
        axes = layers.cache_axes(cfg, long_ctx)
        nkv = layers.cache_kv_heads(cfg, padded)

        def kv_spec(length, dtype, kv_axes):
            shape = (batch, length, nkv, cfg.head_dim)
            return {"k": ParamSpec(shape, dtype, kv_axes, "zeros"),
                    "v": ParamSpec(shape, dtype, kv_axes, "zeros")}

        if cfg.family == "audio":
            layer = {"self": kv_spec(cache_len, cfg.cache_dtype, axes),
                     "cross": kv_spec(cfg.encoder_seq_len, cfg.dtype,
                                      ("batch", None, axes[2], None))}
            return {"dec": _stack(layer, cfg.num_layers)}
        plan, n_scan = _layer_plan(cfg)
        block = {}
        for i, (kind, _) in enumerate(plan):
            if kind == "attn":
                block[f"pos{i}"] = kv_spec(cache_len, cfg.cache_dtype, axes)
            elif kind == "mamba":
                block[f"pos{i}"] = mamba.mamba_state_specs(cfg, batch)
            else:
                block[f"pos{i}"] = rwkv6.rwkv_state_specs(cfg, batch)
        return {"blocks": _stack(block, n_scan)}

    def decode(self, params: Params, cache, token, index: int,
               kv_spec=None):
        """One decode step. token (b, 1) int; `index` the host int position
        (the mamba and RWKV states do not read it). Writes each layer's new
        k/v, or its state, into `cache` in place and returns
        (logits (b, 1, padded vocab), cache). Under `with mesh:` params,
        cache and token are the rank's blocks, the k/v laid out by
        `kv_spec` (`layers.cache_spec`)."""
        cfg = self.cfg
        mesh = mesh_lib.state_mesh()
        x = self._embed(params, token)
        if cfg.family == "audio":
            x = x + _sinusoidal_at(index, cfg.d_model,
                                   torch_dtype(cfg.dtype), x.device)
            for l in range(cfg.num_layers):
                x = _dec_decode_apply(cfg, _layer(params["dec_blocks"], l),
                                      _layer(cache["dec"], l), x, index,
                                      kv_spec)
        else:
            plan, n_scan = _layer_plan(cfg)
            for l in range(n_scan):
                block, caches = (_layer(params["blocks"], l),
                                 _layer(cache["blocks"], l))
                for i, (kind, ffn) in enumerate(plan):
                    x = _decode_layer_apply(cfg, kind, ffn,
                                            block[f"pos{i}"],
                                            caches[f"pos{i}"], x, index,
                                            kv_spec)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = layers.unembed(params["tok"], x, cfg)
        if mesh is not None and logits.shape[-1] != cfg.padded_vocab():
            logits = mesh_lib.all_gather(logits, mesh, "model", 2)
        return logits, cache


def _sinusoidal_angles(positions, d: int):
    """(len, d/2) f32 angles pos / 10000^(2i/d), as the reference forms
    them. The power is taken in f64 and rounded to f32: XLA's f32 pow is
    that correctly rounded value at these exponents (at d 384 and 64 for
    every i), torch's f32 pow an ulp off at some, which moves sin and cos
    at position 4,095 by up to 8e-6."""
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    div = (10000.0 ** (dim / d).double()).float()
    return positions.float()[:, None] / div


def _interleave(ang, dtype):
    """sin at the even columns, cos at the odd, f32, then cast."""
    pe = torch.zeros(ang.shape[0], 2 * ang.shape[1], dtype=torch.float32,
                     device=ang.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(dtype)


def _sinusoidal(length: int, d: int, dtype, device=None):
    """(length, d) sinusoidal positions, computed in f32, cast to
    `dtype`."""
    pos = torch.arange(length, dtype=torch.float32, device=device)
    return _interleave(_sinusoidal_angles(pos, d), dtype)


def _sinusoidal_at(index: int, d: int, dtype, device=None):
    """(d,) the sinusoidal position of one host int `index`."""
    pos = torch.full((1,), index, dtype=torch.float32, device=device)
    return _interleave(_sinusoidal_angles(pos, d), dtype)[0]


def _audio_layer_params(cfg: ModelConfig):
    """(encoder layer, decoder layer) of the audio family: layer norms,
    attention (the decoder's causal, then cross-attention after `ln_x`)
    and the ungated MLP."""
    enc_layer = {"ln1": norm_params(cfg), "ln2": norm_params(cfg),
                 "attn": layers.attention_params(cfg),
                 "mlp": layers.mlp_params(cfg, gated=False)}
    dec_layer = {"ln1": norm_params(cfg), "ln_x": norm_params(cfg),
                 "ln2": norm_params(cfg),
                 "attn": layers.attention_params(cfg),
                 "xattn": layers.attention_params(cfg, cross=True),
                 "mlp": layers.mlp_params(cfg, gated=False)}
    return enc_layer, dec_layer


def build(cfg: ModelConfig) -> ModelDef:
    """The ModelDef of any registered config: the reference's parameter
    tree (its layer plan, or the audio family's encoder and decoder)."""
    if cfg.family == "audio":
        enc_layer, dec_layer = _audio_layer_params(cfg)
        return ModelDef(cfg, {
            "tok": layers.embed_params(cfg),
            "enc_blocks": _stack(enc_layer, cfg.num_encoder_layers),
            "enc_norm": norm_params(cfg),
            "dec_blocks": _stack(dec_layer, cfg.num_layers),
            "final_norm": norm_params(cfg),
        })
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
