"""The dry run's count split by unit, the counterpart of
`repro/launch/analysis.py` with its signature and return keys.

The reference's XLA counts a while-loop body once whatever its trip
count, so it lowers each scan block alone and corrects the whole-step
count by the trip counts. The port runs layers, microbatches and loss
chunks as Python loops: the whole-step count of `launch/dryrun.py` is
already complete, and `corrected` equals it. What this module still
gives is the split by unit, each traced alone on the same abstract mesh
at the rank's rows of one microbatch: each position of the layer plan
(`transformer._layer_plan`), or for the audio family the reference's two
units, the encoder layer (at `encoder_seq_len` positions, without remat,
as `ModelDef.encode` runs it) and the decoder layer (beside the encoder
output, whole, which it differentiates too), each layer's input at the
rank's block of the stream's positions where the reference's `seq_sp`
rule splits the stream over "model" (its `_act_sds`), and run in that
stream (`launch.mesh.stream`); forward and backward under the
config's remat for a train cell, forward for prefill, one decode layer
against its cache block for decode; and for a train cell the loss (the
chunked cross-entropy of `steps.mean_nll`, forward and backward). Then

    core  = Σ_u n_u · unit_u (+ loss)          (one microbatch)
    fixed = full − mb · core                   (embedding, optimizer, the
                                                gradients' reductions: the
                                                rest)
    corrected = full
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.configs.base import ShapeConfig


def _metrics(low) -> Dict[str, Any]:
    from repro_torch.launch.dryrun import measure
    m = measure(low)
    return {
        "flops": m["flops"],
        "bytes": m["bytes"],
        "coll": float(m["collectives"].get("total", 0)),
        "coll_by_op": {k: v for k, v in m["collectives"].items()
                       if not k.endswith("_count")},
        "temp_bytes": m["memory"]["temp_bytes"],
        "argument_bytes": m["memory"]["argument_bytes"],
        "kernels": {k: v["calls"] for k, v in m["kernels"].items()},
    }


def _rows(shape: ShapeConfig, mesh, mb: int) -> int:
    rows = shape.global_batch // mb
    if mesh is not None and mesh.row_axes:
        shards = mesh.size(mesh.row_axes)
        if rows % shards == 0:
            rows //= shards
    return rows


def _meta(shape, dtype, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _units(cfg):
    """[(name, n, one layer's ParamSpec tree, the encoder output as a
    second input, apply(p, x, positions, enc) -> (y, aux))] of a train
    or prefill step: the layer plan's positions, or the audio family's
    encoder and decoder layers."""
    from repro_torch.models import transformer as tf
    if cfg.family == "audio":
        enc_layer, dec_layer = tf._audio_layer_params(cfg)
        dec = tf._remat(cfg, functools.partial(tf._dec_layer_apply, cfg))
        return [
            ("block_enc_blocks", cfg.num_encoder_layers, enc_layer, False,
             lambda p, x, pos, enc: (tf._enc_layer_apply(cfg, p, x), None)),
            ("block_dec_blocks", cfg.num_layers, dec_layer, True,
             lambda p, x, pos, enc: (dec(p, x, enc, pos), None))]
    plan, n_scan = tf._layer_plan(cfg)
    out = []
    for i, (kind, ffn) in enumerate(plan):
        fn = tf._remat(cfg, functools.partial(tf._layer_apply, cfg, kind,
                                              ffn))
        out.append((f"block_pos{i}_{kind}_{ffn}", n_scan,
                    tf._layer_params(cfg, kind, ffn), False,
                    lambda p, x, pos, enc, fn=fn: fn(p, x, pos)))
    return out


def lower_block(mdl, unit, shape: ShapeConfig, mesh, *, train: bool,
                rows: int):
    """One unit of `_units` alone on the mesh: its forward (and with
    `train` its backward, seeded with a meta gradient) at `rows` rows of
    the shape's sequence (the encoder layer's at `encoder_seq_len`): the
    rank's block of its positions where `seq_parallel` splits the stream
    over "model"."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import Lowered
    from repro_torch.models.params import seq_parallel, torch_dtype
    from repro_torch.models.steps import abstract_tree, local
    from repro_torch.optim import tree_leaves
    cfg = mdl.cfg
    name, _, specs, needs_enc, apply = unit
    p = local(abstract_tree(specs, mesh))
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(train)
    dt = torch_dtype(cfg.dtype)
    seq = (cfg.encoder_seq_len if name == "block_enc_blocks"
           else shape.seq_len)
    split = seq_parallel((rows, seq, cfg.d_model), mesh)
    x = _meta((rows, seq // mesh.size("model") if split else seq,
               cfg.d_model), dt, train)
    enc = (_meta((rows, cfg.encoder_seq_len, cfg.d_model), dt, train)
           if needs_enc else None)
    inputs = [x] + ([enc] if needs_enc else [])
    g = _meta(x.shape, x.dtype)

    def run():
        ctx = mesh if mesh is not None else torch.enable_grad()
        with ctx, mesh_lib.stream(split):
            positions = torch.arange(seq, device="meta")[None]
            y, aux = apply(p, x, positions, enc)
            if not train:
                return y
            outs, seeds = [y], [g]
            if aux is not None:
                outs.append(aux)
                seeds.append(torch.ones_like(aux))
            return torch.autograd.grad(outs, inputs + leaves, seeds,
                                       allow_unused=True)
    return Lowered(run, (p, *inputs), grad=train)


def lower_loss(mdl, shape: ShapeConfig, mesh, *, rows: int):
    """The chunked cross-entropy from the final hidden states (whole on
    the rank, as `layers.head_input` gives them), forward and backward,
    at `rows` rows."""
    from repro_torch.launch.dryrun import Lowered
    from repro_torch.models.layers import embed_params
    from repro_torch.models.params import torch_dtype
    from repro_torch.models.steps import abstract_tree, local, mean_nll
    from repro_torch.optim import tree_leaves
    cfg = mdl.cfg
    s_text = shape.seq_len - (cfg.num_image_tokens if cfg.family == "vlm"
                              else 0)
    tok = local(abstract_tree(embed_params(cfg), mesh))
    for t in tree_leaves(tok):
        t.requires_grad_(True)
    h = _meta((rows, s_text, cfg.d_model), torch_dtype(cfg.dtype), True)
    t = _meta((rows, s_text), torch.int32)

    def run():
        ctx = mesh if mesh is not None else torch.enable_grad()
        with ctx:
            nll = mean_nll(cfg, tok, h, t)
            return torch.autograd.grad(nll, [h] + tree_leaves(tok),
                                       allow_unused=True)
    return Lowered(run, (tok, h, t), grad=True)


def lower_decode_block(mdl, shape: ShapeConfig, mesh, pos: int = 0):
    """One decode layer (position `pos` of the plan, or the audio
    family's decoder layer) against its block of the cache, at index
    seq_len − 1, as the whole decode step runs it."""
    from repro_torch.launch.dryrun import Lowered
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import ParamSpec, torch_dtype, \
        tree_map_specs
    from repro_torch.models.steps import abstract_tree, local, long_context
    cfg = mdl.cfg
    b, S = shape.global_batch, shape.seq_len
    long_ctx = long_context(shape)
    stacked = mdl.cache_specs(b, S, long_ctx, padded=mesh is not None)
    strip = lambda s: ParamSpec(s.shape[1:], s.dtype, s.axes[1:], s.init)
    if cfg.family == "audio":
        n_trips = cfg.num_layers
        cache, layer = stacked["dec"], tf._audio_layer_params(cfg)[1]
        step = functools.partial(tf._dec_decode_apply, cfg)
    else:
        plan, n_trips = tf._layer_plan(cfg)
        kind, ffn = plan[pos]
        cache = stacked["blocks"][f"pos{pos}"]
        layer = tf._layer_params(cfg, kind, ffn)
        step = functools.partial(tf._decode_layer_apply, cfg, kind, ffn)
    c = local(abstract_tree(tree_map_specs(strip, cache), mesh))
    p = local(abstract_tree(layer, mesh))
    x = _meta((_rows(shape, mesh, 1) if b > 1 else 1, 1, cfg.d_model),
              torch_dtype(cfg.dtype))
    spec = (None if mesh is None
            else layers.cache_spec(cfg, b, S, mesh, long_ctx))

    def run():
        ctx = mesh if mesh is not None else torch.no_grad()
        with ctx:
            return step(p, c, x, S - 1, spec)
    return Lowered(run, (p, c, x), donated=c), n_trips


def corrected_cell_metrics(mdl, shape: ShapeConfig, mesh,
                           full_metrics: Dict[str, float],
                           kind: str) -> Dict[str, Any]:
    """The whole-step count (`corrected`, equal to `full_metrics`) and
    its split by unit (`detail`, `core`, `fixed`)."""
    from repro_torch.models import transformer as tf
    cfg = mdl.cfg
    train = kind == "train"
    mb = cfg.microbatches if train else 1
    keys = ("flops", "bytes", "coll")
    detail: Dict[str, Any] = {}
    core = {k: 0.0 for k in keys}

    def add(name, m, n):
        detail[name] = dict(m, n=n)
        for k in keys:
            core[k] += n * m[k]

    if kind == "decode" and cfg.family == "audio":
        low, n = lower_decode_block(mdl, shape, mesh)
        add("decode_dec_blocks", _metrics(low), n)
    elif kind == "decode":
        for i, (kd, ffn) in enumerate(tf._layer_plan(cfg)[0]):
            low, n = lower_decode_block(mdl, shape, mesh, i)
            add(f"decode_pos{i}_{kd}_{ffn}", _metrics(low), n)
    else:
        rows = _rows(shape, mesh, mb)
        for unit in _units(cfg):
            add(unit[0], _metrics(lower_block(mdl, unit, shape, mesh,
                                              train=train, rows=rows)),
                unit[1])
        if train:
            add("loss", _metrics(lower_loss(mdl, shape, mesh, rows=rows)),
                1)
    fixed = {k: full_metrics[k] - mb * core[k] for k in keys}
    corrected = {k: float(full_metrics[k]) for k in keys}
    return {"corrected": corrected, "fixed": fixed, "core": core,
            "microbatches": mb, "detail": detail}
