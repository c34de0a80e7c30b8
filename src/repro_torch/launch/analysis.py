"""The dry run's count split by unit, the counterpart of
`repro/launch/analysis.py` with its signature and return keys.

The reference's XLA counts a while-loop body once whatever its trip
count, so it lowers each scan block alone and corrects the whole-step
count by the trip counts. The port runs layers, microbatches and loss
chunks as Python loops: the whole-step count of `launch/dryrun.py` is
already complete, and `corrected` equals it. What this module still
gives is the split by unit, each traced alone on the same abstract mesh
at the rank's rows of one microbatch: each position of the layer plan
(`transformer._layer_plan`; forward and backward under the config's
remat for a train cell, forward for prefill, one decode layer against its
cache block for decode), and for a train cell the loss (the chunked
cross-entropy of `steps.mean_nll`, forward and backward). Then

    core  = Σ_u n_u · unit_u (+ loss)          (one microbatch)
    fixed = full − mb · core                   (embedding, optimizer, the
                                                gradients' reductions: the
                                                rest)
    corrected = full

The audio family has no layer plan here (its encoder and decoder, item
14a): its units are empty and `fixed` is the whole.
"""
from __future__ import annotations

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


def lower_block(mdl, pos: int, shape: ShapeConfig, mesh, *, train: bool,
                rows: int):
    """One position of the layer plan alone on the mesh: its forward (and
    with `train` its backward, seeded with a meta gradient) at `rows`
    rows of the shape's sequence."""
    from repro_torch.launch.dryrun import Lowered
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import torch_dtype
    from repro_torch.models.steps import abstract_tree, local
    from repro_torch.optim import tree_leaves
    cfg = mdl.cfg
    kind, ffn = tf._layer_plan(cfg)[0][pos]
    p = local(abstract_tree(tf._layer_params(cfg, kind, ffn), mesh))
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(train)
    x = _meta((rows, shape.seq_len, cfg.d_model), torch_dtype(cfg.dtype),
              train)
    fn = tf._remat(cfg, lambda p_, x_, pos_: tf._layer_apply(
        cfg, kind, ffn, p_, x_, pos_))
    g = _meta(x.shape, x.dtype)

    def run():
        ctx = mesh if mesh is not None else torch.enable_grad()
        with ctx:
            positions = torch.arange(shape.seq_len, device="meta")[None]
            y, aux = fn(p, x, positions)
            if not train:
                return y
            outs, seeds = [y], [g]
            if aux is not None:
                outs.append(aux)
                seeds.append(torch.ones_like(aux))
            return torch.autograd.grad(outs, [x] + leaves, seeds,
                                       allow_unused=True)
    return Lowered(run, (p, x), grad=train)


def lower_loss(mdl, shape: ShapeConfig, mesh, *, rows: int):
    """The chunked cross-entropy from the final hidden states, forward
    and backward, at `rows` rows."""
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
    """One decode layer (position `pos` of the plan) against its block of
    the cache, at index seq_len − 1, as the whole decode step runs it."""
    from repro_torch.launch.dryrun import Lowered
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import ParamSpec, torch_dtype, \
        tree_map_specs
    from repro_torch.models.steps import abstract_tree, local, long_context
    cfg = mdl.cfg
    plan, n_trips = tf._layer_plan(cfg)
    kind, ffn = plan[pos]
    b, S = shape.global_batch, shape.seq_len
    long_ctx = long_context(shape)
    stacked = mdl.cache_specs(b, S, long_ctx, padded=mesh is not None)
    strip = lambda s: ParamSpec(s.shape[1:], s.dtype, s.axes[1:], s.init)
    c = local(abstract_tree(tree_map_specs(
        strip, stacked["blocks"][f"pos{pos}"]), mesh))
    p = local(abstract_tree(tf._layer_params(cfg, kind, ffn), mesh))
    x = _meta((_rows(shape, mesh, 1) if b > 1 else 1, 1, cfg.d_model),
              torch_dtype(cfg.dtype))
    spec = (None if mesh is None
            else layers.cache_spec(cfg, b, S, mesh, long_ctx))

    def run():
        ctx = mesh if mesh is not None else torch.no_grad()
        with ctx:
            return tf._decode_layer_apply(cfg, kind, ffn, p, c, x, S - 1,
                                          spec)
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

    if cfg.family != "audio":
        plan, n_scan = tf._layer_plan(cfg)
        if kind == "decode":
            for i, (kd, ffn) in enumerate(plan):
                low, n = lower_decode_block(mdl, shape, mesh, i)
                add(f"decode_pos{i}_{kd}_{ffn}", _metrics(low), n)
        else:
            rows = _rows(shape, mesh, mb)
            for i, (kd, ffn) in enumerate(plan):
                add(f"block_pos{i}_{kd}_{ffn}", _metrics(lower_block(
                    mdl, i, shape, mesh, train=train, rows=rows)), n_scan)
            if train:
                add("loss", _metrics(lower_loss(mdl, shape, mesh,
                                                rows=rows)), 1)
    fixed = {k: full_metrics[k] - mb * core[k] for k in keys}
    corrected = {k: float(full_metrics[k]) for k in keys}
    return {"corrected": corrected, "fixed": fixed, "core": core,
            "microbatches": mb, "detail": detail}
