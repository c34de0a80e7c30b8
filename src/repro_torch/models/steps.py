"""Step functions of the port (train, prefill, greedy decode), their
state and their abstract inputs: the counterpart of
`repro/models/steps.py`.

The training step is the reference's: the chunked, rematerialized
cross-entropy (`lm_loss`), gradients in the parameters' dtype (or
accumulated in f32 over `cfg.microbatches`), clipping by the global norm,
the warm-up-cosine schedule and AdamW. Gradients come from
`torch.autograd.grad` (attention through the hand-written forward and
backward kernels on the card); the step updates the state's tensors in
place. On a `launch.mesh.Mesh` the step is data-parallel over the row
axes ("pod", "data"): each rank takes its rows of the global batch and
the gradients, loss and metrics are averaged over that group in f32
before the clip; the "model" axis replicates the step, and the state is
replicated (tensor parallelism is not in the port yet). The abstract
specs are `device="meta"` tensors of the reference's shapes and dtypes
(its `ShapeDtypeStruct`s without a mesh): they allocate nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import all_reduce, row_block
from repro_torch.models import layers
from repro_torch.models.params import (ParamSpec, init_params, torch_dtype,
                                       tree_map_specs)
from repro_torch.models.transformer import ModelDef
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               opt_specs, tree_leaves, tree_unflatten,
                               warmup_cosine)

# ---------------------------------------------------------------------------
# Loss and training step
# ---------------------------------------------------------------------------

LOSS_CHUNK = 512  # seq positions per CE chunk (bounds the f32 logits buffer)


def _chunk_nll(tok, pad_mask, h_c, t_c):
    """Per-position negative log-likelihood of one chunk: the unembedding
    in the model's dtype, f32 logits with the padded vocab columns at
    −1e30, log-softmax, the targets' entries."""
    logits = layers.unembed(tok, h_c).float()
    logits = torch.where(pad_mask, logits, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, t_c.long()[..., None])[..., 0]


def lm_loss(mdl: ModelDef, params, batch) -> Tuple[torch.Tensor,
                                                    Dict[str, Any]]:
    """(loss, {"nll", "aux"}): the mean next-token NLL plus 0.01 · the
    experts' aux loss. The vlm family's image positions are cut off
    first. The sequence is cut into chunks of min(512, s) positions (one
    chunk when that does not divide s), and each chunk's unembedding and
    cross-entropy is recomputed in the backward, so the (tokens x vocab)
    f32 logits never exist whole."""
    cfg = mdl.cfg
    hidden, aux = mdl.forward(params, batch, return_hidden=True)
    if cfg.family == "vlm" and cfg.num_image_tokens:
        hidden = hidden[:, cfg.num_image_tokens:]
    targets = batch["targets"]
    s = hidden.shape[1]
    pad_mask = (torch.arange(cfg.padded_vocab(), device=hidden.device)
                < cfg.vocab_size)
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        chunk = s
    nll = [checkpoint(_chunk_nll, params["tok"], pad_mask,
                      hidden[:, i:i + chunk], targets[:, i:i + chunk],
                      use_reentrant=False) for i in range(0, s, chunk)]
    nll_mean = torch.cat(nll, dim=1).mean()
    loss = nll_mean + 0.01 * aux
    return loss, {"nll": nll_mean, "aux": aux}


def _grads(mdl: ModelDef, params, batch, leaves):
    """(loss, metrics, grads of `leaves` in their dtype)."""
    loss, metrics = lm_loss(mdl, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _data_parallel_mean(mesh, grads, loss, metrics):
    """The mean over the mesh's row axes of each rank's gradients (one
    all-reduce of a flat f32 buffer, cast back to each leaf's dtype),
    loss and metrics (one f32 all-reduce)."""
    axes, shards = mesh.row_axes, mesh.size(mesh.row_axes)
    if not axes:
        return grads, loss, metrics
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    flat = all_reduce(flat, "sum", mesh, axes) / shards
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].reshape(g.shape).to(g.dtype))
        i += g.numel()
    keys = sorted(metrics)
    scal = torch.stack([loss.float()] + [metrics[k].float() for k in keys])
    scal = all_reduce(scal, "sum", mesh, axes) / shards
    return (out, scal[0].to(loss.dtype),
            {key: scal[1 + j].to(metrics[key].dtype)
             for j, key in enumerate(keys)})


def make_train_step(mdl: ModelDef, *, lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, clip: float = 1.0,
                    weight_decay: float = 0.1, mesh=None):
    """`train_step(state, batch) -> (state, {"loss", "grad_norm", "lr",
    "nll", "aux"})`. With `cfg.microbatches` k > 1 the batch is cut into
    k microbatches along its first axis, their gradients accumulated in
    f32 and divided by k, and loss and metrics are the means over them;
    with k = 1 the gradients are in the parameters' dtype. Then the
    gradients are clipped to global norm `clip`, and AdamW (weight decay
    `weight_decay`) steps at the warm-up-cosine rate of `state["step"]`.
    The input state is updated IN PLACE, leaf by leaf (params, moments,
    count, step), and returned. With `mesh` (a `launch.mesh.Mesh`), the
    batch is the global one: the rank takes its contiguous block of rows
    by its coordinate over ("pod", "data"), and the gradients, loss and
    metrics are averaged over that group in f32 before the clip, so every
    rank clips and steps on the same values."""
    k = mdl.cfg.microbatches

    def train_step(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        leaves = tree_leaves(params)
        if mesh is not None:
            batch = {key: x[row_block(mesh, x.shape[0])]
                     for key, x in batch.items()}
        if k == 1:
            loss, metrics, grads = _grads(mdl, params, batch, leaves)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            losses, mets = [], []
            for i in range(k):
                mb = {key: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                      for key, x in batch.items()}
                l, m, g = _grads(mdl, params, mb, leaves)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                losses.append(l)
                mets.append(m)
            grads = [g / k for g in grads]
            loss = torch.stack(losses).mean()
            metrics = {key: torch.stack([m[key] for m in mets]).mean()
                       for key in mets[0]}
        if mesh is not None:
            grads, loss, metrics = _data_parallel_mean(mesh, grads, loss,
                                                       metrics)
        grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads),
                                           clip)
        lr_t = warmup_cosine(step, peak_lr=lr, warmup_steps=warmup,
                             total_steps=total_steps)
        adamw_update(params, grads, opt, lr_t, weight_decay=weight_decay)
        with torch.no_grad():
            step.add_(1)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr_t,
                       **metrics}

    return train_step


def make_prefill_step(mdl: ModelDef):
    """Forward over the prompt (the batch of `batch_specs`: `tokens`, and
    `frames` for the audio family or `img_embeds` for the vlm family);
    returns the last position's logits (b, padded vocab). Only that
    position is unembedded: the other rows of the reference's full logits
    are never read."""
    def prefill_step(params, batch):
        hidden, _ = mdl.forward(params, batch, return_hidden=True)
        return layers.unembed(params["tok"], hidden[:, -1])
    return prefill_step


def make_decode_step(mdl: ModelDef):
    """(params, cache, token (b, 1), index: int) -> (next token (b, 1)
    int32, cache): greedy argmax over the padded vocab, as the reference
    takes it; the cache is written in place."""
    def decode_step(params, cache, token, index: int):
        logits, cache = mdl.decode(params, cache, token, index)
        next_token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return next_token, cache
    return decode_step


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=torch_dtype(dtype), device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The batch of a train or prefill cell: `tokens` (b, s_text) int32
    (s_text = s less the vlm family's image tokens), `img_embeds` (b,
    num_image_tokens, d) bf16 for the vlm family, `frames` (b,
    encoder_seq_len, d) bf16 for the audio family, and for a train cell
    `targets` like `tokens`. A decode cell has none."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        s_text = s - (cfg.num_image_tokens if cfg.family == "vlm" else 0)
        out["tokens"] = _meta((b, s_text), torch.int32)
        if cfg.family == "vlm":
            out["img_embeds"] = _meta((b, cfg.num_image_tokens, cfg.d_model),
                                      torch.bfloat16)
        if cfg.family == "audio":
            out["frames"] = _meta((b, cfg.encoder_seq_len, cfg.d_model),
                                  torch.bfloat16)
        if shape.kind == "train":
            out["targets"] = _meta((b, s_text), torch.int32)
    return out


def train_state_specs(mdl: ModelDef, mesh=None):
    """The train state's shapes and dtypes: params, the AdamW moments (f32)
    and count (int32), and the step (int32). On a mesh the state is
    replicated (the step is data-parallel), so the specs are the same;
    a mesh is only checked for its axes."""
    if mesh is not None and not set(mesh.axis_names) <= {"pod", "data",
                                                          "model"}:
        raise ValueError(f"mesh axes {mesh.axis_names}: the train state "
                         "knows 'pod', 'data' and 'model'")
    def conv(spec: ParamSpec):
        return _meta(spec.shape, spec.dtype)
    return {"params": tree_map_specs(conv, mdl.param_tree),
            "opt": tree_map_specs(conv, opt_specs(mdl.param_tree)),
            "step": _meta((), torch.int32)}


# ---------------------------------------------------------------------------
# Concrete state
# ---------------------------------------------------------------------------

def init_train_state(mdl: ModelDef, seed: int = 0, device=None):
    """Params drawn as `init_params` draws them (the same per-path seeds),
    marked to require grad; zero AdamW moments; step 0 (int32). On
    `device` (None: the GPU; raises without one unless "cpu" is asked)."""
    params = init_params(mdl.param_tree, seed, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"params": params, "opt": adamw_init(params), "step": step}


def init_serving_params(mdl: ModelDef, seed: int = 0, device=None):
    """The model's parameters alone (no optimizer state), drawn on
    `device` (None: the GPU; raises without one unless "cpu" is asked)."""
    return init_params(mdl.param_tree, seed, device)


def init_cache(mdl: ModelDef, batch: int, cache_len: int, device=None):
    """A zero decode cache on `device` (None: the GPU): k/v of `cache_len`
    positions at every attention layer (in `cfg.cache_dtype`, f8 e4m3fn
    for qwen1.5-32b), the mamba state (h, conv) at every mamba layer of the
    hybrid family, or for the ssm family the RWKV state; the states' sizes
    do not depend on `cache_len` (as in the reference). For the audio
    family `{"dec": {"self", "cross"}}`: the decoder's self k/v and the
    cross k/v over `encoder_seq_len` rows, zero until a caller fills them
    (`layers.encode_kv`), as the reference's `serve_decode` leaves them."""
    return init_params(mdl.cache_specs(batch, cache_len), 0, device)
