"""Step functions of the port (train, prefill, greedy decode), their
state and their abstract inputs: the counterpart of
`repro/models/steps.py`.

The training step is the reference's: the chunked, rematerialized
cross-entropy (`lm_loss`), gradients in the parameters' dtype (or
accumulated in f32 over `cfg.microbatches`), clipping by the global norm,
the warm-up-cosine schedule and AdamW. Gradients come from
`torch.autograd.grad` (attention through the hand-written forward and
backward kernels on the card); the step updates the state's tensors in
place.

On a `launch.mesh.Mesh` each rank takes its rows of the global batch
(over "pod" and "data"; with microbatches, its rows of each microbatch,
which is a block of the global batch as in the reference). The state is
either held in blocks, as the reference's `resolve_axes` lays it out
(`init_train_state(mesh=...)`, `train_state_specs(mdl, mesh)`): the
step then runs tensor-parallel over "model" and gathers the FSDP blocks
over "data" (`models/sharding.py`); or held whole on every rank (the
data-parallel form, where "model" repeats the step). The step tells them
apart by the params' shapes. The gradients of leaves sharded over a row
axis arrive summed over it (the gathers' backward); the others are
summed over the row axes, and all are divided by the row shards, in f32;
loss and metrics are averaged over the row axes; the global norm adds
each leaf's blocks once. No gradient is reduced over "model": every
model rank owns a distinct block or computes the same value. The
abstract specs are `device="meta"` tensors of the reference's shapes and
dtypes (its `ShapeDtypeStruct`s without a mesh), or on a mesh `Sharded`
leaves: they allocate nothing.

Prefill and decode on a mesh (`make_prefill_step(mdl, mesh)`,
`make_decode_step(mdl, mesh, batch=, cache_len=, long_ctx=)`) run under
`with mesh:` on the rank's blocks: its rows of the batch, of the token
and of the cache, its blocks of the params (`init_cache(mesh=...)`,
`decode_input_specs(mdl, shape, mesh)`). Prefill returns the rank's
vocab block of the last position's logits; decode gathers the logits
over "model" for the argmax and returns the rank's rows of the next
token.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import all_reduce, row_block
from repro_torch.models import layers
from repro_torch.models.params import (LOGICAL_RULES_TP, ParamSpec,
                                       Sharded, init_params, local_shape,
                                       resolve_axes, sharded_axes,
                                       sharded_spec, torch_dtype,
                                       tree_map_specs)
from repro_torch.models.transformer import ModelDef
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               opt_specs, tree_leaves, tree_unflatten,
                               warmup_cosine)

# ---------------------------------------------------------------------------
# Loss and training step
# ---------------------------------------------------------------------------

LOSS_CHUNK = 512  # seq positions per CE chunk (bounds the f32 logits buffer)


def _chunk_nll(cfg, tok, pad_mask, h_c, t_c):
    """Per-position negative log-likelihood of one chunk: the unembedding
    in the model's dtype, f32 logits with the padded vocab columns at
    −1e30, log-softmax, the targets' entries. Under `with mesh:` with the
    vocab split over "model", `_vocab_parallel_nll`."""
    logits = layers.unembed(tok, h_c, cfg).float()
    mesh = mesh_lib.state_mesh()
    if mesh is not None and logits.shape[-1] != pad_mask.shape[0]:
        return _vocab_parallel_nll(cfg, mesh, logits, pad_mask, t_c)
    logits = torch.where(pad_mask, logits, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, t_c.long()[..., None])[..., 0]


def _vocab_parallel_nll(cfg, mesh, logits, pad_mask, t_c):
    """The NLL from each rank's block of the logits: the row max by a max
    over "model" (a constant of the gradient), the sum of exp by a sum
    over "model", the target's logit from the rank that holds it."""
    cols = layers.vocab_block(cfg, mesh)
    logits = torch.where(pad_mask[cols], logits, -1e30)
    mx = all_reduce(logits.detach().amax(-1), "max", mesh, "model")
    z = logits - mx[..., None]
    se = mesh_lib.reduce_from_group(z.exp().sum(-1), mesh)
    n = cols.stop - cols.start
    t = t_c.long() - cols.start
    inside = (t >= 0) & (t < n)
    zt = z.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
    zt = mesh_lib.reduce_from_group(zt.masked_fill(~inside, 0.0), mesh)
    return torch.log(se) - zt


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
    nll_mean = mean_nll(cfg, params["tok"], hidden, batch["targets"])
    loss = nll_mean + 0.01 * aux
    return loss, {"nll": nll_mean, "aux": aux}


def mean_nll(cfg: ModelConfig, tok, hidden, targets):
    """The mean NLL of `targets` under the final hidden states, chunk by
    chunk (`lm_loss`'s cross-entropy)."""
    s = hidden.shape[1]
    pad_mask = (torch.arange(cfg.padded_vocab(), device=hidden.device)
                < cfg.vocab_size)
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        chunk = s
    nll = [checkpoint(_chunk_nll, cfg, tok, pad_mask,
                      hidden[:, i:i + chunk], targets[:, i:i + chunk],
                      use_reentrant=False) for i in range(0, s, chunk)]
    return torch.cat(nll, dim=1).mean()


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
    out = []
    if grads:
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        flat = all_reduce(flat, "sum", mesh, axes) / shards
        i = 0
        for g in grads:
            out.append(flat[i:i + g.numel()].reshape(g.shape).to(g.dtype))
            i += g.numel()
    keys = sorted(metrics)
    scal = torch.stack([loss.float()] + [metrics[k].float() for k in keys])
    scal = all_reduce(scal, "sum", mesh, axes) / shards
    return (out, scal[0].to(loss.dtype),
            {key: scal[1 + j].to(metrics[key].dtype)
             for j, key in enumerate(keys)})


def _sharded_mean(mesh, grads, axes, loss, metrics):
    """`_data_parallel_mean` for a state held in blocks: a leaf sharded
    over a row axis arrived summed over it, so it is summed over the
    other row axes only (one flat f32 all-reduce for each such set of
    axes); all are divided by the row shards."""
    rows, shards = mesh.row_axes, mesh.size(mesh.row_axes)
    out = [g.float() for g in grads]
    groups: Dict[Tuple[str, ...], list] = {}
    for i, ax in enumerate(axes):
        rest = tuple(a for a in rows if a not in ax)
        groups.setdefault(rest, []).append(i)
    for rest in sorted(groups):
        idx = groups[rest]
        if rest and mesh.size(rest) > 1:
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            flat = all_reduce(flat, "sum", mesh, rest)
            j = 0
            for i in idx:
                n = out[i].numel()
                out[i] = flat[j:j + n].reshape(out[i].shape)
                j += n
    out = [(o / shards).to(g.dtype) for o, g in zip(out, grads)]
    _, loss, metrics = _data_parallel_mean(mesh, [], loss, metrics)
    return out, loss, metrics


def _holds_blocks(specs, mesh, params) -> bool:
    """True where `params` are this rank's blocks on `mesh` (`specs`: the
    `Sharded` leaves of the param tree, as `init_train_state(mesh=...)`
    holds them), False where they are whole (`init_train_state()`);
    raises on anything else."""
    if mesh is None:
        return False
    shapes = [tuple(p.shape) for p in tree_leaves(params)]
    if shapes == [tuple(s.local.shape) for s in specs] and any(
            s.local.shape != s.shape for s in specs):
        return True
    if shapes == [s.shape for s in specs]:
        return False
    raise ValueError("the params are neither whole nor this rank's blocks "
                     f"on {mesh}")


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
    of each microbatch by its coordinate over ("pod", "data"), and the
    gradients, loss and metrics are averaged over that group in f32
    before the clip, so every rank clips and steps on the same values.
    A state of blocks (`init_train_state(mesh=...)`) steps tensor-parallel
    under `with mesh:`; a whole state under `with mesh.replicated():`."""
    k = mdl.cfg.microbatches
    specs = axes = None
    if mesh is not None:
        specs = tree_leaves(tree_map_specs(lambda s: sharded_spec(s, mesh),
                                           mdl.param_tree))
        axes = [sharded_axes(s.spec) for s in specs]

    def rows(x):
        return x if mesh is None else x[row_block(mesh, x.shape[0])]

    def train_step(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        leaves = tree_leaves(params)
        blocks = _holds_blocks(specs, mesh, params)
        if mesh is None:
            ctx = contextlib.nullcontext()
        else:
            ctx = mesh if blocks else mesh.replicated()
        with ctx:
            if k == 1:
                loss, metrics, grads = _grads(
                    mdl, params, {key: rows(x) for key, x in batch.items()},
                    leaves)
            else:
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in leaves]
                losses, mets = [], []
                for i in range(k):
                    mb = {key: rows(x.reshape((k, x.shape[0] // k)
                                              + x.shape[1:])[i])
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
        if blocks:
            grads, loss, metrics = _sharded_mean(mesh, grads, axes, loss,
                                                 metrics)
            grads, gnorm = clip_by_global_norm(
                tree_unflatten(params, grads), clip, mesh, axes)
        else:
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


def make_prefill_step(mdl: ModelDef, mesh=None):
    """Forward over the prompt (the batch of `batch_specs`: `tokens`, and
    `frames` for the audio family or `img_embeds` for the vlm family);
    returns the last position's logits (b, padded vocab). Only that
    position is unembedded: the other rows of the reference's full logits
    are never read. With `mesh`, under `with mesh:` on the rank's blocks
    of the params and its rows of the batch; the logits are the rank's
    vocab block where "model" splits the vocab (`layers.vocab_block`)."""
    def prefill_step(params, batch):
        ctx = contextlib.nullcontext() if mesh is None else mesh
        with ctx:
            hidden, _ = mdl.forward(params, batch, return_hidden=True)
            return layers.unembed(params["tok"], hidden[:, -1], mdl.cfg)
    return prefill_step


def make_decode_step(mdl: ModelDef, mesh=None, *, batch: int = None,
                     cache_len: int = None, long_ctx: bool = False):
    """(params, cache, token (b, 1), index: int) -> (next token (b, 1)
    int32, cache): greedy argmax over the padded vocab, as the reference
    takes it; the cache is written in place. With `mesh`, under `with
    mesh:` on the rank's blocks: the k/v laid out as a cache of `batch`
    rows and `cache_len` positions (`long_ctx`: the long-context rule) is
    (`layers.cache_spec`), the token and the next token the rank's
    rows."""
    spec = None
    if mesh is not None:
        if batch is None or cache_len is None:
            raise ValueError("decode on a mesh needs the cache's batch and "
                             "cache_len")
        spec = layers.cache_spec(mdl.cfg, batch, cache_len, mesh, long_ctx)

    def decode_step(params, cache, token, index: int):
        ctx = contextlib.nullcontext() if mesh is None else mesh
        with ctx:
            logits, cache = mdl.decode(params, cache, token, index, spec)
        next_token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return next_token, cache
    return decode_step


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=torch_dtype(dtype), device="meta")


def _sds(shape, dtype, axes, mesh):
    """A meta tensor of `shape`, or on `mesh` a `Sharded` leaf laid out
    by the "tp" rules (the reference's `_sds`)."""
    if mesh is None:
        return _meta(shape, dtype)
    return sharded_spec(ParamSpec(tuple(shape), dtype, tuple(axes)), mesh)


def abstract_tree(spec_tree, mesh=None):
    """The ParamSpec tree as meta tensors, or on `mesh` as `Sharded`
    leaves (each with the rank's block as a meta tensor, `.local`)."""
    return tree_map_specs(lambda s: _sds(s.shape, s.dtype, s.axes, mesh),
                          spec_tree)


def local(tree):
    """The rank's meta blocks of a tree of `Sharded` leaves (meta tensors
    are kept as they are)."""
    if isinstance(tree, dict):
        return {k: local(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):                    # a NamedTuple state
        return type(tree)(*(local(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(local(v) for v in tree)
    return tree.local if isinstance(tree, Sharded) else tree


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """The batch of a train or prefill cell: `tokens` (b, s_text) int32
    (s_text = s less the vlm family's image tokens), `img_embeds` (b,
    num_image_tokens, d) bf16 for the vlm family, `frames` (b,
    encoder_seq_len, d) bf16 for the audio family, and for a train cell
    `targets` like `tokens`. A decode cell has none. On `mesh`, `Sharded`
    leaves with "batch" over ("pod", "data"): `.local` holds the rank's
    rows."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        s_text = s - (cfg.num_image_tokens if cfg.family == "vlm" else 0)
        out["tokens"] = _sds((b, s_text), torch.int32, ("batch", None), mesh)
        if cfg.family == "vlm":
            out["img_embeds"] = _sds((b, cfg.num_image_tokens, cfg.d_model),
                                     torch.bfloat16, ("batch", None, None),
                                     mesh)
        if cfg.family == "audio":
            out["frames"] = _sds((b, cfg.encoder_seq_len, cfg.d_model),
                                 torch.bfloat16, ("batch", None, None), mesh)
        if shape.kind == "train":
            out["targets"] = _sds((b, s_text), torch.int32, ("batch", None),
                                  mesh)
    return out


def long_context(shape: ShapeConfig) -> bool:
    """The reference's rule: a cache of 2^18 positions or more is split
    over ("data", "model") ("long_kv_seq")."""
    return shape.seq_len >= (1 << 18)


def decode_input_specs(mdl: ModelDef, shape: ShapeConfig, mesh=None):
    """(cache, token (b, 1) int32, index) of a decode cell: the cache of
    `global_batch` rows and `seq_len` positions under the long-context
    rule (`long_context`), as meta tensors, or on `mesh` `Sharded` leaves
    in the reference's layout (an MHA-padded config's cache over its
    padded heads); the index a 0-d int32 (the port's step takes it as a
    host int)."""
    b = shape.global_batch
    cache = abstract_tree(mdl.cache_specs(b, shape.seq_len,
                                          long_context(shape),
                                          padded=mesh is not None), mesh)
    token = _sds((b, 1), torch.int32, ("batch", None), mesh)
    index = _sds((), torch.int32, (), mesh)
    return cache, token, index


def train_state_specs(mdl: ModelDef, mesh=None):
    """The train state's shapes and dtypes: params, the AdamW moments (f32)
    and count (int32), and the step (int32), as meta tensors. On a mesh,
    `Sharded` leaves: each leaf's spec by the reference's "tp" rules, its
    global shape and dtype, and the rank's block as a meta tensor
    (`.local`)."""
    if mesh is not None and not set(mesh.axis_names) <= {"pod", "data",
                                                          "model"}:
        raise ValueError(f"mesh axes {mesh.axis_names}: the train state "
                         "knows 'pod', 'data' and 'model'")

    def conv(spec: ParamSpec):
        if mesh is not None:
            return sharded_spec(spec, mesh)
        return _meta(spec.shape, spec.dtype)
    return {"params": tree_map_specs(conv, mdl.param_tree),
            "opt": tree_map_specs(conv, opt_specs(mdl.param_tree)),
            "step": conv(ParamSpec((), torch.int32, (), "zeros"))}


# ---------------------------------------------------------------------------
# Concrete state
# ---------------------------------------------------------------------------

def init_train_state(mdl: ModelDef, seed: int = 0, device=None, mesh=None):
    """Params drawn as `init_params` draws them (the same per-path seeds),
    marked to require grad; zero AdamW moments; step 0 (int32). On
    `device` (None: the GPU; raises without one unless "cpu" is asked).
    With `mesh`, the rank's blocks (`train_state_specs(mdl, mesh)`), each
    leaf drawn whole and cut, one at a time."""
    params = init_params(mdl.param_tree, seed, device, mesh)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"params": params, "opt": adamw_init(params), "step": step}


def init_serving_params(mdl: ModelDef, seed: int = 0, device=None):
    """The model's parameters alone (no optimizer state), drawn on
    `device` (None: the GPU; raises without one unless "cpu" is asked)."""
    return init_params(mdl.param_tree, seed, device)


def init_cache(mdl: ModelDef, batch: int, cache_len: int, device=None,
               long_ctx: bool = False, mesh=None):
    """A zero decode cache on `device` (None: the GPU): k/v of `cache_len`
    positions at every attention layer (in `cfg.cache_dtype`, f8 e4m3fn
    for qwen1.5-32b), the mamba state (h, conv) at every mamba layer of the
    hybrid family, or for the ssm family the RWKV state; the states' sizes
    do not depend on `cache_len` (as in the reference). For the audio
    family `{"dec": {"self", "cross"}}`: the decoder's self k/v and the
    cross k/v over `encoder_seq_len` rows, zero until a caller fills them
    (`ModelDef.fill_cross_cache`, on a mesh too), as the reference's
    `serve_decode` leaves them.
    With `mesh`, the rank's blocks of the reference's layout
    (`cache_specs(batch, cache_len, long_ctx, padded=True)`), zeros made
    at the block's shape."""
    specs = mdl.cache_specs(batch, cache_len, long_ctx,
                            padded=mesh is not None)
    if mesh is None:
        return init_params(specs, 0, device)
    dev = resolve_device(device)
    return tree_map_specs(
        lambda s: torch.zeros(local_shape(s.shape, resolve_axes(
            s.axes, s.shape, mesh, LOGICAL_RULES_TP), mesh),
            dtype=s.dtype, device=dev), specs)
