"""GShard-style capacity-based Mixture-of-Experts of the port (top-k
dispatch einsums), the counterpart of `repro/models/moe.py` with its
names.

Groups are sequences: each batch row routes its tokens on its own. The
router is an f32 product (TF32 stays off, as the port has it), the top-k
is sequential (`argmax` takes the first maximum, as `jnp.argmax` does), a
token's position in its expert's buffer of `C` slots comes from a cumsum
along the sequence, and tokens past the capacity are dropped. The
dispatch/combine einsums and the expert products are plain products, as
in the reference, where XLA and not a Pallas kernel computes them: every
expert's buffer is computed, full or not (a gather-based dispatch is
later work, ROADMAP.md).

On a mesh the Switch aux loss is the global batch's, as the reference
takes it: the fraction of first choices and the mean router probability
of each expert are summed over the row shards ("pod", "data") before
their product, through a sum whose backward sums too. Under `with mesh:`
(a state held in blocks) the experts split over "model": the router is
whole on every rank, so every rank routes every token alike (kept slots
and drops exact), and each rank runs its own experts' buffers with its
slice of `combine`, summed over "model". On a residual stream split over
"model" (`launch.mesh.stream_split()`) the router and the aux see every
position: the layer gathers the stream's positions whole (the gather
whose backward takes the rank's block), runs as on a whole stream, and
keeps the rank's positions of its output.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import Blocks

Params = Dict[str, Any]


def moe_params(cfg: ModelConfig) -> Params:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p: Params = {
        "router": ParamSpec((d, E), "float32", ("embed", None), "fan_in"),
        "we_in": ParamSpec((E, d, ff), cfg.param_dtype,
                           ("experts", "expert_in", None), "fan_in"),
        "we_gate": ParamSpec((E, d, ff), cfg.param_dtype,
                             ("experts", "expert_in", None), "fan_in"),
        "we_out": ParamSpec((E, ff, d), cfg.param_dtype,
                            ("experts", None, "expert_in"), "fan_in"),
    }
    for i in range(cfg.num_shared_experts):
        p[f"shared_{i}"] = layers.mlp_params(cfg)
    return p


def _capacity(cfg: ModelConfig, s: int) -> int:
    c = int(s * cfg.num_experts_per_tok * cfg.moe_capacity_factor
            / cfg.num_experts)
    return max(1, -(-c // 4) * 4) if s > 4 else max(1, c)


class Route(NamedTuple):
    probs: torch.Tensor     # (b, s, E) f32 router softmax
    choices: torch.Tensor   # (b, s, k) int64: the expert of each round
    combine: torch.Tensor   # (b, s, E, C) f32, renormalised; 0 = not kept


def route(router, cfg: ModelConfig, x) -> Route:
    """The reference's routing of x (b, s, d) over `router` (d, E):
    softmax of the f32 logits, then k sequential rounds, each taking every
    token's largest remaining probability; a token whose slot in that
    expert's buffer (tokens of the group routed there before it, in this
    round and the earlier ones) is ≥ C is dropped from it. The kept gates
    are renormalised over the token's chosen experts."""
    b, s, _ = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(cfg, s)
    probs = torch.softmax(x.float() @ router, dim=-1)
    remaining = probs
    counts = torch.zeros((b, E), dtype=torch.int64, device=x.device)
    combine = torch.zeros((b, s, E * C), dtype=torch.float32,
                          device=x.device)
    gates_sum = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    choices = []
    for _ in range(k):
        gate = remaining.amax(-1)                       # (b, s)
        choice = remaining.argmax(-1)                   # first maximum
        onehot = F.one_hot(choice, E)                   # (b, s, E) int64
        # this token's position within its chosen expert's buffer
        pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None, :]
        pos_tok = (pos * onehot).sum(-1)                # (b, s)
        fits = pos_tok < C
        gate = torch.where(fits, gate, 0.0)
        # one slot per (token, round); a dropped token adds 0 to a slot
        slot = choice * C + pos_tok.clamp(max=C - 1)
        combine.scatter_add_(-1, slot[..., None], gate[..., None])
        gates_sum = gates_sum + gate
        counts = counts + (onehot * fits[..., None]).sum(1)
        remaining = remaining * (1.0 - onehot)
        choices.append(choice)
    combine = combine / torch.clamp(gates_sum[..., None], min=1e-9)
    return Route(probs, torch.stack(choices, -1),
                 combine.view(b, s, E, C))


def _experts(w: Params, x, combine):
    """The experts' buffers of the tokens `combine` (b, s, E, C) keeps,
    each through its gated MLP, combined back (b, s, d)."""
    dispatch = (combine > 0.0).to(x.dtype)
    xe = torch.einsum("bsec,bsd->becd", dispatch, x)    # (b, E, C, d)
    h = torch.einsum("becd,edf->becf", xe, w["we_in"])
    g = torch.einsum("becd,edf->becf", xe, w["we_gate"])
    h = F.silu(g) * h
    ye = torch.einsum("becf,efd->becd", h, w["we_out"])
    return torch.einsum("becd,bsec->bsd", ye, combine.to(x.dtype))


def moe(p: Params, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (y (b, s, d), the Switch load-balancing aux loss)."""
    E = cfg.num_experts
    mesh = mesh_lib.state_mesh()
    if mesh_lib.stream_split():
        x = mesh_lib.from_stream(x, mesh, same=True)
        with mesh_lib.stream(False):
            y, aux = moe(p, cfg, x)
        return mesh_lib.to_stream(y, mesh, same=True), aux
    if mesh is None:
        r = route(p["router"], cfg, x)
        y = _experts(p, x, r.combine)
    else:
        L = Blocks(mesh, p, moe_params, cfg)
        r = route(L.local("router"), cfg, x)
        if L.on_model("we_in", 0):
            n = E // L.model_size
            e0 = L.model_index * n
            combine = mesh_lib.copy_to_group(r.combine, mesh)[:, :,
                                                              e0:e0 + n]
            w = {k: L.local(k) for k in ("we_in", "we_gate", "we_out")}
            y = _experts(w, mesh_lib.copy_to_group(x, mesh), combine)
            y = mesh_lib.reduce_from_group(y, mesh)
        else:
            w = {k: L.whole(k) for k in ("we_in", "we_gate", "we_out")}
            y = _experts(w, x, r.combine)
    for i in range(cfg.num_shared_experts):
        y = y + layers.mlp(p[f"shared_{i}"], x, cfg=cfg)
    # fraction of first choices and mean router probability per expert,
    # over the global batch
    me = F.one_hot(r.choices[..., 0], E).float().mean((0, 1))
    pe = r.probs.mean((0, 1))
    rows = mesh_lib.current_mesh()
    if rows is not None and rows.row_axes:
        n = rows.size(rows.row_axes)
        both = mesh_lib.sum_over_group(torch.stack([me, pe]), rows,
                                       rows.row_axes) / n
        me, pe = both[0], both[1]
    return y, E * (me * pe).sum()
