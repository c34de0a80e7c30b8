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
later work, ROADMAP.md). The reference's `logical_sharding` hints have no
counterpart on one device.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec

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


def moe(p: Params, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (y (b, s, d), the Switch load-balancing aux loss)."""
    E = cfg.num_experts
    r = route(p["router"], cfg, x)
    dispatch = (r.combine > 0.0).to(x.dtype)
    xe = torch.einsum("bsec,bsd->becd", dispatch, x)    # (b, E, C, d)
    h = torch.einsum("becd,edf->becf", xe, p["we_in"])
    g = torch.einsum("becd,edf->becf", xe, p["we_gate"])
    h = F.silu(g) * h
    ye = torch.einsum("becf,efd->becd", h, p["we_out"])
    y = torch.einsum("becd,bsec->bsd", ye, r.combine.to(x.dtype))
    for i in range(cfg.num_shared_experts):
        y = y + layers.mlp(p[f"shared_{i}"], x)
    # fraction of first choices and mean router probability per expert
    me = F.one_hot(r.choices[..., 0], E).float().mean((0, 1))
    pe = r.probs.mean((0, 1))
    return y, E * (me * pe).sum()
