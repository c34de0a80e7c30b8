"""Optimizers of the port (AdamW and SGD, f32 moments), the counterpart of
`repro/optim/optimizers.py`: plain functions on nested dicts of tensors.

The arithmetic is the reference's: moments in f32, `count` an int32 0-d
tensor, the bias corrections in f32, the update in f32 and then cast to
the parameter's dtype, weight decay added to every leaf (norm scales and
biases too) when it is non-zero. Where the reference returns new trees,
`adamw_update` writes the new values into the given tensors, leaf by leaf,
so the card holds no second copy of the parameters and moments.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import ParamSpec, tree_map_specs


def tree_leaves(tree):
    """The leaves of a nested dict in the reference's order (`jax.tree_util`
    flattens a dict by sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A nested dict of `like`'s structure holding `leaves`, given in the
    order `tree_leaves` lists them."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(like)


def _map(fn, *trees):
    """`fn` applied leaf by leaf to dict trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def opt_specs(param_tree):
    """ParamSpec tree of the AdamW state: f32 moments on the parameters'
    shapes and axes, and the int32 count."""
    def mom(s: ParamSpec):
        return ParamSpec(s.shape, "float32", s.axes, "zeros")
    return {"m": tree_map_specs(mom, param_tree),
            "v": tree_map_specs(mom, param_tree),
            "count": ParamSpec((), torch.int32, (), "zeros")}


def adamw_init(params):
    """Zero f32 moments beside each parameter, and count 0 (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their f32 sums of squares."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads · min(1, max_norm / (norm + 1e-9)), norm); the factor is
    cast to each gradient's dtype before the product (rounded to bf16 for
    bf16 gradients), as the reference casts it."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(params, grads, opt_state, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    """One AdamW step with learning rate `lr` (a float or an f32 0-d
    tensor), IN PLACE: every parameter, both moments and the count are
    overwritten, one leaf at a time. Returns the given (params,
    opt_state)."""
    count = opt_state["count"] + 1
    cf = count.float()
    bc1 = 1.0 - torch.pow(b1, cf)
    bc2 = 1.0 - torch.pow(b2, cf)

    def upd(p, g, m, v):
        g32 = g.float()
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * g32.square())
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))

    with torch.no_grad():
        _map(upd, params, grads, opt_state["m"], opt_state["v"])
        opt_state["count"].copy_(count)
    return params, opt_state


def sgd_update(params, grads, lr, momentum_state=None, momentum: float = 0.0):
    """Plain SGD, with f32 momentum when `momentum` and a state are given.
    Returns (params, momentum_state)."""
    if momentum and momentum_state is not None:
        momentum_state = _map(lambda s, g: momentum * s + g.float(),
                              momentum_state, grads)
        eff = momentum_state
    else:
        eff = grads
    params = _map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                  params, eff)
    return params, momentum_state
