"""Public wrapper of the WKV6 recurrence in the model layout
(b, s, H, K): a CUDA tensor goes to the hand-written kernel (or raises),
a CPU tensor to the plain PyTorch version, any other device raises. The
TPU wrapper padded s to the chunk and transposed to (b, H, s, K); the CUDA
kernel reads the model layout through its strides, and its tile loads fill
a ragged last chunk with zeros, so nothing is copied but the cast to f32.

Under autograd the call is `WKV6`, whose backward is the hand-written
backward kernel on CUDA (`wkv6_bwd`) or its plain version
(`wkv6_chunked_bwd_ref`) on the CPU: the gradient `jax.grad` gives of the
reference's chunked form, exponent clip and chunk edges included. Without
an input that requires grad the forward runs alone. A `meta` tensor
launches nothing: forward and backward return empty meta outputs and
record their costs for the dry run (`kernels/dry.py`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import dry
from repro_torch.kernels.checks import dense, served_device
from repro_torch.kernels.wkv6 import kernel
from repro_torch.kernels.wkv6.ref import (wkv6_chunked_bwd_ref,
                                          wkv6_chunked_ref)


def _forward(r, k, v, la, u, chunk):
    kind = r.device.type
    if kind == "meta":
        dry.record("wkv6", kernel.wkv6_cost(*r.shape, chunk))
        return torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if kind == "cuda":
        return kernel.wkv6(r, k, v, la, u.contiguous(), chunk=chunk)
    return wkv6_chunked_ref(r, k, v, la, u, chunk)[0]


class WKV6(torch.autograd.Function):
    """The chunked WKV6 recurrence with a hand-written backward. Saves
    r, k, v, la and u; the backward rebuilds the chunks' states."""

    @staticmethod
    def forward(ctx, r, k, v, la, u, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, la, u)
        return _forward(r, k, v, la, u, chunk)

    @staticmethod
    def backward(ctx, do):
        r, k, v, la, u = ctx.saved_tensors
        if r.device.type == "meta":
            dry.record("wkv6_bwd", kernel.wkv6_bwd_cost(*r.shape, ctx.chunk))
            grads = tuple(torch.empty_like(t) for t in (r, k, v, la, u))
        elif r.device.type == "cuda":
            grads = kernel.wkv6_bwd(r, k, v, la, u.contiguous(),
                                    dense(do), chunk=ctx.chunk)
        else:
            grads = wkv6_chunked_bwd_ref(r, k, v, la, u, do, ctx.chunk)
        return (*grads, None)


def wkv6(r, k, v, la, u, *, chunk: int = 64):
    """r/k/v/la (b, s, H, K), any float dtype; u (H, K). Returns
    (b, s, H, K) f32 from a zero state, chunks of min(chunk, s) tokens
    from position 0. The recurrence runs in f32 whatever the input dtype,
    as the reference's wrapper casts (a no-op for the model's f32
    inputs)."""
    served_device(r, "wkv6")
    r, k, v, la, u = (t.float() for t in (r, k, v, la, u))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, la, u)):
        return WKV6.apply(r, k, v, la, u, chunk)
    return _forward(r, k, v, la, u, chunk)
