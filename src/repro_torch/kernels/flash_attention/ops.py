"""Public wrapper of causal GQA attention in the model layout
(b, s, heads, hd): a CUDA tensor goes to the hand-written kernels (or
raises), a CPU tensor to the plain PyTorch versions, any other device
raises. The TPU wrapper transposed to (b, heads, s, hd) and needed
s % block == 0; the CUDA kernels read the model layout through their
strides and mask the ragged edge, so any s runs and nothing is copied.

Under autograd the call is `FlashAttention`, whose forward also keeps the
rows' logsumexp and whose backward is the hand-written backward kernel on
CUDA (`flash_attention_bwd`) or its plain version on the CPU. Without an
input that requires grad the forward runs alone, without the logsumexp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref,
                                                     flash_attention_ref)


def _heads_first(*xs):
    return [x.transpose(1, 2) for x in xs]


def _device(q):
    dev = q.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash_attention for device {dev}")
    return dev.type


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention with a hand-written backward. Saves q, k, v,
    the output and the f32 logsumexp (b, nq, s) for it."""

    @staticmethod
    def forward(ctx, q, k, v):
        if _device(q) == "cuda":
            b, s, nq, _ = q.shape
            lse = torch.empty((b, nq, s), dtype=torch.float32,
                              device=q.device)
            out = kernel.flash_attention(q, k, v, lse=lse)
        else:
            out, lse = flash_attention_fwd_ref(*_heads_first(q, k, v))
            out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if _device(q) == "cuda":
            return kernel.flash_attention_bwd(q, k, v, out, lse,
                                              do.contiguous())
        grads = flash_attention_bwd_ref(*_heads_first(q, k, v, out), lse,
                                        do.transpose(1, 2))
        return tuple(g.transpose(1, 2) for g in grads)


def flash_attention(q, k, v):
    """q (b, s, nq, hd); k/v (b, s, nkv, hd), f32 or bf16; causal.
    Returns (b, s, nq, hd) in q's dtype. The CUDA kernel uses tiles of
    its own (128 rows at head dims 64 and 128, 64 below); the reference's
    `block_q`/`block_k` have no counterpart."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v)
    if _device(q) == "cuda":
        return kernel.flash_attention(q, k, v)
    out = flash_attention_ref(*_heads_first(q, k, v))
    return out.transpose(1, 2)
