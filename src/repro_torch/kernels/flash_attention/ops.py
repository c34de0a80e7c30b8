"""Public wrapper of causal GQA attention in the model layout
(b, s, heads, hd): a CUDA tensor goes to the hand-written kernel (or
raises), a CPU tensor to the plain PyTorch version, any other device
raises. The TPU wrapper transposed to (b, heads, s, hd) and needed
s % block == 0; the CUDA kernel reads the model layout through its strides
and masks the ragged edge, so any s runs and nothing is copied."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v):
    """q (b, s, nq, hd); k/v (b, s, nkv, hd), f32 or bf16; causal.
    Returns (b, s, nq, hd) in q's dtype. The CUDA kernel uses tiles of
    its own (128 rows at head dims 64 and 128, 64 below); the reference's
    `block_q`/`block_k` have no counterpart."""
    dev = q.device
    if dev.type == "cuda":
        return kernel.flash_attention(q, k, v)
    if dev.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))
        return out.transpose(1, 2)
    raise ValueError(f"no flash_attention for device {dev}")
