"""Launch wrapper of the hand-written CUDA kernel `flash_attention`
(`repro_torch/csrc/flash_attention.cu`), the port of the Pallas kernel in
`repro/kernels/flash_attention/kernel.py`.

The wrapper validates what the kernel assumes, allocates the output,
launches on the current CUDA stream without synchronising, raises if the
launch was refused, and counts launches in `flash_attention.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import check_heads_layout

HEAD_DIMS = (16, 32, 64, 128)


def flash_attention(q, k, v):
    """Causal GQA attention. q (b, s, nq, hd), k/v (b, s, nkv, hd), one
    dtype (f32 or bf16) on one CUDA device, each with a unit stride on hd
    and 16-byte aligned rows (any other strides, so views of the model's
    tensors need no copy). Returns a contiguous (b, s, nq, hd) tensor of
    q's dtype; the kv head of q head h is h // (nq // nkv)."""
    device = check_heads_layout(q, "q", None)
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    check_heads_layout(k, "k", (b, s, nkv, hd), q.dtype, device)
    check_heads_layout(v, "v", (b, s, nkv, hd), q.dtype, device)
    if hd not in HEAD_DIMS or nkv == 0 or nq % nkv:
        raise ValueError(f"head_dim {hd} (takes {HEAD_DIMS}) or heads "
                         f"{nq}/{nkv} outside the kernel's limits")
    out = torch.empty((b, s, nq, hd), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = load("flash_attention")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, nq, nkv, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], hd ** -0.5, int(q.dtype == torch.bfloat16),
            stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
