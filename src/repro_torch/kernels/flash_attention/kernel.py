"""Launch wrappers of the hand-written CUDA kernels of causal GQA
attention: the forward `flash_attention` (`repro_torch/csrc/
flash_attention.cu`), the port of the Pallas kernel in
`repro/kernels/flash_attention/kernel.py`, and its backward
`flash_attention_bwd` (`repro_torch/csrc/flash_attention_bwd.cu`; the
reference differentiates its plain jnp attention instead, so the backward
has no Pallas counterpart).

Each wrapper validates what its kernels assume, allocates the outputs,
launches on the current CUDA stream without synchronising, raises if the
launch was refused, and counts its calls in `<wrapper>.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import check_heads_layout, expect

HEAD_DIMS = (16, 32, 64, 128)


def _check_heads(q, k, v):
    """(device, b, s, nq, nkv, hd) of q (b, s, nq, hd) and k/v (b, s, nkv,
    hd) in the layout the kernels read; raises for anything else."""
    device = check_heads_layout(q, "q", None)
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    check_heads_layout(k, "k", (b, s, nkv, hd), q.dtype, device)
    check_heads_layout(v, "v", (b, s, nkv, hd), q.dtype, device)
    if hd not in HEAD_DIMS or nkv == 0 or nq % nkv:
        raise ValueError(f"head_dim {hd} (takes {HEAD_DIMS}) or heads "
                         f"{nq}/{nkv} outside the kernel's limits")
    return device, b, s, nq, nkv, hd


def flash_attention(q, k, v, lse=None):
    """Causal GQA attention. q (b, s, nq, hd), k/v (b, s, nkv, hd), one
    dtype (f32 or bf16) on one CUDA device, each with a unit stride on hd
    and 16-byte aligned rows (any other strides, so views of the model's
    tensors need no copy). Returns a contiguous (b, s, nq, hd) tensor of
    q's dtype; the kv head of q head h is h // (nq // nkv). With `lse`, a
    contiguous f32 (b, nq, s) tensor, the kernel also writes each row's
    logsumexp of its scaled, masked logits there (for the backward)."""
    device, b, s, nq, nkv, hd = _check_heads(q, k, v)
    if lse is not None:
        expect(lse, "lse", torch.float32, (b, nq, s), device)
    out = torch.empty((b, s, nq, hd), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = load("flash_attention")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, s, nq, nkv, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], hd ** -0.5, int(q.dtype == torch.bfloat16),
            stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of causal GQA attention for the upstream gradient
    `do`: q, k, v as `flash_attention` takes them, o its contiguous output
    and lse the logsumexp it wrote, do in q's shape and layout rules.
    Returns contiguous dq (b, s, nq, hd), dk and dv (b, s, nkv, hd) in q's
    dtype. Three kernels run in one call (D = rowsum(dO∘O), then dK/dV
    and dQ); the call counts once."""
    device, b, s, nq, nkv, hd = _check_heads(q, k, v)
    expect(o, "o", q.dtype, (b, s, nq, hd), device)
    expect(lse, "lse", torch.float32, (b, nq, s), device)
    check_heads_layout(do, "do", (b, s, nq, hd), q.dtype, device)
    dq = torch.empty((b, s, nq, hd), dtype=q.dtype, device=device)
    dk = torch.empty((b, s, nkv, hd), dtype=q.dtype, device=device)
    dv = torch.empty((b, s, nkv, hd), dtype=q.dtype, device=device)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, nq, s), dtype=torch.float32, device=device)
    lib = load("flash_attention_bwd")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, nq, nkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], hd ** -0.5, int(q.dtype == torch.bfloat16),
            stream)
    if err:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed: {msg} "
                           f"({err})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
