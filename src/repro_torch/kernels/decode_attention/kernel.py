"""Launch wrapper of the hand-written CUDA kernel `decode_attention`
(`repro_torch/csrc/decode_attention.cu`), the port of the Pallas kernel in
`repro/kernels/decode_attention/kernel.py`.

The wrapper validates what the kernel assumes, allocates the output,
launches on the current CUDA stream without synchronising, raises if the
launch was refused, and counts launches in `decode_attention.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import check_heads_layout, expect

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16


def decode_attention(q, k, v, cache_index: int):
    """One query token per sequence. q (b, nkv, group, hd) contiguous;
    k/v (b, S, nkv, hd) of q's dtype (f32 or bf16) with a unit stride on
    hd and 16-byte aligned rows; `cache_index` a host int in [0, S): rows
    0..cache_index are read, the rest is never touched. Returns a
    contiguous (b, nkv, group, hd) tensor of q's dtype."""
    device = check_heads_layout(q, "q", None)
    b, nkv, group, hd = q.shape
    expect(q, "q", q.dtype, (b, nkv, group, hd), device)
    S = k.shape[1]
    check_heads_layout(k, "k", (b, S, nkv, hd), q.dtype, device)
    check_heads_layout(v, "v", (b, S, nkv, hd), q.dtype, device)
    if hd not in HEAD_DIMS or not 1 <= group <= MAX_GROUP:
        raise ValueError(f"head_dim {hd} (takes {HEAD_DIMS}) or group "
                         f"{group} (takes 1..{MAX_GROUP}) outside the "
                         f"kernel's limits")
    if not 0 <= cache_index < S:
        raise ValueError(f"cache_index {cache_index} outside [0, {S})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load("decode_attention")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, nkv, group, hd, cache_index + 1, *k.stride()[:3],
            *v.stride()[:3], hd ** -0.5, int(q.dtype == torch.bfloat16),
            stream)
    if err:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} ({err})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
