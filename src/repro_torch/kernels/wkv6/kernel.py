"""Launch wrappers of the hand-written CUDA kernels `wkv6`
(`repro_torch/csrc/wkv6.cu`), the port of the Pallas kernel in
`repro/kernels/wkv6/kernel.py`, and `wkv6_bwd`
(`repro_torch/csrc/wkv6_bwd.cu`), its backward, which has no Pallas
counterpart: the reference differentiates its plain `wkv_chunked`.

Each wrapper validates what its kernel assumes, allocates the outputs,
launches on the current CUDA stream without synchronising, raises if the
launch was refused, and counts its calls in `<wrapper>.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import check_heads_layout, expect

HEAD_SIZES = (16, 32, 64)
CHUNKS = (16, 32, 64)


def wkv6(r, k, v, la, u, *, chunk: int = 64):
    """The chunked WKV6 recurrence from a zero state. r/k/v/la
    (b, s, H, K) f32 on one CUDA device, each with a unit stride on K, a
    16-byte aligned base and strides of whole 16 bytes, as the kernel's
    TMA loads take them (any other strides, so views of the model's
    tensors need no copy); u (H, K) f32, contiguous. Chunks of `chunk`
    rows from position 0 (a ragged last chunk is masked, and s < chunk is
    one chunk of s rows). Returns a contiguous (b, s, H, K) f32 tensor."""
    device = check_heads_layout(r, "r", None, torch.float32)
    b, s, H, K = r.shape
    for t, name in ((k, "k"), (v, "v"), (la, "la")):
        check_heads_layout(t, name, (b, s, H, K), torch.float32, device)
    expect(u, "u", torch.float32, (H, K), device)
    if K not in HEAD_SIZES or chunk not in CHUNKS:
        raise ValueError(f"head size {K} (takes {HEAD_SIZES}) or chunk "
                         f"{chunk} (takes {CHUNKS}) outside the kernel's "
                         f"limits")
    out = torch.empty((b, s, H, K), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = load("wkv6")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(),
            u.data_ptr(), out.data_ptr(), b, s, H, K, chunk,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *la.stride()[:3], stream)
    if err:
        msg = lib.wkv6_error_string(err).decode()
        raise RuntimeError(f"wkv6 launch failed: {msg} ({err})")
    wkv6.launches += 1
    return out


wkv6.launches = 0


def wkv6_bwd(r, k, v, la, u, do, *, chunk: int = 64):
    """The gradient of `wkv6`'s output from a zero state:
    `ref.wkv6_chunked_bwd_ref` on the card. r/k/v/la/do (b, s, H, K) f32
    on one CUDA device, laid out as `wkv6` takes them; u (H, K) f32,
    contiguous. Returns (dr, dk, dv, dla) contiguous (b, s, H, K) f32 and
    du (H, K) f32. Three kernels a call (the chunks' starting states into
    an f32 scratch of b·H·ceil(s / chunk)·K² elements, the reverse pass,
    the sum of du over the batch rows), counted as one launch; no atomics,
    so two calls give equal bits."""
    device = check_heads_layout(r, "r", None, torch.float32)
    b, s, H, K = r.shape
    for t, name in ((k, "k"), (v, "v"), (la, "la"), (do, "do")):
        check_heads_layout(t, name, (b, s, H, K), torch.float32, device)
    expect(u, "u", torch.float32, (H, K), device)
    if K not in HEAD_SIZES or chunk not in CHUNKS:
        raise ValueError(f"head size {K} (takes {HEAD_SIZES}) or chunk "
                         f"{chunk} (takes {CHUNKS}) outside the kernel's "
                         f"limits")
    grads = [torch.empty((b, s, H, K), dtype=torch.float32, device=device)
             for _ in range(4)]
    du = torch.empty((H, K), dtype=torch.float32, device=device)
    if grads[0].numel() == 0:
        return (*grads, du.zero_())
    n_chunks = -(-s // chunk)
    states = torch.empty((b, H, n_chunks, K, K), dtype=torch.float32,
                         device=device)
    part = torch.empty((b, H, K), dtype=torch.float32, device=device)
    lib = load("wkv6_bwd")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(),
            do.data_ptr(), u.data_ptr(), states.data_ptr(), part.data_ptr(),
            *(g.data_ptr() for g in grads), du.data_ptr(), b, s, H, K, chunk,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *la.stride()[:3], *do.stride()[:3], stream)
    if err:
        msg = lib.wkv6_bwd_error_string(err).decode()
        raise RuntimeError(f"wkv6_bwd launch failed: {msg} ({err})")
    wkv6_bwd.launches += 1
    return (*grads, du)


wkv6_bwd.launches = 0
