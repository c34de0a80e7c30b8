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
from repro_torch.kernels.dry import Cost

HEAD_DIMS = (16, 32, 64, 128)
# The backward's TMA + wgmma kernels (`csrc/flash_attention_bwd.cu`, bf16
# at these head dims): a block owns BWD_TILE rows and streams the other
# side BWD_STEP rows a step through BWD_STAGES ring stages of TMA boxes of
# 64 rows x 128 bytes; 1 KB of slack aligns the base to the swizzle atom.
BWD_WGMMA_HEAD_DIMS = (64, 128)
BWD_TILE, BWD_STEP, BWD_STAGES = 128, 64, 4
_BOX_BYTES = 64 * 128


def _causal_pairs(b: int, s: int, nq: int) -> int:
    """(query, key) pairs of causal attention: b · nq · s(s + 1)/2."""
    return b * nq * s * (s + 1) // 2


def flash_attention_cost(b: int, s: int, nq: int, nkv: int, hd: int,
                         itemsize: int, lse: bool = False) -> Cost:
    """One forward call: q and the output (b, s, nq, hd) and k and v
    (b, s, nkv, hd) moved once each (and the f32 logsumexp (b, nq, s)
    with `lse`); 4·hd FLOPs a causal (query, key) pair (q·k and p·v)."""
    nbytes = (2 * b * s * nq * hd + 2 * b * s * nkv * hd) * itemsize
    if lse:
        nbytes += b * nq * s * 4
    return Cost(4 * _causal_pairs(b, s, nq) * hd, nbytes)


def flash_attention_bwd_cost(b: int, s: int, nq: int, nkv: int, hd: int,
                             itemsize: int) -> Cost:
    """One backward call: q, o, do and dq, and k, v, dk and dv moved once
    each, the f32 logsumexp read; 10·hd FLOPs a causal pair (S, dP, dV,
    dK and dQ: 2.5 times the forward's)."""
    nbytes = (4 * b * s * nq * hd + 4 * b * s * nkv * hd) * itemsize \
        + b * nq * s * 4
    return Cost(10 * _causal_pairs(b, s, nq) * hd, nbytes)


def flash_bwd_plan(b: int, s: int, nq: int, nkv: int, hd: int,
                   dtype: torch.dtype) -> dict:
    """How `flash_attention_bwd` launches at this shape, as the C entry
    computes it: `route` ("wgmma" for bf16 at head dims 64 and 128, else
    "mma.sync" for bf16 or "cuda cores" for f32), `scratch`, the shape of
    the f32 buffer the wrapper hands it, and on the wgmma route the padded
    row length `s_pad`, each kernel's shared-memory bytes `smem` and block
    counts (one block a work item, in `flash_bwd_items`' order)."""
    if dtype != torch.bfloat16 or hd not in BWD_WGMMA_HEAD_DIMS:
        route = "mma.sync" if dtype == torch.bfloat16 else "cuda cores"
        return dict(route=route, scratch=(b, nq, s))
    tiles = -(-s // BWD_TILE)
    s_pad = tiles * BWD_TILE
    step_bytes = hd // 64 * _BOX_BYTES     # 64 rows of hd bf16
    rows_bytes = 2 * BWD_STEP * 4          # a step's lse·log2e and D rows
    smem = (2 * (2 * step_bytes)           # two owned 128-row tiles
            + BWD_STAGES * (2 * step_bytes + rows_bytes)
            + (2 * BWD_STAGES + 1) * 8 + 1024)
    return dict(route="wgmma", scratch=(2, b, nq, s_pad), s_pad=s_pad,
                smem=smem, dkdv_blocks=tiles * nkv * b,
                dq_blocks=tiles * nq * b)


def flash_bwd_items(kind: str, b: int, s: int, nq: int, nkv: int) -> list:
    """The wgmma backward's work items in launch order (block i takes
    item i), as the kernels decode blockIdx.x: for "dkdv" (kv tile, batch
    row, kv head), the kv tiles nearest position 0 first; for "dq" (q
    tile, batch row, q head), the last q tiles first, the q heads of one
    kv group side by side. Each is paired with its steps, the 64-row tiles
    of the other side it loops over (at head dim 128 the dK/dV kernel
    loops over them twice, for dV and then dK)."""
    tiles = -(-s // BWD_TILE)
    steps = -(-s // BWD_STEP)
    group = nq // nkv
    if kind == "dkdv":
        n = tiles * nkv * b
        return [((i // (b * nkv), (i // nkv) % b, i % nkv),
                 group * (steps - i // (b * nkv) * BWD_TILE // BWD_STEP))
                for i in range(n)]
    if kind == "dq":
        n = tiles * nq * b
        return [((tiles - 1 - i // (b * nq), (i // nq) % b, i % nq),
                 min(2 * (tiles - i // (b * nq)), steps)) for i in range(n)]
    raise ValueError(f"kind {kind!r}: 'dkdv' or 'dq'")


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
    and dQ; on TMA and wgmma in bf16 at head dims 64 and 128, see
    `flash_bwd_plan`); the call counts once."""
    device, b, s, nq, nkv, hd = _check_heads(q, k, v)
    expect(o, "o", q.dtype, (b, s, nq, hd), device)
    expect(lse, "lse", torch.float32, (b, nq, s), device)
    check_heads_layout(do, "do", (b, s, nq, hd), q.dtype, device)
    dq = torch.empty((b, s, nq, hd), dtype=q.dtype, device=device)
    dk = torch.empty((b, s, nkv, hd), dtype=q.dtype, device=device)
    dv = torch.empty((b, s, nkv, hd), dtype=q.dtype, device=device)
    if dq.numel() == 0:
        return dq, dk, dv
    scratch = flash_bwd_plan(b, s, nq, nkv, hd, q.dtype)["scratch"]
    delta = torch.empty(scratch, dtype=torch.float32, device=device)
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


def flash_bwd_wgmma_calls() -> int:
    """How many `flash_attention_bwd` calls in this process launched the
    TMA + wgmma kernels (bf16 at head dims 64 and 128), as the C library
    counts them: the evidence that a call took that route."""
    return int(load("flash_attention_bwd").flash_attention_bwd_wgmma_calls())
