"""Launch wrapper of the hand-written CUDA kernel `decode_attention`
(`repro_torch/csrc/decode_attention.cu`), the port of the Pallas kernel in
`repro/kernels/decode_attention/kernel.py`.

The wrapper validates what the kernel assumes, picks the split of the
cache rows for bf16 (`split_plan`), allocates the output and the split
workspace, launches on the current CUDA stream without synchronising,
raises if the launch was refused, and counts calls in
`decode_attention.launches`: one a call, whether the call runs the split
kernel alone or the split kernel and its combine.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import check_heads_layout, expect

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16
TILE_ROWS = 64          # cache rows of a tile of the bf16 kernel
TARGET_BLOCKS = 264     # two blocks on each of 132 SMs, a single wave
MAX_SPLITS = 32         # the combine kernel's limit (kMaxSplits)
MIN_SPLIT_ROWS = 128    # a split reads at least two tiles, when it can


def split_plan(n: int, pairs: int) -> tuple[int, int]:
    """(n_splits, rows_per_split) for n valid cache rows of each of
    `pairs` (batch row, kv head) pairs: as many splits as keep pairs ·
    n_splits within TARGET_BLOCKS (one at least), at most MAX_SPLITS and
    no more than n / MIN_SPLIT_ROWS (rounded up); the rows of a split a
    multiple of TILE_ROWS. Split s takes rows [s · rows, min((s + 1) ·
    rows, n)), and none is empty. Past a single wave more splits only add
    blocks and their combine: a block keeps two or three 64-row tiles of
    loads in flight, so some 132 of them already saturate device
    memory."""
    want = max(1, min(MAX_SPLITS, TARGET_BLOCKS // pairs,
                      -(-n // MIN_SPLIT_ROWS)))
    rows = -(-n // want)
    rows = -(-rows // TILE_ROWS) * TILE_ROWS
    return -(-n // rows), rows


def decode_attention(q, k, v, cache_index: int):
    """One query token per sequence. q (b, nkv, group, hd) contiguous;
    k/v (b, S, nkv, hd) of q's dtype (f32 or bf16) with a unit stride on
    hd and 16-byte aligned rows; `cache_index` a host int in [0, S): rows
    0..cache_index are read, the rest is never touched. Returns a
    contiguous (b, nkv, group, hd) tensor of q's dtype. bf16 runs the
    split-KV kernel (and its combine when there is more than one split),
    f32 the CUDA-core kernel."""
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
    n = cache_index + 1
    bf16 = q.dtype == torch.bfloat16
    n_splits, rows = split_plan(n, b * nkv) if bf16 else (1, n)
    ws = None
    if n_splits > 1:                    # acc, then m and l, of each split
        ws = torch.empty(b * nkv * n_splits * group * (hd + 2),
                         dtype=torch.float32, device=device)
    lib = load("decode_attention")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), b, nkv, group, hd, n,
            rows, n_splits, *k.stride()[:3], *v.stride()[:3], hd ** -0.5,
            int(bf16), stream)
    if err:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} ({err})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
