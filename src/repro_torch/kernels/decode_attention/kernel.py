"""Launch wrapper of the hand-written CUDA kernel `decode_attention`
(`repro_torch/csrc/decode_attention.cu`), the port of the Pallas kernel in
`repro/kernels/decode_attention/kernel.py`.

The wrapper validates what the kernel assumes (a cache of q's dtype, or
an f8 e4m3fn cache), picks the split of the cache rows for bf16
(`split_plan`, the same for either cache type), allocates the output and
the split workspace, launches on the current CUDA stream without
synchronising, raises if the launch was refused, and counts calls in
`decode_attention.launches`: one a call, whether the call runs the split
kernel alone or the split kernel and its combine. On a mesh whose cache
is split over its rows a call reads one rank's block (`row0`) and also
writes the logsumexp (`lse`) that the ranks' partial outputs are
combined by.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import check_heads_layout, expect
from repro_torch.kernels.dry import Cost

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16
TILE_ROWS = 64          # cache rows of a tile of the bf16 kernel
TARGET_BLOCKS = 264     # two blocks on each of 132 SMs, a single wave
MAX_SPLITS = 32         # the combine kernel's limit (kMaxSplits)
MIN_SPLIT_ROWS = 128    # a split reads at least two tiles, when it can
F8 = torch.float8_e4m3fn   # the one 8-bit cache type the kernel reads


def decode_attention_cost(b: int, nkv: int, group: int, hd: int, n: int,
                          itemsize: int, kv_itemsize: int,
                          lse: bool = False) -> Cost:
    """One call over n valid cache rows: q and the output (b, nkv, group,
    hd) moved once each, the n rows of k and v read once at the cache's
    element size (1 for an f8 cache), and with `lse` the f32 logsumexp
    (b, nkv, group) written; 4·hd FLOPs a (q head, row) pair. n = 0 (a
    block wholly after the index) moves and computes nothing."""
    if n <= 0:
        return Cost(0, 0)
    q_elems = b * nkv * group * hd
    nbytes = 2 * q_elems * itemsize + 2 * b * n * nkv * hd * kv_itemsize
    if lse:
        nbytes += b * nkv * group * 4
    return Cost(4 * b * nkv * group * n * hd, nbytes)


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


def decode_attention(q, k, v, cache_index: int, with_lse: bool = False,
                     row0=None):
    """One query token per sequence. q (b, nkv, group, hd) contiguous;
    k/v (b, S, nkv, hd) of q's dtype (f32 or bf16) or both f8 e4m3fn,
    with a unit stride on hd and 16-byte aligned rows; `cache_index` a
    host int in [0, S): rows 0..cache_index are read, the rest is never
    touched. Returns a contiguous (b, nkv, group, hd) tensor of q's dtype.
    bf16 runs the split-KV kernel (and its combine when there is more than
    one split), f32 the CUDA-core kernel; either widens an f8 cache tile
    by tile as it reads it (exactly: every e4m3 value is a bf16 value), so
    an f8 cache gives the bits of its dequantized copy under the same
    split plan.

    `with_lse` returns (out, lse): lse, a contiguous f32 (b, nkv, group)
    tensor, holds each q head's logsumexp of its scaled logits over the
    rows read (written by the kernel that ends the call: the split kernel
    at one split, the combine at several, the f32 kernel); without it the
    path is as it was.
    `row0` says the cache is one rank's block of the rows [row0, row0 +
    S) of a longer one: rows up to global position `cache_index` are read
    (all S of them when the index lies past the block). A block that lies
    wholly after the index launches nothing and gives out = 0 and
    lse = −inf, the exact value of attending to no rows."""
    device = check_heads_layout(q, "q", None)
    b, nkv, group, hd = q.shape
    expect(q, "q", q.dtype, (b, nkv, group, hd), device)
    S = k.shape[1]
    kv_dtype = F8 if k.dtype == F8 else q.dtype
    check_heads_layout(k, "k", (b, S, nkv, hd), kv_dtype, device)
    check_heads_layout(v, "v", (b, S, nkv, hd), kv_dtype, device)
    if hd not in HEAD_DIMS or not 1 <= group <= MAX_GROUP:
        raise ValueError(f"head_dim {hd} (takes {HEAD_DIMS}) or group "
                         f"{group} (takes 1..{MAX_GROUP}) outside the "
                         f"kernel's limits")
    if row0 is None:
        if not 0 <= cache_index < S:
            raise ValueError(f"cache_index {cache_index} outside [0, {S})")
        n = cache_index + 1
    else:
        if row0 < 0 or cache_index < 0:
            raise ValueError(f"row0 {row0} or cache_index {cache_index} "
                             "below 0")
        n = min(cache_index - row0 + 1, S)
    out = torch.empty_like(q)
    lse = (torch.empty((b, nkv, group), dtype=torch.float32, device=device)
           if with_lse else None)
    if n <= 0 or out.numel() == 0:
        out.zero_()
        if with_lse:
            lse.fill_(float("-inf"))
            return out, lse
        return out
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
            None if ws is None else ws.data_ptr(),
            None if lse is None else lse.data_ptr(), b, nkv, group, hd, n,
            rows, n_splits, *k.stride()[:3], *v.stride()[:3], hd ** -0.5,
            int(bf16), int(kv_dtype == F8), stream)
    if err:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} ({err})")
    decode_attention.launches += 1
    return (out, lse) if with_lse else out


decode_attention.launches = 0
