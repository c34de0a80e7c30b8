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
from repro_torch.kernels.dry import Cost

HEAD_SIZES = (16, 32, 64)
CHUNKS = (16, 32, 64)
BWD_THREADS = 256              # `wkv6_bwd`'s blocks: 8 warps of one role
BWD_STATE_STAGES = 2           # its state pass's ring of k, v and la tiles


def _chunks(s: int, chunk: int):
    return [min(chunk, s - c0) for c0 in range(0, s, chunk)]


def wkv6_cost(b: int, s: int, H: int, K: int, chunk: int) -> Cost:
    """One forward call: four f32 inputs read once, the f32 output
    written once (u besides), and the work the function needs per (batch
    row, head, chunk of c rows): the inter-chunk and state products
    (2cK² each), the strictly lower triangle of the intra-chunk attention
    and its product with v (2K·c(c−1)/2 each), and the bonus (6cK)."""
    flops = sum(4 * c * K * K + 2 * K * c * (c - 1) + 6 * c * K
                for c in _chunks(s, chunk))
    return Cost(flops * b * H, 5 * b * s * H * K * 4 + H * K * 4)


def wkv6_bwd_cost(b: int, s: int, H: int, K: int, chunk: int) -> Cost:
    """One backward call: r, k, v, la and do read once and dr, dk, dv and
    dla written once (f32; u and du besides), and the work the function
    needs per (batch row, head, chunk of c rows): the chunk's starting
    state rebuilt (k_decᵀ·v), do·Sᵀ, v·dSᵀ, k_dec·dS and the carried
    r_inᵀ·do (2cK² each), the strictly lower att, datt, datt·k_f,
    dattᵀ·r_f and attᵀ·do (2K·c(c−1)/2 each), and some 40 elementwise
    operations an element. The state scratch the kernel writes and reads
    (b·H·ceil(s/c)·K² f32) is its own choice, not counted."""
    flops = sum(10 * c * K * K + 5 * K * c * (c - 1) + 40 * c * K
                for c in _chunks(s, chunk))
    return Cost(flops * b * H, 9 * b * s * H * K * 4 + 2 * H * K * 4)


def wkv6_bwd_plan(chunk: int, K: int) -> dict:
    """How `wkv6_bwd`'s two main kernels lay out a block at this chunk and
    head size, as `csrc/wkv6_bwd.cu` computes it (`Bwd`, `States`):
    threads a block, blocks an SM, and for each kernel its tiles (pitch in
    floats, rows, and the directions its mma fragments are read in, the
    first of them on 32 distinct banks), its shared-memory regions
    (offset, bytes) in order and their total `smem`."""
    if K not in HEAD_SIZES or chunk not in CHUNKS:
        raise ValueError(f"head size {K} (takes {HEAD_SIZES}) or chunk "
                         f"{chunk} (takes {CHUNKS}) outside the kernel's "
                         f"limits")
    pr, pc, pa, pd = K + 4, K + 8, chunk + 8, chunk + 4
    rows, cols, both, none = ("rows",), ("cols",), ("rows", "cols"), ()
    tiles = {"r": (pr, chunk, both), "k": (pr, chunk, both),
             "v": (pr, chunk, rows), "la": (pr, chunk, none),
             "do": (pr, chunk, both), "S": (pr, K, rows),
             "k_dec": (pr, chunk, rows), "r_in": (pc, chunk, cols),
             "dS": (pc, K, ("cols", "rows")), "att": (pa, chunk, cols),
             "datt": (pd, chunk, both)}
    sizes = [(name, (2 if name == "do" else 1) * p * n * 4)
             for name, (p, n, _) in tiles.items()]
    sizes += [("vectors", (2 * chunk + 6 * K) * 4), ("barriers", 7 * 8)]
    ps = K + 8
    st_tiles = {"k": (ps, chunk, cols), "v": (ps, chunk, cols),
                "la": (ps, chunk, none)}
    st_sizes = [("stages", BWD_STATE_STAGES * 3 * ps * chunk * 4),
                ("e_last", K * 4), ("barriers", 8 * BWD_STATE_STAGES)]

    def layout(named):
        regions, off = {}, 0
        for name, n in named:
            regions[name] = (off, n)
            off += n
        return regions, off

    def as_dicts(ts):
        return {name: dict(pitch=p, rows=n, reads=reads)
                for name, (p, n, reads) in ts.items()}

    regions, smem = layout(sizes)
    st_regions, st_smem = layout(st_sizes)
    return dict(threads=BWD_THREADS,
                reverse=dict(blocks_per_sm=1, tiles=as_dicts(tiles),
                             regions=regions, smem=smem),
                states=dict(blocks_per_sm=2, stages=BWD_STATE_STAGES,
                            tiles=as_dicts(st_tiles), regions=st_regions,
                            smem=st_smem))


def wkv6_bwd_scratch(b: int, s: int, H: int, K: int, chunk: int) -> dict:
    """Shapes of the f32 scratch `wkv6_bwd` hands its C entry: the state
    each chunk starts from, (b, H, ceil(s / chunk), K, K), and the blocks'
    du slots, (b, H, K)."""
    return dict(states=(b, H, -(-s // chunk), K, K), du_part=(b, H, K))


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
    the sum of du over the batch rows; `wkv6_bwd_scratch`,
    `wkv6_bwd_plan`), counted as one launch; no atomics, so two calls give
    equal bits."""
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
    scratch = wkv6_bwd_scratch(b, s, H, K, chunk)
    states = torch.empty(scratch["states"], dtype=torch.float32,
                         device=device)
    part = torch.empty(scratch["du_part"], dtype=torch.float32,
                       device=device)
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
