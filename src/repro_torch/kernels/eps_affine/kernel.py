"""Launch wrapper of the hand-written CUDA kernel `eps_affine`
(`repro_torch/csrc/eps_affine.cu`), the port of the Pallas kernel in
`repro/kernels/eps_affine/kernel.py`.

`tile_plan` cuts the table into tiles of whole rows, each one bulk copy
into a ring of shared-memory stages, and sizes the persistent grid. The
wrapper validates everything the kernel assumes, allocates the three
outputs (the count's ticket and per-block slots are kept per stream),
launches on the current CUDA stream without synchronising, raises if the launch was refused, and
counts launches in `eps_affine.launches`.
"""
from __future__ import annotations

from functools import lru_cache
from math import gcd
from typing import NamedTuple

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import MAX_SMEM, cuda_device, expect

SMS = 132                 # streaming multiprocessors of an H100 SXM
TILE_TARGET = 32768       # bytes of a tile, roughly
STAGES = 2                # ring stages (eps_affine.cu takes up to 8)
RING_BUDGET = 114688      # ring + w of a block when two share an SM
COPY_ALIGN = 16           # a bulk copy's offset and size, in bytes
STATIC_SMEM = 1024        # the kernel's own barriers and counts, rounded up
MAX_GRID = 1024           # kMaxGrid in eps_affine.cu: count slots kept


class TilePlan(NamedTuple):
    rows_per_tile: int    # R: rows of one tile, one bulk copy
    stages: int           # ring stages
    grid: int             # persistent blocks
    tail: int             # rows past the last whole tile
    tiles: int            # whole tiles, walked by block i as i, i + grid, ...
    lanes: int            # lanes sharing a row's dot
    chunk_bytes: int      # bytes a lane reads at once from a tile's row
    tile_bytes: int
    smem_bytes: int       # dynamic shared memory: the ring, then w (f32)
    blocks_per_sm: int


@lru_cache(maxsize=64)
def tile_plan(n: int, d: int, itemsize: int, sms: int = SMS,
              aligned: bool = True) -> TilePlan:
    """The tiling of an (n, d) table of `itemsize`-byte elements. R is the
    smallest row count whose tile is a multiple of 16 bytes, scaled up to
    about TILE_TARGET bytes; STAGES stages with two blocks an SM, else
    with one (two 32 KB stages and two blocks an SM were the fastest of
    8-64 KB tiles, 2-8 stages and 1-4 blocks an SM on an H100, PERF.md);
    a grid of one or two blocks an SM and no more than there are tiles;
    4 to 32 lanes a row, from the row's width in chunks (16 bytes where
    the pitch allows, else one element; the tail is read an element at a
    time). Where the table's base is not 16-byte aligned (`aligned`
    False) no tile is copied: every row is read with ordinary loads, over
    the same grid. Raises where two stages and w do not fit in a block's
    shared memory."""
    if n < 0 or d <= 0 or itemsize not in (2, 4):
        raise ValueError(f"no tile plan for n={n} d={d} itemsize={itemsize}")
    row = d * itemsize
    r0 = COPY_ALIGN // gcd(row, COPY_ALIGN)
    rows = r0 * max(1, TILE_TARGET // (r0 * row))
    tile = rows * row
    w_bytes = 4 * d
    for blocks, budget in ((2, RING_BUDGET), (1, MAX_SMEM - STATIC_SMEM)):
        if STAGES * tile + w_bytes <= budget:
            break
    else:
        raise ValueError(f"d={d}: two stages of {tile} bytes and w exceed "
                         f"the {MAX_SMEM} bytes of a block's shared memory")
    tiles = n // rows if aligned else 0
    grid = max(1, min(blocks * sms, tiles if aligned else -(-n // rows)))
    chunk = COPY_ALIGN if row % COPY_ALIGN == 0 else itemsize
    chunks = row // chunk
    lanes = next(k for k, at in ((32, 128), (16, 64), (8, 16), (4, 0))
                 if chunks >= at)
    return TilePlan(rows, STAGES, grid, n - tiles * rows, tiles, lanes,
                    chunk, tile, STAGES * tile + w_bytes, blocks)


_scratch: dict = {}


def _count_scratch(device, stream) -> torch.Tensor:
    """The count's scratch on (device, stream), made zeroed once: [0] is
    the blocks' arrival ticket, which each launch leaves at 0 again, and
    [1:] a slot per block (calls on one stream run in turn, so they can
    share the slots)."""
    key = (device.index, stream)
    t = _scratch.get(key)
    if t is None:
        t = _scratch[key] = torch.zeros(1 + MAX_GRID, dtype=torch.int32,
                                        device=device)
    return t


def eps_affine(F, w, b):
    """eps = F·w − b (n,) f32 with an fp32 accumulator, labels (n,) int8
    (eps ≥ 0 → +1) and the positive count, a () int32 tensor left on the
    device (reading it is the caller's sync, not the kernel's).

    F (n, d) f32 or bf16, w (d,) f32, b () f32, all contiguous on one CUDA
    device; d up to what `tile_plan` fits in shared memory."""
    device = cuda_device(F)
    n, d = F.shape
    expect(F, "F", (torch.float32, torch.bfloat16), (n, d), device)
    expect(w, "w", torch.float32, (d,), device)
    expect(b, "b", torch.float32, (), device)
    plan = tile_plan(n, d, F.element_size(),
                     aligned=F.data_ptr() % COPY_ALIGN == 0)
    eps = torch.empty(n, dtype=torch.float32, device=device)
    labels = torch.empty(n, dtype=torch.int8, device=device)
    count = torch.empty((), dtype=torch.int32, device=device)
    lib = load("eps_affine")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        scratch = _count_scratch(device, stream).data_ptr()
        err = lib.eps_affine(
            F.data_ptr(), w.data_ptr(), b.data_ptr(), eps.data_ptr(),
            labels.data_ptr(), count.data_ptr(), scratch + 4, scratch, n, d,
            int(F.dtype == torch.bfloat16), plan.rows_per_tile, plan.stages,
            plan.grid, plan.lanes, stream)
    if err:
        msg = lib.eps_affine_error_string(err).decode()
        raise RuntimeError(f"eps_affine launch failed: {msg} ({err})")
    eps_affine.launches += 1
    return eps, labels, count


eps_affine.launches = 0
