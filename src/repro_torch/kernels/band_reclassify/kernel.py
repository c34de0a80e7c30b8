"""Launch wrappers of the hand-written CUDA kernels in
`repro_torch/csrc/band_reclassify.cu`, the ports of the Pallas kernels in
`repro/kernels/band_reclassify/kernel.py`:

  * `multiview_band_reclassify` — k windows over one shared table;
  * `band_reclassify`           — one row-granular window (single view).

Each wrapper validates everything its kernel assumes, launches on the
current CUDA stream without synchronising, raises if the launch was
refused, and counts launches in `<wrapper>.launches`. `multiview_plan`
and `band_plan` pick each kernel's load width, lanes a row and grid;
`multiview_segments` states the multi-view kernel's walk over the union
of its windows.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import MAX_SMEM, cuda_device, expect
from repro_torch.kernels.dry import Cost

SMS = 132                           # streaming multiprocessors, H100 SXM
SM_SMEM = 233472                    # shared memory of an SM, bytes
BLOCK_SMEM_RESERVED = 1024          # ... taken by the runtime a block
MV_THREADS = 256                    # kMvThreads in band_reclassify.cu
MV_RESIDENT = 2                     # blocks an SM (its __launch_bounds__)
MV_MAX_VIEWS = 64                   # a segment's views are one uint64 mask
BAND_THREADS = 256                  # kBandThreads in band_reclassify.cu
BAND_RESIDENT = 2                   # blocks an SM (its __launch_bounds__)
MAX_LOADS = 8                       # chunks a lane loads before its fmafs
MAX_W_REGS = 32                     # floats of w a lane keeps in registers


class BandPlan(NamedTuple):
    chunk_bytes: int       # bytes of one load: 16, 8, 4, or 2 (bf16)
    lanes: int             # lanes sharing a row (a power of two, ≤ 256)
    loads_per_lane: int    # chunks a lane loads in one pass, before its fmafs
    passes: int            # passes over a row (1 but for very wide rows)
    rows_per_block: int    # rows a block takes at once: 256 / lanes
    grid: int              # blocks: at most one wave
    loops: int             # rounds of the grid over the band


@lru_cache(maxsize=4096)
def band_reclassify_cost(width: int, d: int, itemsize: int) -> Cost:
    """One call over a window of `width` rows: its rows of F read once, w
    and b read, an int8 label written a row; 2d FLOPs a row."""
    return Cost(2 * width * d, width * d * itemsize + width + d * 4 + 4)


def multiview_band_reclassify_cost(union_rows: int, window_rows: int,
                                   k: int, d: int, itemsize: int = 4
                                   ) -> Cost:
    """One call over k views' windows: the `union_rows` rows of F read
    once, an int8 label written for each of the Σ `window_rows`, W, b and
    the windows read; 2d FLOPs a window row."""
    return Cost(2 * window_rows * d,
                union_rows * d * itemsize + window_rows + k * d * 4 + k * 4
                + 2 * k * 4)


def band_plan(width: int, d: int, itemsize: int,
              address: int = 0) -> BandPlan:
    """The single-view kernel's layout for `width` rows of d elements of
    `itemsize` bytes in a table at a device address ≡ `address` (mod 16).
    A chunk is the widest load (≤ 16 bytes) dividing the row pitch and
    the address; a lane loads at most MAX_LOADS chunks and keeps at most
    MAX_W_REGS floats of w; `lanes` is the least power of two that covers
    a row so (up to a whole block); a grid of at most one wave of
    SMS × BAND_RESIDENT blocks covers the band, and a wider band loops.
    Chunk j of a row goes to lane j % lanes of its group, in that lane's
    pass j // (lanes · loads_per_lane)."""
    if width < 0 or d <= 0 or itemsize not in (2, 4):
        raise ValueError(f"no band plan for width={width} d={d} "
                         f"itemsize={itemsize}")
    row = d * itemsize
    chunk = 16
    while chunk > itemsize and (row % chunk or address % chunk):
        chunk //= 2
    per_chunk = chunk // itemsize
    loads = min(MAX_LOADS, MAX_W_REGS // per_chunk)
    need = -(-(d // per_chunk) // loads)          # lanes to cover a row
    lanes = 1
    while lanes < need and lanes < BAND_THREADS:
        lanes *= 2
    passes = -(-(d // per_chunk) // (lanes * loads))
    rows_per_block = BAND_THREADS // lanes
    grid = max(1, min(-(-width // rows_per_block), SMS * BAND_RESIDENT))
    loops = -(-width // (grid * rows_per_block))
    return BandPlan(chunk, lanes, loads, passes, rows_per_block, grid, loops)


class MultiviewPlan(NamedTuple):
    chunk_bytes: int       # bytes of one load of F: 16, 8 or 4
    lanes: int             # lanes sharing a row (a power of two, ≤ 256)
    loads_per_lane: int    # chunks a lane loads in one pass, before its fmafs
    passes: int            # passes over a row (1 but for very wide rows)
    rows_per_block: int    # rows a block takes at once: 256 / lanes
    grid: int              # blocks: at most one wave
    smem_bytes: int        # dynamic shared memory of a block


def _mv_smem(k: int, d: int) -> int:
    """`mv_smem_bytes` in band_reclassify.cu: W padded to 16 bytes, then
    2k uint64 masks, then 11k + 3 words (b, segments, windows, endpoints,
    counts)."""
    return -(-4 * k * d // 16) * 16 + 16 * k + 4 * (11 * k + 3)


@lru_cache(maxsize=4096)
def multiview_plan(k: int, d: int, cap: int, address: int = 0
                   ) -> MultiviewPlan:
    """The multi-view kernel's layout for k views of d f32 columns with
    windows of at most `cap` rows, over a table at a device address ≡
    `address` (mod 16); it reads no width, so it needs no host sync. A
    chunk is the widest load (≤ 16 bytes) dividing the row pitch and the
    address; a lane loads at most MAX_LOADS chunks a pass; `lanes` is the
    least power of two that covers a row so (up to a whole block); the
    grid is at most one wave of the blocks that fit an SM (W and the
    segments in shared memory), and no more than k · cap rows need.
    Raises past the kernel's limits: k > 64, or W and the segments past a
    block's shared memory."""
    if not 1 <= k <= MV_MAX_VIEWS or d <= 0 or cap <= 0:
        raise ValueError(f"no multi-view plan for k={k} d={d} cap={cap}: "
                         f"the kernel takes 1 to {MV_MAX_VIEWS} views")
    smem = _mv_smem(k, d)
    if smem > MAX_SMEM:
        raise ValueError(f"k={k} views of d={d}: W and the segments need "
                         f"{smem} bytes of shared memory, over {MAX_SMEM}")
    row = 4 * d
    chunk = 16
    while chunk > 4 and (row % chunk or address % chunk):
        chunk //= 2
    chunks = d // (chunk // 4)
    need = -(-chunks // MAX_LOADS)                # lanes to cover a row
    lanes = 1
    while lanes < need and lanes < MV_THREADS:
        lanes *= 2
    passes = -(-chunks // (lanes * MAX_LOADS))
    loads = min(MAX_LOADS, -(-chunks // lanes))
    rows_per_block = MV_THREADS // lanes
    resident = max(1, min(MV_RESIDENT,
                          SM_SMEM // (smem + BLOCK_SMEM_RESERVED)))
    grid = max(1, min(-(-k * cap // rows_per_block), SMS * resident))
    return MultiviewPlan(chunk, lanes, loads, passes, rows_per_block, grid,
                         smem)


def multiview_segments(lo, hi):
    """The union of windows [lo[v], hi[v]) cut where any window starts or
    ends, as the kernel's prologue builds it: [(start, length, mask)] in
    row order, `mask` bit v set where view v's window covers the segment;
    segments no window covers are dropped. The kernel walks the union as
    one flat range, segment after segment."""
    points = sorted({p for v in range(len(lo)) if hi[v] > lo[v]
                     for p in (lo[v], hi[v])})
    out = []
    for a, z in zip(points, points[1:]):
        mask = sum(1 << v for v in range(len(lo)) if lo[v] <= a < hi[v])
        if mask:
            out.append((a, z - a, mask))
    return out


def _raise_on(lib, err: int, what: str):
    if err:
        msg = lib.band_reclassify_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def multiview_band_reclassify(F, labels, W, b, start_blocks, widths, *,
                              cap: int, block_n: int):
    """Relabel, for each view v, rows [start_blocks[v]·block_n, +widths[v])
    of `labels` (k, n) int8 IN PLACE to sign(F·W[v] − b[v]) (z ≥ 0 → +1),
    in one pass over the union of the windows (`multiview_plan`).

    F (n, d) f32, W (k, d) f32, b (k,) f32, start_blocks / widths (k,)
    int32, all contiguous on one CUDA device; 1 ≤ k ≤ 64 and W must fit
    shared memory (raises otherwise, before anything runs). Windows must
    already be tile-aligned and capacity-clamped
    (`ops.multiview_band_reclassify` does that). Returns `labels`."""
    n, d = F.shape
    k = labels.shape[0]
    plan = multiview_plan(k, d, cap, F.data_ptr() % 16)   # limits first
    device = cuda_device(F)
    expect(F, "F", torch.float32, (n, d), device)
    expect(labels, "labels", torch.int8, (k, n), device)
    expect(W, "W", torch.float32, (k, d), device)
    expect(b, "b", torch.float32, (k,), device)
    expect(start_blocks, "start_blocks", torch.int32, (k,), device)
    expect(widths, "widths", torch.int32, (k,), device)
    if block_n <= 0 or cap % block_n or n % block_n or cap > n:
        raise ValueError(f"need 0 < block_n | cap <= n and block_n | n, got "
                         f"cap={cap} block_n={block_n} n={n}")
    if n >= 2 ** 31:
        raise ValueError(f"n={n} rows: the kernel indexes rows in int32")
    lib = load("band_reclassify")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mv_band_reclassify(
            F.data_ptr(), labels.data_ptr(), W.data_ptr(), b.data_ptr(),
            start_blocks.data_ptr(), widths.data_ptr(), n, d, k, block_n,
            plan.chunk_bytes, plan.lanes, plan.grid, plan.smem_bytes, stream)
    _raise_on(lib, err, "multiview_band_reclassify")
    multiview_band_reclassify.launches += 1
    return labels


def band_reclassify(F, labels, w, b, start_row: int, width: int):
    """Relabel rows [start_row, start_row + width) of `labels` (n,) int8 IN
    PLACE to sign(F·w − b) (z ≥ 0 → +1), accumulated in fp32.

    F (n, d) f32 or bf16, w (d,) f32, b () f32, all contiguous on one CUDA
    device; the window is given in rows, as host integers, and must lie
    inside the table. One launch (laid out by `band_plan`), also for an
    empty window. Returns `labels`."""
    device = cuda_device(F)
    n, d = F.shape
    expect(F, "F", (torch.float32, torch.bfloat16), (n, d), device)
    expect(labels, "labels", torch.int8, (n,), device)
    expect(w, "w", torch.float32, (d,), device)
    expect(b, "b", torch.float32, (), device)
    start_row, width = int(start_row), int(width)
    if start_row < 0 or width < 0 or start_row + width > n:
        raise ValueError(f"window [{start_row}, {start_row + width}) is not "
                         f"inside the table of {n} rows")
    plan = band_plan(width, d, F.element_size(), F.data_ptr() % 16)
    lib = load("band_reclassify")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.band_reclassify(
            F.data_ptr(), labels.data_ptr(), w.data_ptr(), b.data_ptr(),
            start_row, width, n, d, int(F.dtype == torch.bfloat16),
            plan.chunk_bytes, plan.lanes, plan.grid, stream)
    _raise_on(lib, err, "band_reclassify")
    band_reclassify.launches += 1
    return labels


multiview_band_reclassify.launches = 0
band_reclassify.launches = 0
