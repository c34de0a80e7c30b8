"""Launch wrappers of the hand-written CUDA kernels in
`repro_torch/csrc/band_reclassify.cu`, the ports of the Pallas kernels in
`repro/kernels/band_reclassify/kernel.py`:

  * `multiview_band_reclassify` — k windows over one shared table;
  * `band_reclassify`           — one row-granular window (single view).

Each wrapper validates everything its kernel assumes, launches on the
current CUDA stream without synchronising, raises if the launch was
refused, and counts launches in `<wrapper>.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import MAX_SMEM, cuda_device, expect

_MAX_VIEWS = 65535                  # grid.y limit


def _raise_on(lib, err: int, what: str):
    if err:
        msg = lib.band_reclassify_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def multiview_band_reclassify(F, labels, W, b, start_blocks, widths, *,
                              cap: int, block_n: int):
    """Relabel, for each view v, rows [start_blocks[v]·block_n, +widths[v])
    of `labels` (k, n) int8 IN PLACE to sign(F·W[v] − b[v]) (z ≥ 0 → +1).

    F (n, d) f32, W (k, d) f32, b (k,) f32, start_blocks / widths (k,)
    int32, all contiguous on one CUDA device. Windows must already be
    tile-aligned and capacity-clamped (`ops.multiview_band_reclassify`
    does that). Returns `labels`."""
    device = cuda_device(F)
    n, d = F.shape
    k = labels.shape[0] if isinstance(labels, torch.Tensor) else -1
    expect(F, "F", torch.float32, (n, d), device)
    expect(labels, "labels", torch.int8, (k, n), device)
    expect(W, "W", torch.float32, (k, d), device)
    expect(b, "b", torch.float32, (k,), device)
    expect(start_blocks, "start_blocks", torch.int32, (k,), device)
    expect(widths, "widths", torch.int32, (k,), device)
    if block_n <= 0 or cap <= 0 or cap % block_n or n % block_n or cap > n:
        raise ValueError(f"need 0 < block_n | cap <= n and block_n | n, got "
                         f"cap={cap} block_n={block_n} n={n}")
    if k > _MAX_VIEWS or 4 * d > MAX_SMEM:
        raise ValueError(f"k={k}, d={d} exceed the kernel's launch limits")
    lib = load("band_reclassify")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mv_band_reclassify(
            F.data_ptr(), labels.data_ptr(), W.data_ptr(), b.data_ptr(),
            start_blocks.data_ptr(), widths.data_ptr(), n, d, k, cap,
            block_n, stream)
    _raise_on(lib, err, "multiview_band_reclassify")
    multiview_band_reclassify.launches += 1
    return labels


def band_reclassify(F, labels, w, b, start_row: int, width: int):
    """Relabel rows [start_row, start_row + width) of `labels` (n,) int8 IN
    PLACE to sign(F·w − b) (z ≥ 0 → +1), accumulated in fp32.

    F (n, d) f32 or bf16, w (d,) f32, b () f32, all contiguous on one CUDA
    device; the window is given in rows, as host integers, and must lie
    inside the table. One launch, also for an empty window. Returns
    `labels`."""
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
    if d == 0 or 4 * d > MAX_SMEM:
        raise ValueError(f"d={d} is outside the kernel's launch limits")
    lib = load("band_reclassify")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.band_reclassify(
            F.data_ptr(), labels.data_ptr(), w.data_ptr(), b.data_ptr(),
            start_row, width, n, d, int(F.dtype == torch.bfloat16), stream)
    _raise_on(lib, err, "band_reclassify")
    band_reclassify.launches += 1
    return labels


multiview_band_reclassify.launches = 0
band_reclassify.launches = 0
