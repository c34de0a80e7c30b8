"""Public wrappers: align band windows to tile boundaries, clamp them, and
dispatch on the tensors' device — a CUDA tensor goes to the hand-written
kernel (or raises), a CPU tensor to the plain PyTorch version, any other
device raises. A `meta` tensor launches nothing: the call records its
cost for the dry run (`kernels/dry.py`) and returns the labels as they
were."""
from __future__ import annotations

import torch

from repro_torch.kernels import dry
from repro_torch.kernels.band_reclassify import kernel
from repro_torch.kernels.band_reclassify.ref import (
    band_reclassify_rows_ref, multiview_band_reclassify_ref)
from repro_torch.kernels.checks import served_device


def multiview_band_reclassify(F, labels, W, b, start_rows, end_rows, *,
                              cap: int = 4096, block_n: int = 512,
                              with_overflow: bool = False,
                              with_windows: bool = False):
    """Relabel rows [start_rows[v], end_rows[v]) of the shared scratch
    table under each view's model (W[v], b[v]) in ONE kernel launch.
    `labels` (k, n) int8 is updated IN PLACE and returned.

    Each window start is aligned down to a `block_n` tile and clamped to
    n − cap; its width is clamped to `cap`. A view whose aligned window
    needs more than `cap` rows is truncated, leaving STALE labels past the
    capacity; `with_overflow=True` also returns the (k,) bool flag
    `requested > cap` so the driver can reorganize instead, and
    `with_windows=True` the windows the launch was given, as the pair
    ((k,) int32 start blocks, (k,) int32 widths), after the flag."""
    kind = served_device(F, "band_reclassify")
    n, _ = F.shape
    dev = F.device
    start_rows = torch.as_tensor(start_rows, dtype=torch.int32, device=dev)
    end_rows = torch.as_tensor(end_rows, dtype=torch.int32, device=dev)
    start_blocks = torch.clamp(start_rows // block_n, 0,
                               max(0, (n - cap) // block_n))
    requested = end_rows - start_blocks * block_n
    widths = torch.clamp(requested, 0, cap)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
    if kind == "meta":
        # the windows' widths are data: counted at their bound, cap rows
        # a view (the union at most n)
        k, d = W.shape
        dry.record("multiview_band_reclassify",
                   kernel.multiview_band_reclassify_cost(
                       min(n, k * cap), k * cap, k, d, F.element_size()))
    elif kind == "cuda":
        kernel.multiview_band_reclassify(F, labels, W, b32, start_blocks,
                                         widths, cap=cap, block_n=block_n)
    else:
        labels.copy_(multiview_band_reclassify_ref(
            F, labels, W, b32, start_blocks, widths, cap=cap,
            block_n=block_n))
    out = (labels,)
    if with_overflow:
        out += (requested > cap,)
    if with_windows:
        out += ((start_blocks, widths),)
    return out if len(out) > 1 else labels


def window_union_rows(start_blocks, widths, block_n: int) -> int:
    """Rows of the union of the windows [start_blocks[v]·block_n,
    + widths[v]) (host integers): the rows one multi-view launch reads."""
    rows = end = 0
    for lo, hi in sorted((s * block_n, s * block_n + w)
                         for s, w in zip(start_blocks, widths) if w > 0):
        rows += max(0, hi - max(lo, end))
        end = max(end, hi)
    return rows


def band_reclassify_rows(F, labels, w, b, start_row: int, width: int):
    """Relabel rows [start_row, start_row + width) of `labels` (n,) int8 IN
    PLACE under (w, b): the row-granular window of the single-view banded
    step. Returns `labels`."""
    kind = served_device(F, "band_reclassify")
    dev = F.device
    w32 = torch.as_tensor(w, dtype=torch.float32, device=dev)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=dev).reshape(())
    if kind == "meta":
        dry.record("band_reclassify", kernel.band_reclassify_cost(
            width, F.shape[1], F.element_size()))
        return labels
    if kind == "cuda":
        return kernel.band_reclassify(F, labels, w32, b32, start_row, width)
    return labels.copy_(band_reclassify_rows_ref(F, labels, w32, b32,
                                                 start_row, width))


def band_reclassify(F_sorted, labels, w, b, start_row, end_row, *,
                    cap: int = 4096, block_n: int = 512):
    """Relabel rows [start_row, end_row) of the eps-sorted table under
    (w, b), with the reference wrapper's window arithmetic: the start is
    aligned down to a `block_n` tile and clamped to n − cap, the width
    clamped to `cap` (rows past it keep their labels; the caller must keep
    end_row − aligned start ≤ cap). `labels` (n,) int8 is updated IN
    PLACE and returned."""
    n, _ = F_sorted.shape
    start_block = min(max(int(start_row) // block_n, 0),
                      max(0, (n - cap) // block_n))
    width = min(max(int(end_row) - start_block * block_n, 0), cap)
    return band_reclassify_rows(F_sorted, labels, w, b,
                                start_block * block_n, width)
