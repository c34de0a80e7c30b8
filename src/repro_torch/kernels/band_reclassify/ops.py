"""Public wrappers: align band windows to tile boundaries, clamp them, and
dispatch on the tensors' device — a CUDA tensor goes to the hand-written
kernel (or raises), a CPU tensor to the plain PyTorch version, any other
device raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.band_reclassify import kernel
from repro_torch.kernels.band_reclassify.ref import (
    band_reclassify_rows_ref, multiview_band_reclassify_ref)


def multiview_band_reclassify(F, labels, W, b, start_rows, end_rows, *,
                              cap: int = 4096, block_n: int = 512,
                              with_overflow: bool = False):
    """Relabel rows [start_rows[v], end_rows[v]) of the shared scratch
    table under each view's model (W[v], b[v]) in ONE kernel launch.
    `labels` (k, n) int8 is updated IN PLACE and returned.

    Each window start is aligned down to a `block_n` tile and clamped to
    n − cap; its width is clamped to `cap`. A view whose aligned window
    needs more than `cap` rows is truncated, leaving STALE labels past the
    capacity; `with_overflow=True` also returns the (k,) bool flag
    `requested > cap` so the driver can reorganize instead."""
    n, _ = F.shape
    dev = F.device
    start_rows = torch.as_tensor(start_rows, dtype=torch.int32, device=dev)
    end_rows = torch.as_tensor(end_rows, dtype=torch.int32, device=dev)
    start_blocks = torch.clamp(start_rows // block_n, 0,
                               max(0, (n - cap) // block_n))
    requested = end_rows - start_blocks * block_n
    widths = torch.clamp(requested, 0, cap)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        kernel.multiview_band_reclassify(F, labels, W, b32, start_blocks,
                                         widths, cap=cap, block_n=block_n)
    elif dev.type == "cpu":
        labels.copy_(multiview_band_reclassify_ref(
            F, labels, W, b32, start_blocks, widths, cap=cap,
            block_n=block_n))
    else:
        raise ValueError(f"no band_reclassify for device {dev}")
    if with_overflow:
        return labels, requested > cap
    return labels


def band_reclassify_rows(F, labels, w, b, start_row: int, width: int):
    """Relabel rows [start_row, start_row + width) of `labels` (n,) int8 IN
    PLACE under (w, b): the row-granular window of the single-view banded
    step. Returns `labels`."""
    dev = F.device
    w32 = torch.as_tensor(w, dtype=torch.float32, device=dev)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=dev).reshape(())
    if dev.type == "cuda":
        return kernel.band_reclassify(F, labels, w32, b32, start_row, width)
    if dev.type == "cpu":
        return labels.copy_(band_reclassify_rows_ref(F, labels, w32, b32,
                                                     start_row, width))
    raise ValueError(f"no band_reclassify for device {dev}")


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
