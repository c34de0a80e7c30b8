"""Public wrapper: aligns band windows to tile boundaries, clamps them, and
dispatches on the tensors' device — a CUDA tensor goes to the hand-written
kernel (or raises), a CPU tensor to the plain PyTorch version."""
from __future__ import annotations

import torch

from repro_torch.kernels.band_reclassify import kernel
from repro_torch.kernels.band_reclassify.ref import (
    multiview_band_reclassify_ref)


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
