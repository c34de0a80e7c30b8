"""Launch wrapper of the hand-written CUDA kernel `multiview_band_reclassify`
(`repro_torch/csrc/band_reclassify.cu`), the port of the Pallas kernel in
`repro/kernels/band_reclassify/kernel.py`.

The wrapper validates everything the kernel assumes, launches on the
current CUDA stream without synchronising, raises if the launch was
refused, and counts launches in `multiview_band_reclassify.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load

_MAX_VIEWS = 65535                  # grid.y limit
_MAX_SMEM = 232448                  # bytes of shared memory per block


def _expect(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def multiview_band_reclassify(F, labels, W, b, start_blocks, widths, *,
                              cap: int, block_n: int):
    """Relabel, for each view v, rows [start_blocks[v]·block_n, +widths[v])
    of `labels` (k, n) int8 IN PLACE to sign(F·W[v] − b[v]) (z ≥ 0 → +1).

    F (n, d) f32, W (k, d) f32, b (k,) f32, start_blocks / widths (k,)
    int32, all contiguous on one CUDA device. Windows must already be
    tile-aligned and capacity-clamped (`ops.multiview_band_reclassify`
    does that). Returns `labels`."""
    if not isinstance(F, torch.Tensor) or F.dim() != 2:
        raise ValueError("F must be a 2-D torch.Tensor")
    device = F.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")
    n, d = F.shape
    k = labels.shape[0] if isinstance(labels, torch.Tensor) else -1
    _expect(F, "F", torch.float32, (n, d), device)
    _expect(labels, "labels", torch.int8, (k, n), device)
    _expect(W, "W", torch.float32, (k, d), device)
    _expect(b, "b", torch.float32, (k,), device)
    _expect(start_blocks, "start_blocks", torch.int32, (k,), device)
    _expect(widths, "widths", torch.int32, (k,), device)
    if block_n <= 0 or cap <= 0 or cap % block_n or n % block_n or cap > n:
        raise ValueError(f"need 0 < block_n | cap <= n and block_n | n, got "
                         f"cap={cap} block_n={block_n} n={n}")
    if k > _MAX_VIEWS or 4 * d > _MAX_SMEM:
        raise ValueError(f"k={k}, d={d} exceed the kernel's launch limits")
    lib = load("band_reclassify")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mv_band_reclassify(
            F.data_ptr(), labels.data_ptr(), W.data_ptr(), b.data_ptr(),
            start_blocks.data_ptr(), widths.data_ptr(), n, d, k, cap,
            block_n, stream)
    if err:
        msg = lib.band_reclassify_error_string(err).decode()
        raise RuntimeError(f"multiview_band_reclassify launch failed: "
                           f"{msg} ({err})")
    multiview_band_reclassify.launches += 1
    return labels


multiview_band_reclassify.launches = 0
