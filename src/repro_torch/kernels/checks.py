"""Argument checks shared by the kernels' launch wrappers: a kernel takes
exactly the tensors it was written for, or the wrapper raises."""
from __future__ import annotations

import torch

MAX_SMEM = 232448                  # bytes of shared memory a block can use


def cuda_device(F) -> torch.device:
    """The CUDA device of the 2-D table F; raises for anything else."""
    if not isinstance(F, torch.Tensor) or F.dim() != 2:
        raise ValueError("F must be a 2-D torch.Tensor")
    if F.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {F.device}")
    return F.device


def expect(t, name, dtype, shape, device):
    """Raise unless `t` is a contiguous tensor of `dtype` (or one of a
    tuple of dtypes) and `shape` on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
