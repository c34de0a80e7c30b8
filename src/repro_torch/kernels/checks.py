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


def check_heads_layout(t, name, shape, dtype=None, device=None):
    """Raise unless `t` is a 4-D (b, s, heads, hd) CUDA tensor of `dtype`
    (f32 or bf16 where not given; the decode kernel also takes an f8
    cache) and of `shape` and `device` where given, whose hd axis has unit
    stride and whose rows start on 16-byte boundaries, the layout the
    attention kernels read with 16-byte loads. Returns its device."""
    if not isinstance(t, torch.Tensor) or t.dim() != 4:
        raise ValueError(f"{name} must be a 4-D torch.Tensor")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} is on {t.device}, expected "
                         f"{device or 'a CUDA device'}")
    if t.dtype not in ((torch.float32, torch.bfloat16) if dtype is None
                       else (dtype,)):
        raise TypeError(f"{name} must be {dtype or 'float32 or bfloat16'}, "
                        f"got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    size = t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(st * size % 16 for st in t.stride()[:3])):
        raise ValueError(f"{name} needs a unit stride on head_dim and "
                         f"16-byte aligned rows, got strides {t.stride()}")
    return t.device


def check_no_grad(name, *tensors):
    """Raise where autograd would need the gradient of a kernel that has
    no backward: grad mode on and any input requiring grad. The kernel's
    output is written over ctypes and carries no `grad_fn`, so without this
    the inputs would silently get no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward kernel: call it under "
                           f"torch.no_grad() or on inputs that do not "
                           f"require grad")
