"""Public wrapper of eps_affine: dispatches on F's device — a CUDA tensor
goes to the hand-written kernel (or raises), a CPU tensor to the plain
PyTorch version, any other device raises. The TPU wrapper padded n and d
to its tiles; the CUDA kernel masks the ragged edge instead, so nothing
is padded here. A `meta` tensor launches nothing: the call returns empty
meta outputs and records its cost for the dry run (`kernels/dry.py`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import dry
from repro_torch.kernels.checks import served_device
from repro_torch.kernels.eps_affine import kernel
from repro_torch.kernels.eps_affine.ref import eps_affine_ref


def eps_affine(F, w, b):
    """(eps (n,) f32, labels (n,) int8, positive count () int32) for
    eps = F·w − b over every row of F (n, d) f32 or bf16. The reference's
    `block_n` has no counterpart: the CUDA kernel picks its own layout
    from d."""
    kind = served_device(F, "eps_affine")
    dev = F.device
    w32 = torch.as_tensor(w, dtype=torch.float32, device=dev)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=dev).reshape(())
    if kind == "meta":
        n, d = F.shape
        dry.record("eps_affine", kernel.eps_affine_cost(n, d,
                                                        F.element_size()))
        return (torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int8, device=dev),
                torch.empty((), dtype=torch.int32, device=dev))
    if kind == "cuda":
        return kernel.eps_affine(F, w32, b32)
    return eps_affine_ref(F, w32, b32)
