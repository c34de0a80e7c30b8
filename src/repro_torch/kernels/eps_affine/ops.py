"""Public wrapper of eps_affine: dispatches on F's device — a CUDA tensor
goes to the hand-written kernel (or raises), a CPU tensor to the plain
PyTorch version, any other device raises. The TPU wrapper padded n and d
to its tiles; the CUDA kernel masks the ragged edge instead, so nothing
is padded here."""
from __future__ import annotations

import torch

from repro_torch.kernels.eps_affine import kernel
from repro_torch.kernels.eps_affine.ref import eps_affine_ref


def eps_affine(F, w, b):
    """(eps (n,) f32, labels (n,) int8, positive count () int32) for
    eps = F·w − b over every row of F (n, d) f32 or bf16. The reference's
    `block_n` has no counterpart: the CUDA kernel picks its own layout
    from d."""
    dev = F.device
    w32 = torch.as_tensor(w, dtype=torch.float32, device=dev)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=dev).reshape(())
    if dev.type == "cuda":
        return kernel.eps_affine(F, w32, b32)
    if dev.type == "cpu":
        return eps_affine_ref(F, w32, b32)
    raise ValueError(f"no eps_affine for device {dev}")
