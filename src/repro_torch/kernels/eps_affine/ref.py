"""Plain PyTorch version of eps_affine, the counterpart of
`repro/kernels/eps_affine/ref.py`. The CPU path of `ops` and the CUDA
kernel's checks use it."""
from __future__ import annotations

import torch

from repro_torch.core.engine import classify


def eps_affine_ref(F, w, b):
    """(eps (n,) f32, labels (n,) int8, positive count () int32) for
    eps = F·w − b, accumulated in fp32."""
    eps = F.to(torch.float32) @ w.to(torch.float32) - b
    return eps, classify(eps), (eps >= 0).sum(dtype=torch.int32)
