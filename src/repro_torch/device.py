"""The port's device rule: an entry point's `device=None` means the GPU;
and the full-fp32 switch every engine sets."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU. Without one, only an explicit `device="cpu"`
    runs (the plain versions); nothing falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


def full_fp32():
    """Every fp32 product outside the kernels in full fp32, never TF32:
    under TF32 stored eps would be off by about 1e-3 relative and the
    Lemma 3.1 partition would stop being exact."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
