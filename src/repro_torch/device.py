"""The port's device rule: an entry point's `device=None` means the GPU."""
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
