"""Learning-rate schedules as functions of the step counter, the
counterpart of `repro/optim/schedules.py`: computed in f32 (a 0-d tensor
on the step's device), in the reference's order of operations."""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1):
    """Linear warm-up to `peak_lr` over `warmup_steps` (step + 1 of them
    at `step`), then a cosine decay to `final_frac · peak_lr` at
    `total_steps`."""
    step = _step_f32(step)
    warm = peak_lr * (step + 1) / max(1, warmup_steps)
    prog = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps),
                       0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_):
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.full((), peak_lr, dtype=torch.float32, device=device)
