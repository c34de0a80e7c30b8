"""The host training the program runs, copied: per-example hinge SGD on k
stacked one-vs-all models, f32 weights and margins, bias in f64 (the
arithmetic of `repro.core.multiclass.sgd_all_views`, which the port keeps
bit for bit)."""
from __future__ import annotations

import numpy as np
import torch


def sgd_all_views(W, b, f, cls, *, lr, l2):
    k = W.shape[0]
    y = np.where(np.arange(k) == cls, 1.0, -1.0)
    z = W @ f - b.astype(np.float32)
    g = np.where(y * z.astype(np.float64) < 1.0, -y, 0.0)
    W = W * (1.0 - lr * l2)
    W -= (lr * g).astype(np.float32)[:, None] * f[None, :]
    return W, b - lr * (-g)


def to_bfloat16(W: np.ndarray) -> np.ndarray:
    return torch.from_numpy(W).to(torch.bfloat16).float().numpy()


def replay(F, commits, k, *, lr, l2, visit, lower=False):
    """Train from zero models through `commits` [(ids, classes), ...],
    calling visit(c, W, b) with the models after c commits (c = 0 first).
    `lower`: the control's precision, W in bfloat16 and b in float32
    after every step. Returns the last (W, b)."""
    W = np.zeros((k, F.shape[1]), np.float32)
    b = np.zeros(k, np.float64)
    visit(0, W, b)
    for c, (ids, classes) in enumerate(commits, 1):
        for i, y in zip(ids, classes):
            W, b = sgd_all_views(W, b, F[i], y, lr=lr, l2=l2)
            if lower:
                W = to_bfloat16(W)
                b = b.astype(np.float32).astype(np.float64)
        visit(c, W, b)
    return W, b
