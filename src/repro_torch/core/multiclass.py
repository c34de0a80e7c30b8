"""Stacked one-vs-all SGD (paper App. B.5.4 / C.3), counterpart of
`repro.core.multiclass.sgd_all_views`. Host numpy: the facade trains on
the host exactly as the reference does. `MulticlassView` is not ported
yet."""
from __future__ import annotations

import numpy as np


def sgd_all_views(W: np.ndarray, b: np.ndarray, f: np.ndarray, cls: int, *,
                  lr: float, l2: float):
    """One training example against all k one-vs-all hinge models at once
    (f32 margins and weights, bias kept in f64), bit-for-bit the
    reference's arithmetic."""
    k = W.shape[0]
    y = np.where(np.arange(k) == cls, 1.0, -1.0)
    z = W @ f - b.astype(np.float32)          # (k,) f32 margins
    g = np.where(y * z.astype(np.float64) < 1.0, -y, 0.0)
    W = W * (1.0 - lr * l2)
    W -= (lr * g).astype(np.float32)[:, None] * f[None, :]
    return W, b - lr * (-g)
