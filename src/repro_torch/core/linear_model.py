"""Linear classification models and incremental SGD (paper §2.1/§3.1,
Appendix A.1/B.5.1), counterpart of `repro.core.linear_model`.

A model is (w, b); a view labels an entity f as sign(w·f − b). The numpy
path is a copy of the reference's, operation for operation and dtype for
dtype, so the same example stream gives bit-identical models. The tensor
path `torch_sgd_step` is the twin of the reference's `jax_sgd_step`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class LinearModel:
    w: np.ndarray          # (d,)
    b: float

    def copy(self) -> "LinearModel":
        return LinearModel(self.w.copy(), float(self.b))

    def eps(self, F: np.ndarray) -> np.ndarray:
        return F @ self.w - self.b

    def predict(self, F: np.ndarray) -> np.ndarray:
        e = self.eps(F)
        return np.where(e >= 0, 1.0, -1.0)


def zero_model(d: int) -> LinearModel:
    return LinearModel(np.zeros(d, np.float32), 0.0)


# ---------------------------------------------------------------------------
# Loss gradients (subgradients), vectorized.
# ---------------------------------------------------------------------------

def _loss_grad(method: str, z: np.ndarray, y: np.ndarray) -> np.ndarray:
    """dL/dz for z = w·f − b, label y ∈ {−1, 1}."""
    if method == "svm":           # hinge: max(0, 1 − yz)
        return np.where(y * z < 1.0, -y, 0.0)
    if method == "logistic":      # log(1 + exp(−yz))
        return -y / (1.0 + np.exp(np.clip(y * z, -30, 30)))
    if method == "ridge":         # (z − y)^2
        return 2.0 * (z - y)
    raise ValueError(method)


def sgd_step(model: LinearModel, f: np.ndarray, y: float, *, lr: float,
             l2: float = 1e-4, method: str = "svm") -> LinearModel:
    """One incremental training example."""
    z = float(f @ model.w - model.b)
    g = float(_loss_grad(method, np.asarray(z), np.asarray(y)))
    w = model.w * (1.0 - lr * l2)
    if g != 0.0:
        w = w - lr * g * f
    b = model.b - lr * (-g)  # d z / d b = −1
    return LinearModel(w.astype(np.float32), float(b))


def train_batch(model: LinearModel, F: np.ndarray, Y: np.ndarray, *, lr: float,
                l2: float = 1e-4, method: str = "svm", epochs: int = 1,
                seed: int = 0) -> LinearModel:
    """Multi-epoch SGD over a labeled set (bulk load)."""
    r = np.random.default_rng(seed)
    w, b = model.w.copy(), model.b
    n = F.shape[0]
    for _ in range(epochs):
        order = r.permutation(n)
        for i in order:
            z = F[i] @ w - b
            g = float(_loss_grad(method, np.asarray(z), np.asarray(Y[i])))
            w *= (1.0 - lr * l2)
            if g != 0.0:
                w -= lr * g * F[i]
            b -= lr * (-g)
    return LinearModel(w.astype(np.float32), float(b))


def full_gradient_train(model: LinearModel, F: np.ndarray, Y: np.ndarray, *,
                        lr: float, l2: float = 1e-4, method: str = "svm",
                        iters: int = 200) -> LinearModel:
    """Full-batch (sub)gradient descent, the non-incremental baseline."""
    w, b = model.w.copy(), model.b
    n = F.shape[0]
    for _ in range(iters):
        z = F @ w - b
        g = _loss_grad(method, z, Y)
        gw = F.T @ g / n + l2 * w
        gb = -np.mean(g)
        w -= lr * gw
        b -= lr * gb
    return LinearModel(w.astype(np.float32), float(b))


def precision_recall(model: LinearModel, F: np.ndarray, Y: np.ndarray) -> Tuple[float, float]:
    pred = model.predict(F)
    tp = float(np.sum((pred == 1) & (Y == 1)))
    fp = float(np.sum((pred == 1) & (Y == -1)))
    fn = float(np.sum((pred == -1) & (Y == 1)))
    prec = tp / max(1.0, tp + fp)
    rec = tp / max(1.0, tp + fn)
    return prec, rec


# ---------------------------------------------------------------------------
# tensor twin of the reference's `jax_sgd_step`
# ---------------------------------------------------------------------------

def torch_sgd_step(w: torch.Tensor, b: torch.Tensor, f: torch.Tensor, y,
                   lr: float, l2: float = 1e-4, method: str = "svm"):
    """One SGD step on tensors, with no host sync: returns (w, b)."""
    z = torch.dot(f, w) - b
    y = torch.as_tensor(y, dtype=z.dtype, device=z.device)
    if method == "svm":
        g = torch.where(y * z < 1.0, -y, torch.zeros_like(z))
    elif method == "logistic":
        g = -y / (1.0 + torch.exp(torch.clamp(y * z, -30, 30)))
    else:
        g = 2.0 * (z - y)
    w = w * (1.0 - lr * l2) - lr * g * f
    b = b + lr * g  # dL/db = −g; descent: b − lr·(−g)
    return w, b
