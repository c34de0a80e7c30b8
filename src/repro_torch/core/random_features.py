"""Rahimi–Recht random features (paper App. B.5.3: linearized kernels).

For a shift-invariant kernel (Gaussian here), z(x) = sqrt(2/D) cos(Wx + u)
with W ~ N(0, 1/σ²) rows and u ~ U[0, 2π) satisfies z(x)ᵀz(y) ≈ K(x, y),
turning the kernel classifier back into a *linear* one — so the entire HAZY
machinery (waters, clustering, SKIING) applies unchanged. Also used by the
Fig. 12 feature-sensitivity benchmark to scale feature dimension.

Counterpart of `repro.core.random_features`: host numpy, the same draws
from `default_rng(seed)` in the same order, so W, u and the features are
bit for bit the reference's."""
from __future__ import annotations

import numpy as np


class RandomFeatures:
    def __init__(self, d_in: int, d_out: int, *, sigma: float = 1.0, seed: int = 0):
        r = np.random.default_rng(seed)
        self.W = (r.normal(size=(d_in, d_out)) / sigma).astype(np.float32)
        self.u = (r.uniform(0, 2 * np.pi, size=d_out)).astype(np.float32)
        self.scale = np.sqrt(2.0 / d_out).astype(np.float32)

    def __call__(self, X: np.ndarray) -> np.ndarray:
        return self.scale * np.cos(X @ self.W + self.u)


def gaussian_kernel(X: np.ndarray, Y: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    d2 = (np.sum(X * X, 1)[:, None] + np.sum(Y * Y, 1)[None, :] - 2 * X @ Y.T)
    return np.exp(-d2 / (2 * sigma * sigma))
