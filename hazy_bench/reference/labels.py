"""Every view's label of every row from its float64 margin, computed in
blocks of rows on the device, and the tie rule: a label that differs from
sign(z) is a tie, and no fault, only where the float64 margin satisfies
|z| <= TIE_RTOL (||f||_2 ||w||_2 + |b|), within the float32 rounding of
the program's dot. `tf32` gives the control's margins: inputs rounded to
TF32's 10 mantissa bits, products summed in float32."""
from __future__ import annotations

import numpy as np
import torch

TIE_RTOL = 1e-6
BLOCK = 1 << 17


def tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tf32_np(x: np.ndarray) -> np.ndarray:
    i = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((i + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


class Table:
    """The benchmark's own copy of the table on the device, its rows'
    l2 norms in float64, and the margins of any models over it."""

    def __init__(self, F: np.ndarray, device):
        self.F = torch.tensor(F, device=device)
        self.n = self.F.shape[0]
        self.fnorm = torch.cat([
            torch.linalg.vector_norm(self.F[s:s + BLOCK].double(), dim=1)
            for s in range(0, self.n, BLOCK)])

    def margins(self, W, b) -> torch.Tensor:
        """(k, n) float64 margins F·Wᵀ − b."""
        W64 = torch.tensor(np.asarray(W, np.float64), device=self.F.device)
        b64 = torch.tensor(np.asarray(b, np.float64), device=self.F.device)
        return torch.cat([self.F[s:s + BLOCK].double() @ W64.T
                          for s in range(0, self.n, BLOCK)]).T - b64[:, None]

    def margins_tf32(self, W, b) -> torch.Tensor:
        """(k, n) float32 margins of the control."""
        W32 = tf32(torch.tensor(np.asarray(W, np.float32),
                                device=self.F.device))
        b32 = torch.tensor(np.asarray(b, np.float32), device=self.F.device)
        return torch.cat([tf32(self.F[s:s + BLOCK]) @ W32.T
                          for s in range(0, self.n, BLOCK)]).T - b32[:, None]

    def tolerance(self, W, b) -> torch.Tensor:
        """(k, n) float64 tie tolerance."""
        W64 = np.asarray(W, np.float64)
        wn = torch.tensor(np.linalg.norm(W64, axis=1), device=self.F.device)
        bb = torch.tensor(np.abs(np.asarray(b, np.float64)),
                          device=self.F.device)
        return TIE_RTOL * (wn[:, None] * self.fnorm[None, :] + bb[:, None])


def sign(z) -> torch.Tensor:
    return torch.where(z >= 0, 1, -1).to(torch.int8)


def point_margins(F: np.ndarray, ids, W, b):
    """(m, k) float64 margins of rows `ids` and their tie tolerance."""
    f = F[np.asarray(ids)].astype(np.float64)
    W64 = np.asarray(W, np.float64)
    b64 = np.asarray(b, np.float64)
    z = f @ W64.T - b64
    tol = TIE_RTOL * (np.linalg.norm(f, axis=1)[:, None]
                      * np.linalg.norm(W64, axis=1)[None, :] + np.abs(b64))
    return z, tol
